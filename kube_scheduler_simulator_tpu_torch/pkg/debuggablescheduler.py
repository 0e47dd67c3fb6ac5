"""Embed the debuggable scheduler in your own scheduler program.

Rebuild of the reference's library surface (reference
simulator/pkg/debuggablescheduler/command.go:11-46 and
debuggable_scheduler.go:43-118): turn ANY scheduler setup into a
"debuggable" one whose every plugin is wrapped to record per-plugin
results as pod annotations, with user-supplied out-of-tree plugins and
per-plugin Before/After extenders.

Example (mirrors reference docs/sample/debuggable-scheduler/main.go):

    from kube_scheduler_simulator_tpu_torch.pkg import debuggablescheduler

    scheduler, store = debuggablescheduler.new_scheduler(
        cluster_store,
        plugins={"NodeNumber": node_number_factory},          # WithPlugin
        plugin_extenders={"NodeResourcesFit": my_extender},   # WithPluginExtenders
        config=my_kube_scheduler_configuration,
    )
    scheduler.start_background()          # the upstream `command.Execute()`

The reference achieves config injection by overriding the scheme's
defaulting func ("black magic", debuggable_scheduler.go:108-116); here
construction is explicit, so no magic is needed — the converted profiles
are applied directly.
"""

from __future__ import annotations

from typing import Any, Callable

from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService

Obj = dict[str, Any]
PluginFactory = Callable[["Obj | None", Any], Any]
PluginExtenderInitializer = Callable[[Any], Any]


def new_scheduler(
    cluster_store: Any,
    plugins: "dict[str, PluginFactory] | None" = None,
    plugin_extenders: "dict[str, PluginExtenderInitializer] | None" = None,
    config: "Obj | None" = None,
    use_batch: str = "off",
    commit_wave: int = 256,
    pipeline: "bool | str" = "auto",
    device: Any = None,
) -> "tuple[SchedulerService, Any]":
    """NewSchedulerCommand analog: returns (scheduler service, result store).

    ``plugins``: out-of-tree plugin name → factory(args, handle) — the
    WithPlugin option (command.go:35-39).
    ``plugin_extenders``: plugin name → initializer(result_store) returning
    an object with before_/after_ hook methods — the WithPluginExtenders
    option (command.go:41-46).
    ``commit_wave`` / ``pipeline``: the batch path's bulk-commit wave size
    and double-buffered round setting (SchedulerService docstring) — embed
    hosts running big batch rounds tune these alongside ``use_batch``.
    ``device``: the batch engines' device (the card unless the caller
    passes "cpu"; a missing card raises).
    """
    svc = SchedulerService(
        cluster_store, use_batch=use_batch, commit_wave=commit_wave, pipeline=pipeline, device=device
    )
    if plugins:
        svc.set_out_of_tree_registries(dict(plugins))
        # out-of-tree plugins default to enabled at every point they
        # implement when the user names them in the config; a config that
        # doesn't mention them still registers them for profiles to enable.
    if plugin_extenders:
        svc.set_plugin_extenders(dict(plugin_extenders))
    svc.start_scheduler(config)
    return svc, svc.result_store
