"""KubeSchedulerConfiguration handling: defaults, wrapping, plugin-set merge.

Python rebuild of the reference's config-transformation layer:

- ``default_scheduler_config`` — the v1.26 default single-profile config
  (reference simulator/scheduler/config/config.go:9-15 via upstream scheme
  defaulting; plugin order pinned by reference
  simulator/scheduler/config/plugin_test.go:150-167).
- ``merge_plugin_set`` — upstream default_plugins.go merge logic the
  reference clones (reference simulator/scheduler/plugin/plugins.go:229-284).
- ``convert_for_simulator`` — rewrites every PluginSet to wrapped names and
  disables the default MultiPoint with "*"
  (reference simulator/scheduler/plugin/plugins.go:173-225).
- ``get_score_plugin_weight`` — zero weight → 1
  (reference plugins.go:288-303).
- ``effective_plugins`` — expands MultiPoint + per-point overrides into
  ordered per-extension-point plugin name lists (upstream framework
  runtime expansion).

Configs are plain dicts in the kubescheduler.config.k8s.io/v1 wire shape.
"""

from __future__ import annotations

import copy
from typing import Any

from kube_scheduler_simulator_tpu_torch.models.wrapped import PLUGIN_SUFFIX, plugin_name
from kube_scheduler_simulator_tpu_torch.plugins.intree import (
    DEFAULT_PLUGIN_ORDER,
    DEFAULT_SCORE_WEIGHTS,
)

Obj = dict[str, Any]

EXTENSION_POINT_KEYS = (
    "queueSort",
    "preFilter",
    "filter",
    "postFilter",
    "preScore",
    "score",
    "reserve",
    "permit",
    "preBind",
    "bind",
    "postBind",
)

# Which framework method marks membership of each config extension point.
POINT_METHODS = {
    "queueSort": "less",
    "preFilter": "pre_filter",
    "filter": "filter",
    "postFilter": "post_filter",
    "preScore": "pre_score",
    "score": "score",
    "reserve": "reserve",
    "permit": "permit",
    "preBind": "pre_bind",
    "bind": "bind",
    "postBind": "post_bind",
}


def default_multipoint_enabled() -> list[Obj]:
    out: list[Obj] = []
    for name in DEFAULT_PLUGIN_ORDER:
        entry: Obj = {"name": name}
        if name in DEFAULT_SCORE_WEIGHTS:
            entry["weight"] = DEFAULT_SCORE_WEIGHTS[name]
        out.append(entry)
    return out


def default_scheduler_config() -> Obj:
    """The defaulted KubeSchedulerConfiguration (single default profile)."""
    return {
        "apiVersion": "kubescheduler.config.k8s.io/v1",
        "kind": "KubeSchedulerConfiguration",
        "parallelism": 16,
        "percentageOfNodesToScore": 0,
        "profiles": [
            {
                "schedulerName": "default-scheduler",
                "plugins": {"multiPoint": {"enabled": default_multipoint_enabled()}},
                "pluginConfig": default_plugin_config(),
            }
        ],
        "extenders": [],
    }


def default_plugin_config() -> list[Obj]:
    """Default per-plugin args (the subset our plugins consume)."""
    return [
        {
            "name": "DefaultPreemption",
            "args": {"minCandidateNodesPercentage": 10, "minCandidateNodesAbsolute": 100},
        },
        {
            "name": "InterPodAffinity",
            "args": {"hardPodAffinityWeight": 1},
        },
        {
            "name": "NodeAffinity",
            "args": {},
        },
        {
            "name": "NodeResourcesBalancedAllocation",
            "args": {"resources": [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1}]},
        },
        {
            "name": "NodeResourcesFit",
            "args": {
                "scoringStrategy": {
                    "type": "LeastAllocated",
                    "resources": [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1}],
                }
            },
        },
        {
            "name": "PodTopologySpread",
            "args": {"defaultingType": "System"},
        },
        {
            "name": "VolumeBinding",
            "args": {"bindTimeoutSeconds": 600},
        },
    ]


# --------------------------------------------------------------------- merge


def merge_plugin_set(default_set: Obj, custom_set: Obj) -> Obj:
    """Clone of the upstream mergePluginSet logic (reference
    plugins.go:229-284): custom Disabled (incl. "*") suppresses defaults;
    custom Enabled replaces same-name defaults in place, the rest append."""
    disabled: list[Obj] = []
    disabled_names: set[str] = set()
    for p in custom_set.get("disabled") or []:
        disabled.append({"name": p["name"]})
        disabled_names.add(p["name"])
    for p in default_set.get("disabled") or []:
        disabled.append({"name": p["name"]})
        disabled_names.add(p["name"])

    enabled_custom = {p["name"]: (i, p) for i, p in enumerate(custom_set.get("enabled") or [])}
    replaced: set[int] = set()
    enabled: list[Obj] = []
    if "*" not in disabled_names:
        for p in default_set.get("enabled") or []:
            if p["name"] in disabled_names:
                continue
            if p["name"] in enabled_custom:
                idx, custom = enabled_custom[p["name"]]
                replaced.add(idx)
                p = custom
            enabled.append(copy.deepcopy(p))
    for i, p in enumerate(custom_set.get("enabled") or []):
        if i not in replaced:
            enabled.append(copy.deepcopy(p))
    return {"enabled": enabled, "disabled": disabled}


def convert_for_simulator(plugins: Obj) -> Obj:
    """ConvertForSimulator analog (reference plugins.go:173-205): every
    PluginSet rewritten to wrapped names; the MultiPoint set is merged with
    the in-tree defaults, then the whole default MultiPoint is disabled
    with "*" so only the wrapped plugins run."""
    out: Obj = {}
    for key in EXTENSION_POINT_KEYS:
        out[key] = _apply_plugin_set(plugins.get(key) or {}, {})
    merged = _apply_plugin_set(
        plugins.get("multiPoint") or {}, {"enabled": default_multipoint_enabled()}
    )
    merged["disabled"] = [{"name": "*"}]
    out["multiPoint"] = merged
    return out


def _apply_plugin_set(pls_set: Obj, in_tree: Obj) -> Obj:
    merged = merge_plugin_set(in_tree, pls_set)
    enabled = []
    for p in merged["enabled"]:
        q = {"name": plugin_name(p["name"])}
        if "weight" in p:
            q["weight"] = p["weight"]
        enabled.append(q)
    disabled = []
    for p in merged["disabled"]:
        name = p["name"] if p["name"] == "*" else plugin_name(p["name"])
        disabled.append({"name": name})
    return {"enabled": enabled, "disabled": disabled}


def get_score_plugin_weight(cfg: Obj) -> dict[str, int]:
    """Weights of enabled score plugins; zero weight → 1 (reference
    plugins.go:288-303).  Keys are unwrapped plugin names."""
    weights: dict[str, int] = {}
    profile = (cfg.get("profiles") or [{}])[0]
    plugins = profile.get("plugins") or {}
    enabled = list((plugins.get("score") or {}).get("enabled") or [])
    enabled += list((plugins.get("multiPoint") or {}).get("enabled") or [])
    for p in enabled:
        name = p["name"]
        if name.endswith(PLUGIN_SUFFIX):
            name = name[: -len(PLUGIN_SUFFIX)]
        weights[name] = int(p.get("weight") or 0) or 1
    return weights


# ----------------------------------------------------------------- expansion


def effective_plugins(profile: Obj, capabilities: dict[str, set[str]]) -> dict[str, list[Obj]]:
    """Expand a profile's plugin config into ordered per-point lists.

    ``capabilities``: plugin name → set of config point keys it implements.
    MultiPoint plugins join every point they implement (upstream MultiPoint
    expansion); point-specific Enabled/Disabled then override.
    """
    plugins = profile.get("plugins") or {}
    # merge_plugin_set already applies Disabled (incl. "*") to the DEFAULT
    # set only — custom Enabled entries always survive, per upstream
    # mergePluginSet semantics (reference plugins.go:229-284).
    multi = merge_plugin_set({"enabled": default_multipoint_enabled()}, plugins.get("multiPoint") or {})
    out: dict[str, list[Obj]] = {}
    for point in EXTENSION_POINT_KEYS:
        base = [p for p in multi["enabled"] if point in capabilities.get(p["name"], set())]
        point_set = plugins.get(point) or {}
        out[point] = merge_plugin_set({"enabled": base}, point_set)["enabled"]
    return out


def plugin_args_by_name(profile: Obj) -> dict[str, Obj]:
    """pluginConfig merged over the defaults (reference NewPluginConfig,
    plugins.go:95-170 — user args override default args per plugin)."""
    args = {pc["name"]: copy.deepcopy(pc.get("args") or {}) for pc in default_plugin_config()}
    for pc in profile.get("pluginConfig") or []:
        name = pc["name"]
        if name.endswith(PLUGIN_SUFFIX):
            name = name[: -len(PLUGIN_SUFFIX)]
        user = copy.deepcopy(pc.get("args") or {})
        if name in args:
            merged = args[name]
            merged.update(user)
            args[name] = merged
        else:
            args[name] = user
    return args
