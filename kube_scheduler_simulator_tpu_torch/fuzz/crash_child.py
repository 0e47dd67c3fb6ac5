"""The ProcessChaos child: one journaled scenario run per process.

``fuzz.chaos.ProcessChaos`` drives three invocations of this module as
subprocesses (``python -m kube_scheduler_simulator_tpu_torch.fuzz.crash_child``):

- ``--mode run``: the uninterrupted baseline — build a fresh store +
  scheduler (the fuzz harness's deterministic configuration: SimClocks,
  ``tie_break="first"``, explicit default weights), attach a journal,
  replay the scenario tick by tick with a ``mark`` record after every
  tick, settle, and print the final parity state + the total record
  count (the crash run's kill index is seeded against it).
- ``--mode crash``: the same run with ``kill_at=N`` — the journal
  SIGKILLs the process the instant record #N is durable.  The parent
  observes the signal death; nothing is printed.
- ``--mode recover``: a FRESH process over the same journal directory —
  ``RecoveryManager`` rebuilds the store (checkpoint + replay +
  torn-tail truncation), the scheduler restarts through the recovered
  configuration, process state (rotation counters, unschedulableQ,
  clocks, weights, event sequence) restores from the last mark, a new
  journal epoch opens, and the scenario RESUMES at the tick after the
  last completed mark (re-running any partially-applied tick — scenario
  ops are idempotent by the fuzz runner's forgiveness rules).  Prints
  the final parity state + the recovery stats.
- ``--mode follow`` (``fuzz.chaos.FailoverChaos``): a hot-standby
  follower running CONCURRENTLY with the primary — a
  ``replication.apply.ReplicaApplier`` tails the live journal,
  tracking the max post-drain lag, until the parent creates the plan's
  ``promote_file`` (its signal that the primary finished or was
  SIGKILLed); then the follower PROMOTES
  (``replication.promote.promote_replica``), resumes the scenario from
  the shipped resume point exactly as ``recover`` would, and prints
  the final parity state + promotion stats + ``max_lag``.

The crash-parity pin: ``run`` state == ``recover`` state == promoted
``follow`` state, byte for byte, with ``truncated_records == 0`` (a
SIGKILL at a record boundary never tears) and ``partial_gangs == 0``
(wave/gang records are atomic).

``--device`` places the child's service (default: the card).  On the card
the child loads the kernel libraries its parent built and builds nothing
(``kernels.build(compile=False)``, from the build directory the child's
``KSS_COMPILE_CACHE_DIR`` names, or from the kernel-library cache under
``KSS_AOT_CACHE_DIR``, raises where one is missing); every
report carries ``compiles``, the child's ``compile_count`` delta over its
scenario, which is 0 when nothing was rebuilt or reloaded, and
``degrades``, the kernel errors it degraded (``kernels.DEGRADES``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

Obj = dict[str, Any]

DEFAULT_ROLE: Obj = {
    # sequential-path children build no engine; the crash smoke opts into
    # the batch path to exercise wave atomicity
    "use_batch": "off",
    "batch_min_work": 0,
    "commit_wave": 256,
    "autoscale": "on",
    "fsync": False,
    "checkpoint_every": 0,
}


def _profile_cfg(plan: Obj) -> "Obj | None":
    if (plan["scenario"].get("profile") or "default") == "gang":
        from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config

        return gang_scheduler_config()
    return None


def _build_service(plan: Obj, store: Any):
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

    role = {**DEFAULT_ROLE, **(plan.get("role") or {})}
    svc = SchedulerService(
        store,
        tie_break="first",
        clock=SimClock(0.0),
        use_batch=role["use_batch"],
        batch_min_work=role["batch_min_work"],
        commit_wave=role["commit_wave"],
        autoscale=role["autoscale"],
        weights={},
        device=plan["device"],
    )
    return svc, _profile_cfg(plan), role


def _drive(scenario: Obj, store: Any, svc: Any, start_tick: int = 0) -> None:
    """The fuzz runner's tick projection, with a recovery mark after
    every completed tick (state/recovery.write_mark)."""
    from kube_scheduler_simulator_tpu_torch.fuzz.runner import _settle, apply_op
    from kube_scheduler_simulator_tpu_torch.state.recovery import write_mark

    clk = svc._clock
    step = float(scenario.get("stepSeconds") or 1.0)
    autoscaled = "autoscale" in scenario["features"]
    ticks = scenario["ticks"]
    for t in range(start_tick, len(ticks)):
        for op in ticks[t]:
            apply_op(store, svc, op)
        if autoscaled:
            svc.schedule_pending_autoscaled(max_rounds=2, max_passes=4)
        else:
            svc.schedule_pending(max_rounds=2)
        clk.advance(step)
        write_mark(svc, t)
    _settle(store, svc, autoscaled)
    write_mark(svc, len(ticks), label="end")


def _emit(plan: Obj, out_path: str, doc: Obj) -> None:
    """Write the child's report, with its builds and loads since main()
    loaded the libraries, its kernels' launches and the kernel errors it
    degraded."""
    from kube_scheduler_simulator_tpu_torch.analysis.runtime import compile_count
    from kube_scheduler_simulator_tpu_torch.ops import kernels

    doc = dict(doc, compiles=compile_count() - plan["compiles_at_start"],
               launches={k: n for k, n in kernels.LAUNCHES.items() if n}, degrades=dict(kernels.DEGRADES))
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True)


def _attach(plan: Obj, role: Obj, store: Any, svc: Any, kill_at: "int | None") -> Any:
    from kube_scheduler_simulator_tpu_torch.services.snapshot import SnapshotService
    from kube_scheduler_simulator_tpu_torch.state.journal import Journal
    from kube_scheduler_simulator_tpu_torch.state.recovery import (
        build_checkpoint,
        scheduler_meta_provider,
    )

    journal = Journal(
        plan["journal_dir"],
        fsync=bool(role["fsync"]),
        checkpoint_every=int(role["checkpoint_every"]),
        kill_at=kill_at,
    )
    store.attach_journal(journal)
    journal.add_meta_provider(scheduler_meta_provider(svc))
    snap = SnapshotService(store, svc)
    journal.checkpoint_provider = lambda: build_checkpoint(store, snap)
    return journal


def mode_run(plan: Obj, out_path: str, kill_at: "int | None") -> None:
    from kube_scheduler_simulator_tpu_torch.fuzz.runner import encode_state
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state
    from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

    store = ClusterStore(clock=SimClock(1_700_000_000.0))
    svc, cfg, role = _build_service(plan, store)
    journal = _attach(plan, role, store, svc, kill_at)
    # everything from here on is journaled: the bootstrap namespace, the
    # scheduler-config record, every scenario mutation and commit wave
    store.create("namespaces", {"metadata": {"name": "default"}})
    svc.start_scheduler(cfg)
    _drive(plan["scenario"], store, svc)
    _emit(
        plan,
        out_path,
        {
            "state": encode_state(pod_parity_state(store)),
            "records": journal.stats["records"],
            "journal": dict(journal.stats),
        },
    )


def mode_recover(plan: Obj, out_path: str) -> None:
    from kube_scheduler_simulator_tpu_torch.fuzz.runner import encode_state
    from kube_scheduler_simulator_tpu_torch.state.recovery import (
        RecoveryManager,
        restore_scheduler_state,
    )
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state
    from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

    store = ClusterStore(clock=SimClock(1_700_000_000.0))
    mgr = RecoveryManager(plan["journal_dir"])
    report = mgr.recover(store)
    mgr.scan_partial_gangs(store, report)
    svc, cfg, role = _build_service(plan, store)
    svc.start_scheduler(report.scheduler_config or cfg)
    restore_scheduler_state(svc, report)
    journal = _attach(plan, role, store, svc, kill_at=None)
    # the new epoch inherits the recovered resume point: a compaction
    # firing before the resumed run's first mark must embed it
    journal.last_mark = report.last_mark

    resumed_from = _resume(plan, store, svc, report)
    _emit(
        plan,
        out_path,
        {
            "state": encode_state(pod_parity_state(store)),
            "recovery": report.stats(),
            "resumed_from": resumed_from,
        },
    )


def _resume(plan: Obj, store: Any, svc: Any, report: Any) -> int:
    """Continue the scenario from the recovered/shipped resume point —
    shared by the recovery leg and the promoted-follower leg (both must
    rejoin the SAME timeline to hit byte parity with the baseline)."""
    from kube_scheduler_simulator_tpu_torch.fuzz.runner import _settle
    from kube_scheduler_simulator_tpu_torch.state.recovery import write_mark

    mark = report.last_mark or {}
    scenario = plan["scenario"]
    if mark.get("label") == "end":
        # crash landed after the run finished: nothing to resume
        resumed_from = len(scenario["ticks"]) + 1
        write_mark(svc, resumed_from, label="end")
        return resumed_from
    resumed_from = int(mark.get("tick", -1)) + 1 if mark else 0
    if resumed_from >= len(scenario["ticks"]):
        # crash mid-settle: every tick completed; re-run the settle
        _settle(store, svc, "autoscale" in scenario["features"])
        write_mark(svc, len(scenario["ticks"]), label="end")
    else:
        _drive(scenario, store, svc, start_tick=resumed_from)
    return resumed_from


def mode_follow(plan: Obj, out_path: str) -> int:
    """Hot-standby leg: tail the primary's LIVE journal until the parent
    signals (promote_file), then fail over and finish the scenario."""
    import time

    from kube_scheduler_simulator_tpu_torch.fuzz.runner import encode_state
    from kube_scheduler_simulator_tpu_torch.replication.apply import ReplicaApplier
    from kube_scheduler_simulator_tpu_torch.replication.promote import promote_replica
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state
    from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

    store = ClusterStore(clock=SimClock(1_700_000_000.0))
    # notify=False: the follower has no subscribers during the drill —
    # the HTTP replica mode is what rides notify=True
    applier = ReplicaApplier(store, plan["journal_dir"], notify=False)
    applier.bootstrap()
    promote_file = plan["promote_file"]
    poll_s = float(plan.get("poll_s") or 0.01)
    deadline = time.monotonic() + float(plan.get("follow_deadline_s") or 240.0)
    max_lag = 0
    while not os.path.exists(promote_file):
        applier.step()
        max_lag = max(max_lag, int(applier.stats["lag_records"]))
        if time.monotonic() > deadline:
            print("follow child: promote_file never appeared", file=sys.stderr)
            return 4
        time.sleep(poll_s)
    role = {**DEFAULT_ROLE, **(plan.get("role") or {})}
    promotion = promote_replica(
        applier,
        lambda s: _build_service(plan, s)[0],
        config_fallback=_profile_cfg(plan),
    )
    svc = promotion.service
    report = promotion.recovery
    journal = _attach(plan, role, store, svc, kill_at=None)
    journal.last_mark = report.last_mark
    resumed_from = _resume(plan, store, svc, report)
    _emit(
        plan,
        out_path,
        {
            "state": encode_state(pod_parity_state(store)),
            "recovery": report.stats(),
            "promotion": promotion.stats(),
            "max_lag": max_lag,
            "records_shipped": applier.stats["records_shipped"],
            "resumed_from": resumed_from,
        },
    )
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("run", "crash", "recover", "follow"), required=True)
    ap.add_argument("--journal-dir", required=True)
    ap.add_argument("--plan", required=True, help="JSON plan: scenario + role (+ kill_at)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="the service's device (default: the card)")
    args = ap.parse_args()
    with open(args.plan, encoding="utf-8") as f:
        plan = json.load(f)
    plan["journal_dir"] = args.journal_dir
    from kube_scheduler_simulator_tpu_torch.analysis.runtime import compile_count
    from kube_scheduler_simulator_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    plan["device"] = str(dev)
    if dev.type == "cuda":
        from kube_scheduler_simulator_tpu_torch.ops import kernels

        # the parent built the libraries: load them, never build
        kernels.build(compile=False)
    plan["compiles_at_start"] = compile_count()
    if args.mode == "run":
        mode_run(plan, args.out, kill_at=None)
    elif args.mode == "crash":
        kill_at = int(plan.get("kill_at") or 1)
        mode_run(plan, args.out, kill_at=kill_at)
        # reaching here means the kill point never fired (index past the
        # end of the run) — the parent treats this exit code as a miss
        return 3
    elif args.mode == "follow":
        return mode_follow(plan, args.out)
    else:
        mode_recover(plan, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
