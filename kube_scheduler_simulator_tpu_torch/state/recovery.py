"""Crash recovery: rebuild the control plane from checkpoint + journal.

The read side of :mod:`state.journal`.  On boot (or in the chaos
harness's recovery child), a :class:`RecoveryManager` restores a fresh
``ClusterStore`` to the exact durable state the dead process reached:

1. **Checkpoint.**  The newest VALID checkpoint is loaded — objects are
   written into the store buckets verbatim (uids, resourceVersions and
   creationTimestamps preserved; nothing is re-stamped, unlike a
   snapshot ``load()``), and every kind's event-log eviction watermark
   is set to the checkpoint's resourceVersion so a watcher resuming
   from a pre-checkpoint version gets the 410-relist path instead of
   silently missing events.  A damaged checkpoint is counted and the
   next-older one tried (never raised).
2. **Replay.**  Segments with index >= the checkpoint's are replayed in
   order; each record's events apply atomically (a record is the unit
   of both atomicity and tearing).  The first bad CRC truncates the
   torn tail in place — counted in ``truncated_records``, never raised
   — and replay stops there: everything after a tear is unordered
   garbage by definition.
3. **Process state.**  The last record's ``meta`` (written under the
   store lock at the moment the record became durable) restores the
   store counters; the last ``mark`` record's resume state (scenario
   tick, clocks, queue unschedulable set, scheduler counters, weight
   override) is surfaced in the report for the caller to resume from.
   The scheduler itself is rebuilt through the EXISTING
   ``restart_scheduler`` path with the recovered configuration — the
   last journaled ``config`` record, else the checkpoint's.

The report also carries the all-or-nothing invariant scan: at the
recovery point, no PodGroup may be partially bound (some members with
``spec.nodeName``, some without, beyond a group never touched) — gang
releases are journaled as one atomic record, so a nonzero
``partial_gangs`` is a bug, and the chaos harness asserts it stays 0.
"""

from __future__ import annotations

import os
from typing import Any

from kube_scheduler_simulator_tpu_torch.state import journal as J

Obj = dict[str, Any]

# ResourcesForSnap key -> store kind (services/snapshot.py SNAP_KIND_KEYS;
# imported lazily there to keep state/ free of a services/ dependency)
_SNAP_KEYS = (
    ("pods", "pods"),
    ("nodes", "nodes"),
    ("pvs", "persistentvolumes"),
    ("pvcs", "persistentvolumeclaims"),
    ("storageClasses", "storageclasses"),
    ("priorityClasses", "priorityclasses"),
    ("namespaces", "namespaces"),
)


def build_checkpoint(store: Any, snapshot_service: Any = None) -> Obj:
    """The checkpoint payload: a ResourcesForSnap document (REUSING
    ``SnapshotService.snap()`` — the ``resources`` field is directly
    importable by the existing snapshot tooling) plus ``extra``: every
    object the snap shape filters or doesn't cover (system priority
    classes, kube-/default namespaces, the other store kinds), so the
    checkpoint is lossless, and the store counters."""
    dump = store.dump()
    resources: Obj = {}
    if snapshot_service is not None:
        resources = snapshot_service.snap()
    covered: dict[str, set[str]] = {}
    for json_key, kind in _SNAP_KEYS:
        covered[kind] = {_obj_key(o, kind) for o in (resources.get(json_key) or [])}
    extra: dict[str, list[Obj]] = {}
    for kind, objs in dump.items():
        rest = [o for o in objs if _obj_key(o, kind) not in covered.get(kind, set())]
        if rest:
            extra[kind] = rest
    return {
        "resources": resources,
        "extra": extra,
        "counters": store.durability_counters(),
    }


def _obj_key(obj: Obj, kind: str) -> str:
    from kube_scheduler_simulator_tpu_torch.state.store import NAMESPACED_KINDS

    meta = obj.get("metadata") or {}
    ns = meta.get("namespace") or ("default" if kind in NAMESPACED_KINDS else "")
    name = meta.get("name", "")
    return f"{ns}/{name}" if ns else name


def write_mark(svc: Any, tick: int, label: str = "tick") -> None:
    """Journal a resume point: the caller-visible process state a
    recovered run needs to continue the SAME timeline — scenario tick,
    both SimClock values, the scheduling queue's unschedulableQ (pods
    waiting for an event must not be re-attempted early), per-profile
    rotation/attempt counters, the event-name sequence, and the live
    plugin-weight override.  No-op without a journal attached."""
    if getattr(svc.cluster_store, "journal", None) is None:
        return
    store_clock = getattr(svc.cluster_store, "_clock", None)
    svc_clock = svc._clock
    extra: Obj = {
        "label": label,
        "tick": int(tick),
        "store_clock": getattr(store_clock, "now", None),
        "svc_clock": getattr(svc_clock, "now", None),
        "unschedulable": sorted(svc.queue.unschedulable_keys()),
        "event_seq": int(getattr(svc, "_event_seq", 0)),
        "weights": svc._weights_requested,
    }
    svc.cluster_store.journal_append("mark", extra)


def scheduler_meta_provider(svc: Any):
    """The scheduler-side meta each journal record carries: per-profile
    rotation + attempt counters (the tie-break draw and node-rotation
    state a byte-identical resumed run must restore) and the scheduling
    queue's per-pod states.  Records are written AFTER subscriber
    dispatch (store._emit), so the queue snapshot already includes the
    record's own event's moves — recovery resumes with EXACTLY the
    crash-point queue."""

    def provider() -> Obj:
        asc = svc._autoscaler
        return {
            "sched": {
                name: [fw.sched_counter, fw.next_start_node_index]
                for name, fw in svc.frameworks.items()
            },
            "queue": svc.queue.state_snapshot(),
            "event_seq": int(getattr(svc, "_event_seq", 0)),
            # capacity-engine process state (None until it engages):
            # per-node unneeded streaks, whose loss shifts scale-down
            # timing off the uninterrupted timeline
            "autoscaler": asc.durability_state() if asc is not None else None,
        }

    return provider


class RecoveryReport:
    """What recovery found and restored."""

    def __init__(self) -> None:
        self.checkpoint_loaded = False
        self.checkpoint_index = 0
        self.bad_checkpoints = 0
        self.replayed_records = 0
        self.replayed_events = 0
        self.truncated_records = 0
        self.partial_gangs = 0
        self.scheduler_config: "Obj | None" = None
        self.last_meta: Obj = {}
        self.last_mark: "Obj | None" = None

    def stats(self) -> dict[str, int]:
        return {
            "replayed_records": self.replayed_records,
            "replayed_events": self.replayed_events,
            "truncated_records": self.truncated_records,
            "bad_checkpoints": self.bad_checkpoints,
            "checkpoint_loaded": int(self.checkpoint_loaded),
            "partial_gangs": self.partial_gangs,
        }


def load_checkpoint(store: Any, payload: Obj, report: RecoveryReport) -> None:
    """Load one checkpoint document into ``store`` (objects verbatim,
    counters restored, pre-checkpoint watch versions expired) and seed
    ``report``'s meta/mark/config base from it.  Shared by boot-time
    recovery and the replication applier's bootstrap
    (:mod:`replication.apply`)."""
    x = payload.get("x") or {}
    resources = x.get("resources") or {}
    report.scheduler_config = resources.get("schedulerConfig")
    for json_key, kind in _SNAP_KEYS:
        for o in resources.get(json_key) or []:
            store.replay_object(kind, o)
    for kind, objs in (x.get("extra") or {}).items():
        for o in objs:
            store.replay_object(kind, o)
    counters = x.get("counters")
    if counters:
        store.restore_durability_counters(counters)
        # pre-checkpoint events are compacted away: a watcher holding
        # an older resourceVersion must 410-relist, not resume
        store.expire_events_before(int(counters.get("rv", 0)))
    report.last_meta = dict(payload.get("meta") or {})
    report.last_meta["counters"] = counters
    # the resume point the compacted segments carried (journal
    # rotation must never lose the last completed mark)
    if payload.get("mark") is not None:
        report.last_mark = payload["mark"]


def apply_record(store: Any, payload: Obj, report: RecoveryReport, notify: bool = False) -> bool:
    """Apply ONE journal record to a live store — the incremental replay
    seam.  Boot-time recovery calls it per record over a fresh,
    unsubscribed store; the replication applier (:mod:`replication.apply`)
    calls it per SHIPPED record against a serving replica store, with
    ``notify=True`` so the replica's own watchers see the events.

    The record's events apply under the store lock as one unit (a wave
    or gang record is atomic to concurrent replica readers, exactly as
    it is atomic across a crash).  Returns True for a state record;
    False for framing/base records — ``seal`` markers are skipped
    outright, and a ``checkpoint`` document (the tailer injects one
    when it crosses a rotation) only refreshes the meta/mark/counter
    base: its objects were already applied record by record."""
    rtype = payload.get("t")
    if rtype == "seal":
        return False
    if rtype == "checkpoint":
        # a FULL meta base (records after it carry deltas against it —
        # including fields that drifted record-lessly, e.g. rotation
        # counters bumped by guard-skipped attempts)
        report.last_meta = dict(payload.get("meta") or {})
        counters = (payload.get("x") or {}).get("counters")
        if counters:
            report.last_meta["counters"] = counters
        if payload.get("mark") is not None:
            report.last_mark = payload["mark"]
        cfg = ((payload.get("x") or {}).get("resources") or {}).get("schedulerConfig")
        if cfg is not None:
            report.scheduler_config = cfg
        return False
    meta = payload.get("meta") or {}
    events = payload.get("events") or []
    if events:
        with store.lock:
            for kind, type_, obj in events:
                store.replay_event(kind, type_, obj, notify=notify)
                report.replayed_events += 1
    if meta:
        # MERGE, don't replace: providers omit unchanged fields
        # (the queue snapshot is delta-emitted), so an absent key
        # means "same as the previous record", not "empty"
        report.last_meta.update(meta)
    if rtype == "mark":
        report.last_mark = payload.get("x") or {}
    elif rtype == "config":
        report.scheduler_config = (payload.get("x") or {}).get("config")
    report.replayed_records += 1
    return True


class RecoveryManager:
    """Replays a journal directory into a fresh store.

    Usage (the boot path — server/di.py — and fuzz/crash_child.py):

        store = ClusterStore(clock=...)
        report = RecoveryManager(journal_dir).recover(store)
        svc = SchedulerService(store, ...)
        svc.start_scheduler(report.scheduler_config)
        report.restore_scheduler_state(svc)   # counters, queue, clocks
        # ... then attach a fresh Journal and resume serving
    """

    def __init__(self, directory: str):
        self.directory = directory

    # ---------------------------------------------------------------- boot

    def recover(self, store: Any) -> RecoveryReport:
        """Rebuild ``store`` (assumed fresh and unsubscribed) from the
        newest valid checkpoint + the journal tail.  Damage is counted,
        truncated and survived — recovery itself never raises on a torn
        or corrupt journal."""
        report = RecoveryReport()
        start_index = 0
        for idx, path in reversed(J.list_checkpoints(self.directory)):
            payload = J.read_checkpoint(path)
            if payload is None:
                report.bad_checkpoints += 1
                continue
            load_checkpoint(store, payload, report)
            report.checkpoint_loaded = True
            report.checkpoint_index = idx
            start_index = idx
            break
        for idx, path in J.list_segments(self.directory):
            if idx < start_index:
                continue  # compacted into the checkpoint
            torn_at: "int | None" = None
            for offset, payload in J.read_records(path):
                if payload is None:
                    torn_at = offset
                    report.truncated_records += 1
                    break
                # seal markers are framing metadata (skipped, uncounted)
                apply_record(store, payload, report)
            if torn_at is not None:
                # truncate the torn tail in place (the next boot reads a
                # clean file) and stop: records after a tear are garbage
                with open(path, "ab") as f:
                    f.truncate(torn_at)
                break
        counters = report.last_meta.get("counters")
        if counters:
            store.restore_durability_counters(counters)
        store.recovery_stats = report.stats()
        return report

    # ------------------------------------------------------------ invariants

    def scan_partial_gangs(self, store: Any, report: "RecoveryReport | None" = None) -> int:
        """All-or-nothing across the crash boundary: count PodGroups
        whose member pods are PARTIALLY bound (0 < bound < members
        present).  Gang releases journal as one atomic record, so this
        must be 0 at every recovery point; the chaos legs assert it."""
        partial = 0
        for group in store.list("podgroups", copy_objects=False):
            gmeta = group["metadata"]
            ns = gmeta.get("namespace", "default")
            label = gmeta["name"]
            members = [
                p
                for p in store.list("pods", namespace=ns, copy_objects=False)
                if ((p["metadata"].get("labels") or {}).get("pod-group.scheduling.sigs.k8s.io")
                    or (p["metadata"].get("labels") or {}).get("pod-group")) == label
            ]
            if not members:
                continue
            bound = sum(1 for p in members if (p.get("spec") or {}).get("nodeName"))
            if 0 < bound < len(members):
                partial += 1
        if report is not None:
            report.partial_gangs = partial
            if store.recovery_stats is not None:
                store.recovery_stats["partial_gangs"] = partial
        return partial


def restore_scheduler_state(svc: Any, report: RecoveryReport) -> None:
    """Re-arm a freshly (re)started scheduler service with the recovered
    process state: per-profile rotation/attempt counters from the last
    record's meta, then the last mark's queue unschedulable set, clocks,
    weight override and event sequence.  Call AFTER
    ``svc.start_scheduler(report.scheduler_config)``."""
    sched = report.last_meta.get("sched") or {}
    for name, fw in svc.frameworks.items():
        vals = sched.get(name)
        if vals:
            fw.sched_counter = int(vals[0])
            fw.next_start_node_index = int(vals[1])
    svc._event_seq = int(report.last_meta.get("event_seq", 0) or 0)
    mark = report.last_mark or {}
    if mark.get("event_seq"):
        svc._event_seq = max(svc._event_seq, int(mark["event_seq"]))
    # The scheduling queue restores from the LAST RECORD's meta — the
    # exact crash-point queue.  Both approximations diverged in the
    # crash harness: a fresh queue re-attempts pods the uninterrupted
    # run leaves parked (their lingering results then flush as extra
    # history entries), while the last MARK's queue (a tick boundary)
    # starves pods whose re-activating events — binds and creates now
    # durable, so never re-fired on the tick re-run — moved them
    # mid-tick.  Guard-skipped attempts (no record, no state change)
    # are re-run identically at resume, recreating the same in-memory
    # residue the dead process held.
    svc.queue.restore_states(report.last_meta.get("queue"))
    if report.last_meta.get("autoscaler") and svc.autoscale != "off":
        svc.autoscaler.restore_durability_state(report.last_meta["autoscaler"])
    if mark.get("weights") is not None:
        svc.set_plugin_weights(mark["weights"])
    store_clock = getattr(svc.cluster_store, "_clock", None)
    if mark.get("store_clock") is not None and hasattr(store_clock, "now"):
        store_clock.now = float(mark["store_clock"])
    if mark.get("svc_clock") is not None and hasattr(svc._clock, "now"):
        svc._clock.now = float(mark["svc_clock"])


def boot_recover(directory: str, store: Any) -> "RecoveryReport | None":
    """Boot-path helper (server/di.py): recover ``store`` from
    ``directory`` when it holds prior state; None when the directory is
    empty/absent (a first boot journals from scratch)."""
    if not (J.list_segments(directory) or J.list_checkpoints(directory)):
        return None
    mgr = RecoveryManager(directory)
    report = mgr.recover(store)
    mgr.scan_partial_gangs(store, report)
    return report
