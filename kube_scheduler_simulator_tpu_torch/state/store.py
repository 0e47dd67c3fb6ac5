"""In-memory columnar cluster store + event bus.

This is the simulator's control plane: it replaces the reference's
in-process kube-apiserver + external etcd (reference
simulator/k8sapiserver/k8sapiserver.go:34-88, etcd prefix
``kube-scheduler-simulator/`` at :121) with a single-process store over the
same seven resource kinds the simulator manages (reference
simulator/snapshot/snapshot.go:32-53 and
simulator/resourcewatcher/resourcewatcher.go:61-90).

Design points:

- Objects are stored as plain JSON-shaped dicts (the k8s wire format), so
  snapshot/export/import and the REST layer are serialization-free.
- Every mutation bumps a global, monotonically increasing resourceVersion
  (etcd revision analog) and appends to a bounded per-kind event log, which
  gives watchers the same list-then-watch-resume-from-resourceVersion
  protocol the reference exposes over SSE
  (reference simulator/docs/api.md:103-130).
- UIDs and timestamps come from injectable counters/clocks so scenario
  replay (KEP-140 determinism rules, reference
  keps/140-scenario-based-simulation/README.md:600-610) is bit-reproducible.
- Update callbacks run synchronously under the store lock (reentrant), which
  is what makes the annotation reflector deterministic where the reference
  needs informer goroutines + conflict retries.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Mapping

from kube_scheduler_simulator_tpu_torch.utils.retry import ConflictError

Obj = dict[str, Any]

# The 7 simulator-managed kinds (reference snapshot/watcher surface,
# SURVEY.md §2.1 #13-15) + the workload kinds the reference's mini
# controller-manager reconciles (deployment/replicaset controllers,
# reference simulator/controller/controller.go:77-83).
KINDS: tuple[str, ...] = (
    "pods",
    "nodes",
    "persistentvolumes",
    "persistentvolumeclaims",
    "storageclasses",
    "priorityclasses",
    "namespaces",
    "deployments",
    "replicasets",
    # consumed by DefaultPreemption (PDB-violation counting) and
    # NodeVolumeLimits (per-driver CSI attach limits) — the reference's
    # real apiserver serves these natively
    "poddisruptionbudgets",
    "csinodes",
    # KEP-140 Scenario objects (the reference scaffolds them as a CRD,
    # scenario/api/v1alpha1/scenario_types.go); the ScenarioOperator
    # reconciles them
    "scenarios",
    # KEP-159 Simulator objects (reconciled into isolated in-process
    # simulator instances) and KEP-184 SchedulerSimulation one-shot runs
    "simulators",
    "schedulersimulations",
    # client-go schedulers/controllers record Events best-effort; the
    # reference's real apiserver accepts them, so the kube port must too
    # (a 404 per event pollutes external schedulers' logs)
    "events",
    # capacity-engine NodeGroups (autoscaler/): declared node supply the
    # simulated cluster-autoscaler can scale between minSize and maxSize;
    # cluster-scoped, like the real CA's cloud-provider node groups
    "nodegroups",
    # gang-engine PodGroups (gang/): all-or-nothing co-scheduling units
    # in the scheduler-plugins coscheduling CRD shape
    # (scheduling.x-k8s.io/v1alpha1), namespaced like their member pods
    "podgroups",
)
NAMESPACED_KINDS: frozenset[str] = frozenset(
    {
        "pods", "persistentvolumeclaims", "deployments", "replicasets",
        "poddisruptionbudgets", "scenarios", "simulators",
        "schedulersimulations", "events", "podgroups",
    }
)

KIND_NAMES: dict[str, str] = {
    "pods": "Pod",
    "nodes": "Node",
    "persistentvolumes": "PersistentVolume",
    "persistentvolumeclaims": "PersistentVolumeClaim",
    "storageclasses": "StorageClass",
    "priorityclasses": "PriorityClass",
    "namespaces": "Namespace",
    "deployments": "Deployment",
    "replicasets": "ReplicaSet",
    "poddisruptionbudgets": "PodDisruptionBudget",
    "csinodes": "CSINode",
    "scenarios": "Scenario",
    "simulators": "Simulator",
    "schedulersimulations": "SchedulerSimulation",
    "events": "Event",
    "nodegroups": "NodeGroup",
    "podgroups": "PodGroup",
}

EVENT_ADDED = "ADDED"
EVENT_MODIFIED = "MODIFIED"
EVENT_DELETED = "DELETED"

# Sentinel a bulk_update mutation returns to delete its object
# (bulk_update(allow_delete=True)) — the autoscaler's scale-down wave.
BULK_DELETE: Any = object()


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(ValueError):
    pass


class ResourceExpiredError(Exception):
    """The requested resourceVersion has been compacted out of the event log.

    Analog of the apiserver's 410 Gone on an expired watch resourceVersion;
    the watcher must relist (the reference's RetryWatcher does the same,
    reference simulator/resourcewatcher/resourcewatcher.go:128-134).
    """


class Event:
    __slots__ = ("kind", "type", "obj", "resource_version", "old_obj")

    def __init__(
        self,
        kind: str,
        type_: str,
        obj: Obj,
        resource_version: int,
        old_obj: "Obj | None" = None,
    ):
        self.kind = kind
        self.type = type_
        self.obj = obj
        self.resource_version = resource_version
        # prior state on MODIFIED (shared read-only snapshot) — selector
        # watches need it to synthesize ADDED/DELETED on transitions
        self.old_obj = old_obj

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Event({self.kind}, {self.type}, {_key(self.obj)}, rv={self.resource_version})"


def _clone(o: Any) -> Any:
    """Deep copy for JSON-shaped objects (dict/list/scalars) — several
    times faster than ``copy.deepcopy`` (no memo bookkeeping, no dispatch),
    which matters at 10k pods carrying megabyte annotation strings.
    Non-JSON leaves fall back to deepcopy."""
    cls = o.__class__
    if cls is dict:
        return {k: _clone(v) for k, v in o.items()}
    if cls is list:
        return [_clone(v) for v in o]
    if o is None or isinstance(o, (str, int, float, bool)):
        return o  # immutable (includes str subclasses like RawJSON)
    return copy.deepcopy(o)


def _key(obj: Mapping[str, Any]) -> str:
    meta = obj.get("metadata", {})
    ns = meta.get("namespace", "")
    name = meta.get("name", "")
    return f"{ns}/{name}" if ns else name


def _rfc3339(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


def _profiled(fn):
    """Stamp a mutating entry point as ``store_mutate`` (minus the
    journal bytes inside it, carved out as ``journal_append``) against
    the wave profiler's ambient record — nested entry points (patch ->
    update, apply -> create) stamp once at the outermost frame, tracked
    per thread so concurrent HTTP mutators can't cross-talk.  With no
    profiler attached (``store.profiler is None``) the wrapper is two
    attribute reads."""

    def wrapper(self, *args, **kwargs):
        prof = self.profiler
        if prof is None or not prof.enabled:
            return fn(self, *args, **kwargs)
        tl = self._stamp_tl
        if getattr(tl, "depth", 0):
            return fn(self, *args, **kwargs)
        tl.depth = 1
        t0 = time.perf_counter()
        j0 = self._journal_s
        try:
            return fn(self, *args, **kwargs)
        finally:
            tl.depth = 0
            dt = time.perf_counter() - t0
            dj = self._journal_s - j0
            if dj > 0.0:
                prof.ambient("journal_append", dj)
                dt -= dj
            if dt > 0.0:
                prof.ambient("store_mutate", dt)

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    wrapper.__wrapped__ = fn
    return wrapper


# kube's generateName suffix alphabet (no vowels/ambiguous chars)
_SUFFIX_ALPHABET = "bcdfghjklmnpqrstvwxz2456789"


def _name_suffix(n: int) -> str:
    """5-char generateName suffix derived from a counter (deterministic,
    unlike the apiserver's random draw — scenario replay needs it)."""
    out = []
    for _ in range(5):
        out.append(_SUFFIX_ALPHABET[n % len(_SUFFIX_ALPHABET)])
        n //= len(_SUFFIX_ALPHABET)
    return "".join(out)


class ClusterStore:
    """Single-process cluster state for the seven simulator resource kinds."""

    def __init__(self, clock: Callable[[], float] | None = None, event_log_size: int = 4096):
        self._lock = threading.RLock()
        self._objs: dict[str, dict[str, Obj]] = {k: {} for k in KINDS}
        self._rv = 0
        self._uid_counter = 0
        self._generate_name_counter = 0
        # wholesale restores so far (``restore``): a batch engine holding
        # encoder state and resident planes of this store drops them when
        # the count moved since its last round
        self.restores = 0
        self._clock = clock or time.time
        self._event_log: dict[str, deque[Event]] = {k: deque(maxlen=event_log_size) for k in KINDS}
        self._evicted_rv: dict[str, int] = {k: 0 for k in KINDS}
        self._subscribers: list[tuple[frozenset[str], Callable[[Event], None]]] = []
        self._update_hooks: dict[str, list[Callable[[Obj, Obj], None]]] = {k: [] for k in KINDS}
        # durability (state/journal.py, opt-in): with a journal attached,
        # every emitted event becomes a WAL record; journal_txn groups a
        # bulk operation's events into ONE atomic record.  recovery_stats
        # is populated by state/recovery.py after a boot-time replay.
        self.journal: Any = None
        self.recovery_stats: "dict[str, int] | None" = None
        # live journal-shipping counters (replication/apply.py): set by a
        # ReplicaApplier feeding this store; stays None on a primary
        self.replication_stats: "dict[str, Any] | None" = None
        # wave profiler seam (ops/profile.py): SchedulerService points
        # this at its profiler so mutating entry points stamp
        # store_mutate/journal_append; None = unprofiled store, zero cost
        self.profiler: Any = None
        self._journal_s = 0.0  # cumulative journal-append seconds
        self._stamp_tl = threading.local()  # per-thread _profiled depth
        # render-once wire-bytes cache (server/wirecache.py), attached by
        # the serving layer; the store's only duty is invalidation on
        # mutation/replay so stale bytes can never be served
        self.wirecache: Any = None
        # per-THREAD transaction buffer: a journal_txn groups only the
        # events its own thread emits (other threads' concurrent
        # mutations are their own transactions), and holding no lock
        # across the txn body keeps the journal-on path from serializing
        # every store reader behind a whole scheduling attempt
        self._txn_local = threading.local()
        # open transactions across ALL threads (guarded by the store
        # lock): the journal's compaction gate — a checkpoint taken
        # while a wave's mutations are applied but its atomic record
        # unwritten would persist the half-applied wave
        self._active_txns = 0

    # ------------------------------------------------------------------ infra

    @property
    def lock(self) -> threading.RLock:
        """The store's reentrant lock — components that must act atomically
        with store state (e.g. the controller manager) synchronize on THIS
        lock instead of a private one, so there is a single lock order."""
        return self._lock

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    def count(self, kind: str) -> int:
        """Object count without the deepcopy cost of list()."""
        with self._lock:
            return len(self._bucket(kind))

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def _next_uid(self) -> str:
        self._uid_counter += 1
        c = self._uid_counter
        return f"{c:08x}-0000-4000-8000-{c:012x}"

    # ------------------------------------------------------------ durability

    def attach_journal(self, journal: Any) -> None:
        """Attach a write-ahead journal (state/journal.py): every event
        emitted from now on becomes a durable record before the mutating
        call returns.  Attach at boot, before concurrent mutators exist —
        the ``self.journal is None`` fast paths are deliberately read
        without the lock."""
        with self._lock:
            self.journal = journal
            journal.add_meta_provider(lambda: {"counters": self.durability_counters()})
            # one total order for records and their meta deltas, and no
            # checkpoint while a transaction's events are unwritten
            journal.append_lock = self._lock
            journal.compaction_gate = self._no_open_txns

    def _no_open_txns(self) -> bool:
        # lock-free: invoked by Journal.compact with the store lock
        # already held (journal.append_lock IS self._lock)
        return self._active_txns == 0

    def journal_append(self, rtype: str, extra: "Obj | None" = None) -> None:
        """Append a non-event record (config/boot/mark) — the journal
        itself serializes on the store lock via ``append_lock``."""
        # lock-free: self.journal is written once at attach (boot) and
        # never cleared; the append itself takes the store lock inside
        if self.journal is not None:
            t0 = time.perf_counter()
            self.journal.append(rtype, extra=extra)
            self._journal_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def journal_txn(self, label: str = "txn"):
        """Group every event THIS THREAD emits inside the block into ONE
        atomic journal record (labelled ``label``) — the wave-atomicity
        seam: a batch commit wave, a gang release, a bulk_update, a
        sequential scheduling attempt each journal all-or-nothing, so
        recovery can never observe them half-applied.  Nested
        transactions flatten into the outermost.  The buffer is
        thread-local and NO lock is held across the body — a journaled
        deployment must not serialize every store reader behind a whole
        scheduling attempt; individual mutations still buffer/write
        under the store lock inside ``_emit``.  No journal = free no-op."""
        # lock-free: self.journal is written once at attach (boot, before
        # concurrent mutators exist) and never cleared — the journal-off
        # fast path must not pay a lock round-trip per wave
        if self.journal is None:
            yield
            return
        # a WEDGED journal (disk fault under KSS_JOURNAL_ON_ERROR=wedge)
        # refuses the transaction HERE, before any store mutation runs —
        # the durability promise fails loudly, never silently ahead of
        # the on-disk stream
        self.journal.check_writable()
        tl = self._txn_local
        depth = getattr(tl, "depth", 0)
        if depth == 0:
            tl.events = []
            with self._lock:
                self._active_txns += 1
        tl.depth = depth + 1
        try:
            yield
        finally:
            tl.depth -= 1
            if tl.depth == 0:
                events, tl.events = tl.events, None
                with self._lock:
                    self._active_txns -= 1
                    if events:
                        t0 = time.perf_counter()
                        self.journal.append(label, events=events)
                        self._journal_s += time.perf_counter() - t0

    def durability_counters(self) -> dict[str, int]:
        """The store counters a byte-identical recovery must restore
        (rides on every journal record's meta)."""
        return {
            "rv": self._rv,
            "uid": self._uid_counter,
            "gen": self._generate_name_counter,
        }

    def restore_durability_counters(self, counters: Mapping[str, int]) -> None:
        with self._lock:
            self._rv = max(self._rv, int(counters.get("rv", 0)))
            self._uid_counter = max(self._uid_counter, int(counters.get("uid", 0)))
            self._generate_name_counter = max(
                self._generate_name_counter, int(counters.get("gen", 0))
            )

    def replay_object(self, kind: str, obj: Mapping[str, Any]) -> None:
        """Recovery-only: place a checkpointed object into its bucket
        VERBATIM — uid, resourceVersion and creationTimestamp preserved,
        no admission, no events (pre-checkpoint history is compacted
        away; ``expire_events_before`` makes stale watchers relist)."""
        with self._lock:
            o = _clone(dict(obj))
            meta = o.setdefault("metadata", {})
            if kind in NAMESPACED_KINDS:
                meta.setdefault("namespace", "default")
            if self.wirecache is not None:
                self.wirecache.invalidate(kind, meta, deleted=False)
            self._bucket(kind)[_key(o)] = o
            rv = int(meta.get("resourceVersion") or 0)
            self._rv = max(self._rv, rv)

    def replay_event(self, kind: str, type_: str, obj: Mapping[str, Any], notify: bool = False) -> None:
        """Replay-only: re-apply one journaled event — bucket update
        plus an event-log append (so watchers can resume from replayed
        resourceVersions).  Boot-time recovery leaves ``notify`` off
        (replay runs before any component subscribes); a live read
        replica (replication/apply.py) passes ``notify=True`` so its
        OWN subscribers — the watcher service's streams — see shipped
        events as they apply.  Update hooks and the journal are never
        involved: a replayed event is history, not a new mutation."""
        with self._lock:
            bucket = self._bucket(kind)
            o = _clone(dict(obj))
            k = _key(o)
            if self.wirecache is not None:
                self.wirecache.invalidate(
                    kind, o.get("metadata") or {}, deleted=type_ == EVENT_DELETED
                )
            if type_ == EVENT_DELETED:
                bucket.pop(k, None)
            else:
                bucket[k] = o
            rv = int(o["metadata"].get("resourceVersion") or 0)
            self._rv = max(self._rv, rv)
            # the event shares the replayed object (frozen once placed —
            # same replacement contract as _emit)
            ev = Event(kind, type_, o, rv)
            log = self._event_log[kind]
            if log.maxlen is not None and len(log) == log.maxlen:
                self._evicted_rv[kind] = log[0].resource_version
            log.append(ev)
            if notify:
                for kinds, cb in list(self._subscribers):
                    if kind in kinds:
                        cb(ev)

    def clear_for_replay(self) -> None:
        """Replication rebase (replication/apply.py): drop every bucket
        and event log so a NEWER checkpoint can be loaded verbatim after
        compaction pruned the segment a follower was reading.  Counters
        are kept — ``restore_durability_counters`` max-merges, so the
        resourceVersions connected watchers hold never regress."""
        with self._lock:
            if self.wirecache is not None:
                self.wirecache.clear()
            for kind in KINDS:
                self._objs[kind].clear()
                self._event_log[kind].clear()

    def expire_events_before(self, rv: int) -> None:
        """Mark every kind's event log as compacted below ``rv``: a
        watcher resuming from an older resourceVersion gets the
        410-relist path (checkpoint compaction discards the journaled
        events a checkpoint supersedes)."""
        with self._lock:
            for kind in KINDS:
                self._evicted_rv[kind] = max(self._evicted_rv[kind], int(rv))

    def _emit(self, kind: str, type_: str, obj: Obj, old: Obj | None = None) -> None:
        # ZERO clones: the event shares the stored object itself as a
        # read-only snapshot.  Safe by the store's own replacement
        # contract — mutations never write into a stored object in
        # place, they replace the bucket entry with a fresh dict (update/
        # bulk_update/patch all rebuild; delete clones before stamping) —
        # so the object an event references is frozen for its lifetime,
        # exactly like an informer-cache object.  Consumers serialize or
        # read it; mutating it would corrupt the event log AND the store.
        # ``old`` is the replaced object the store no longer references,
        # so it needs no copy either.
        if self.wirecache is not None:
            self.wirecache.invalidate(kind, obj["metadata"], deleted=type_ == EVENT_DELETED)
        ev = Event(kind, type_, obj, int(obj["metadata"]["resourceVersion"]), old_obj=old)
        log = self._event_log[kind]
        if log.maxlen is not None and len(log) == log.maxlen:
            self._evicted_rv[kind] = log[0].resource_version
        log.append(ev)
        for kinds, cb in list(self._subscribers):
            if kind in kinds:
                cb(ev)
        if type_ == EVENT_MODIFIED and old is not None:
            for hook in list(self._update_hooks[kind]):
                hook(old, ev.obj)
        if self.journal is not None:
            # WAL: the event is durable before the mutating call returns
            # (or buffered for this thread's enclosing journal_txn's
            # atomic record).  Written AFTER the synchronous
            # subscriber/hook dispatch so the record's meta — read at
            # write time — already reflects this event's own
            # consequences (the scheduling queue's move, the reflector's
            # bookkeeping): recovery restores process state from the
            # last record's meta, and a meta snapshotted BEFORE dispatch
            # would lose the final event's transitions to the crash.
            triple = [kind, type_, ev.obj]
            if getattr(self._txn_local, "depth", 0) > 0:
                self._txn_local.events.append(triple)
            else:
                t0 = time.perf_counter()
                self.journal.append("event", events=[triple])
                self._journal_s += time.perf_counter() - t0

    def subscribe(self, kinds: Iterable[str], cb: Callable[[Event], None]) -> Callable[[], None]:
        """Register a synchronous event callback; returns an unsubscribe fn."""
        entry = (frozenset(kinds), cb)
        with self._lock:
            self._subscribers.append(entry)

        def unsubscribe() -> None:
            with self._lock:
                if entry in self._subscribers:
                    self._subscribers.remove(entry)

        return unsubscribe

    def on_update(self, kind: str, hook: Callable[[Obj, Obj], None]) -> Callable[[], None]:
        """Register an informer-style UpdateFunc hook (old, new).

        Mirrors the reference's pod-update informer registration used by the
        store reflector (reference
        simulator/scheduler/storereflector/storereflector.go:55-72).
        """
        with self._lock:
            self._update_hooks[kind].append(hook)

        def unsubscribe() -> None:
            with self._lock:
                if hook in self._update_hooks[kind]:
                    self._update_hooks[kind].remove(hook)

        return unsubscribe

    def events_since(self, kind: str, rv: int) -> list[Event]:
        """Events for ``kind`` with resourceVersion > rv (watch resume).

        Raises ResourceExpiredError (410 Gone analog) if events after ``rv``
        have already been compacted out of the bounded log — the caller must
        relist instead of silently missing events.
        """
        with self._lock:
            if rv < self._evicted_rv[kind]:
                raise ResourceExpiredError(
                    f"{kind}: resourceVersion {rv} expired (oldest retained > {self._evicted_rv[kind]})"
                )
            if rv > self._rv:
                # A version this store never issued: the client watched a
                # previous incarnation whose log tail died with it (crash
                # recovery re-numbers from the last durable record).
                # Resuming silently would replay versions the client
                # already saw — and its dedup watermark would then drop
                # the REAL events.  Same contract as an expired version:
                # relist.
                raise ResourceExpiredError(
                    f"{kind}: resourceVersion {rv} is newer than this store's log "
                    f"(current {self._rv}; recovered/re-numbered event log) — relist"
                )
            return [e for e in self._event_log[kind] if e.resource_version > rv]

    # ------------------------------------------------------------------- CRUD

    def _bucket(self, kind: str) -> dict[str, Obj]:
        try:
            return self._objs[kind]
        except KeyError:
            raise NotFoundError(f"unknown resource kind {kind!r}") from None

    @_profiled
    def create(self, kind: str, obj: Mapping[str, Any], owned: bool = False) -> Obj:
        """``owned=True``: the caller transfers ownership of ``obj`` (a
        fresh dict it drops after the call — a parsed request body, a
        generator's output) — skips the defensive input clone AND the
        return clone: the caller receives the stored object itself and
        must treat it as read-only."""
        with self._lock:
            bucket = self._bucket(kind)
            o = dict(obj) if owned else _clone(dict(obj))
            meta = o.setdefault("metadata", {})
            if kind in NAMESPACED_KINDS:
                meta.setdefault("namespace", "default")
            if not meta.get("name") and meta.get("generateName"):
                # apiserver generateName semantics (the reference UI's
                # creation templates rely on it) with a counter-derived
                # suffix instead of a random one: scenario replay must be
                # deterministic (keps/140 determinism rules)
                n = self._generate_name_counter
                while True:
                    cand = meta["generateName"] + _name_suffix(n)
                    n += 1
                    if _key({"metadata": {**meta, "name": cand}}) not in bucket:
                        break
                self._generate_name_counter = n
                meta["name"] = cand
            k = _key(o)
            if not meta.get("name"):
                raise ValueError(f"{kind} object has no metadata.name")
            if k in bucket:
                raise AlreadyExistsError(f"{kind} {k!r} already exists")
            meta["uid"] = self._next_uid()
            # k8s wire format: resourceVersion is a string.
            meta["resourceVersion"] = str(self._next_rv())
            meta.setdefault("creationTimestamp", _rfc3339(self._clock()))
            if kind == "pods":
                o.setdefault("status", {}).setdefault("phase", "Pending")
                self._admit_priority(o)
            bucket[k] = o
            self._emit(kind, EVENT_ADDED, o)
            return o if owned else _clone(o)

    # The ONE admission plugin the reference keeps enabled is Priority
    # (reference simulator/k8sapiserver/k8sapiserver.go:158-163): it
    # resolves spec.priorityClassName into spec.priority at create time
    # (built-in system classes included), applies the globalDefault class
    # when no name is given, and rejects unknown class names.
    _SYSTEM_PRIORITY_CLASSES = {
        "system-cluster-critical": 2000000000,
        "system-node-critical": 2000001000,
    }

    def _admit_priority(self, pod: Obj) -> None:
        spec = pod.setdefault("spec", {})
        if spec.get("priority") is not None:
            return
        name = spec.get("priorityClassName")
        if not name:
            default = None
            for pc in self._bucket("priorityclasses").values():
                if pc.get("globalDefault"):
                    default = pc
                    break
            if default is not None:
                spec["priorityClassName"] = default["metadata"]["name"]
                spec["priority"] = int(default.get("value") or 0)
            else:
                spec["priority"] = 0
            return
        if name in self._SYSTEM_PRIORITY_CLASSES:
            spec["priority"] = self._SYSTEM_PRIORITY_CLASSES[name]
            return
        pc = self._bucket("priorityclasses").get(name)
        if pc is None:
            raise ValueError(f"no PriorityClass with name {name} was found")
        spec["priority"] = int(pc.get("value") or 0)

    @_profiled
    def update(self, kind: str, obj: Mapping[str, Any], owned: bool = False) -> Obj:
        """``owned=True``: the caller transfers ownership of ``obj`` (built
        from its own copy, dropped after the call) — skips the defensive
        input clone that dominates megabyte-annotation flushes."""
        with self._lock:
            bucket = self._bucket(kind)
            o = dict(obj) if owned else _clone(dict(obj))
            meta = o.setdefault("metadata", {})
            if kind in NAMESPACED_KINDS:
                meta.setdefault("namespace", "default")
            k = _key(o)
            cur = bucket.get(k)
            if cur is None:
                raise NotFoundError(f"{kind} {k!r} not found")
            sent_rv = meta.get("resourceVersion")
            if sent_rv is not None and int(sent_rv) != int(cur["metadata"]["resourceVersion"]):
                raise ConflictError(
                    f"{kind} {k!r}: resourceVersion {sent_rv} != {cur['metadata']['resourceVersion']}"
                )
            old = cur
            meta["uid"] = cur["metadata"]["uid"]
            meta["creationTimestamp"] = cur["metadata"]["creationTimestamp"]
            meta["resourceVersion"] = str(self._next_rv())
            bucket[k] = o
            self._emit(kind, EVENT_MODIFIED, o, old=old)
            return _clone(o)

    @_profiled
    def apply(self, kind: str, obj: Mapping[str, Any]) -> Obj:
        """Upsert, ignoring any stale uid/resourceVersion on the input.

        This is the role server-side Apply plays in the reference's snapshot
        load path, where UIDs are nulled before applying (reference
        simulator/snapshot/snapshot.go:373-536).
        """
        with self._lock:
            o = _clone(dict(obj))
            meta = o.setdefault("metadata", {})
            if kind in NAMESPACED_KINDS:
                meta.setdefault("namespace", "default")
            meta.pop("uid", None)
            meta.pop("resourceVersion", None)
            k = _key(o)
            if k in self._bucket(kind):
                return self.update(kind, o, owned=True)
            return self.create(kind, o)

    @_profiled
    def bulk_update(
        self,
        kind: str,
        mutations: "Iterable[tuple[str, str | None, Callable[[Obj | None], Obj | None]]]",
        allow_create: bool = False,
        allow_delete: bool = False,
    ) -> int:
        """Apply a wave of object mutations under ONE lock acquisition
        with one batched watch-event dispatch — the bulk-apply entry point
        the batch scheduler's commit pipeline uses instead of N
        get/update round-trips (each of which would take and release the
        lock and dispatch its event inline).

        ``mutations``: (name, namespace, fn) triples.  ``fn`` receives the
        LIVE current object — read under the lock, so the
        read-modify-write is atomic and conflict-free by construction —
        and must treat it as READ-ONLY, returning a full replacement
        object (copy-on-write: rebuild the dicts along the changed path,
        share everything else), or None to skip.  The read-only contract
        is what makes the wave cheap: a defensive deep copy of a
        megabyte-annotation pod per mutation would cost more than the
        lock round-trips this entry point removes.  Objects deleted since
        the caller planned the wave are skipped silently, exactly as a
        per-object update loop would drop its NotFound.  Events are
        appended to the log in mutation order (per-object
        resourceVersions stay monotonic) and dispatched to
        subscribers/hooks in one batch after all mutations land.
        The replacement's ``metadata`` dict must itself be fresh — the
        store stamps uid/creationTimestamp/resourceVersion into it.

        ``allow_create=True``: a mutation naming a MISSING object calls
        ``fn(None)`` — a returned object is created in the wave (stamped
        like ``create``, ADDED event).  ``allow_delete=True``: a mutation
        whose ``fn`` returns the ``BULK_DELETE`` sentinel removes the
        object (DELETED event).  The capacity engine materializes and
        drains autoscaled nodes through these; events are dispatched
        one-per-object after the wave commits — a subscriber (e.g. the
        scheduling queue's moveRequestCycle) sees exactly the N events N
        individual create/update/delete calls would have produced, in
        mutation order.  Returns the number of objects changed."""
        applied = 0
        events: list[tuple[str, Obj, Obj | None]] = []
        # one bulk-apply = one atomic journal record (nested waves — the
        # batch commit pipeline's bind + flush_wave — flatten into their
        # outer journal_txn)
        with self.journal_txn("bulk"), self._lock:
            bucket = self._bucket(kind)
            for name, namespace, fn in mutations:
                if kind in NAMESPACED_KINDS:
                    k = f"{namespace or 'default'}/{name}"
                else:
                    k = name
                cur = bucket.get(k)
                if cur is None:
                    if not allow_create:
                        continue
                    o = fn(None)
                    if o is None or o is BULK_DELETE:
                        continue
                    meta = o.setdefault("metadata", {})
                    meta.setdefault("name", name)
                    if kind in NAMESPACED_KINDS:
                        meta.setdefault("namespace", namespace or "default")
                    meta["uid"] = self._next_uid()
                    meta["resourceVersion"] = str(self._next_rv())
                    meta.setdefault("creationTimestamp", _rfc3339(self._clock()))
                    if kind == "pods":
                        o.setdefault("status", {}).setdefault("phase", "Pending")
                        self._admit_priority(o)
                    bucket[k] = o
                    events.append((EVENT_ADDED, o, None))
                    applied += 1
                    continue
                o = fn(cur)
                if o is None or o is cur:
                    continue
                if o is BULK_DELETE:
                    if not allow_delete:
                        continue
                    del bucket[k]
                    # hot-render-ok: the delete event's rv stamp must not
                    # mutate the (shared, frozen) stored object
                    dead = _clone(cur)
                    dead["metadata"]["resourceVersion"] = str(self._next_rv())
                    events.append((EVENT_DELETED, dead, None))
                    applied += 1
                    continue
                meta = o.setdefault("metadata", {})
                meta["uid"] = cur["metadata"]["uid"]
                meta["creationTimestamp"] = cur["metadata"]["creationTimestamp"]
                meta["resourceVersion"] = str(self._next_rv())
                bucket[k] = o
                events.append((EVENT_MODIFIED, o, cur))
                applied += 1
            for type_, o, old in events:
                self._emit(kind, type_, o, old=old)
        return applied

    @_profiled
    def patch(self, kind: str, name: str, patch: Mapping[str, Any], namespace: str | None = None) -> Obj:
        """Strategic-merge-lite patch: dicts merge recursively, None deletes."""
        with self._lock:
            cur = self._get_internal(kind, name, namespace)
            o = _clone(cur)
            _merge(o, patch)
            o["metadata"]["resourceVersion"] = cur["metadata"]["resourceVersion"]
            return self.update(kind, o, owned=True)

    def get(self, kind: str, name: str, namespace: str | None = None) -> Obj:
        with self._lock:
            return _clone(self._get_internal(kind, name, namespace))

    def _get_internal(self, kind: str, name: str, namespace: str | None = None) -> Obj:
        bucket = self._bucket(kind)
        if kind in NAMESPACED_KINDS:
            namespace = namespace or "default"
            k = f"{namespace}/{name}"
        else:
            k = name
        obj = bucket.get(k)
        if obj is None:
            raise NotFoundError(f"{kind} {k!r} not found")
        return obj

    def list(self, kind: str, namespace: str | None = None, copy_objects: bool = True) -> list[Obj]:
        """Objects sorted by (namespace, name) — etcd key order.

        ``copy_objects=False`` returns the live objects WITHOUT deep
        copies for read-only consumers (the scheduler's encode/snapshot
        hot paths — the reference reads straight from the informer cache
        the same way, client-go lister contract).  Callers must not
        mutate the result; at 10k pods carrying megabyte annotation
        maps, deep-copying dominates the scheduling round otherwise."""
        with self._lock:
            bucket = self._bucket(kind)
            return [
                # hot-render-ok: compat default — copy_objects=False is
                # the hot-path read every serving consumer opts into
                (_clone(o) if copy_objects else o)
                for _, o in sorted(bucket.items())
                if namespace is None or o["metadata"].get("namespace") == namespace
            ]

    @_profiled
    def delete(self, kind: str, name: str, namespace: str | None = None) -> Obj:
        with self._lock:
            obj = self._get_internal(kind, name, namespace)
            k = _key(obj)
            del self._bucket(kind)[k]
            # clone before stamping the delete revision: copy_objects=False
            # listers may still hold the internal object in an in-flight
            # round snapshot
            obj = _clone(obj)
            obj["metadata"]["resourceVersion"] = str(self._next_rv())
            self._emit(kind, EVENT_DELETED, obj)
            return obj

    # ----------------------------------------------------------- pod helpers

    @_profiled
    def bind_pod(self, namespace: str, name: str, node_name: str) -> Obj:
        """Bind a pod to a node (the Binding-subresource POST of the
        reference's bind phase, SURVEY.md section 3.2)."""
        with self._lock:
            cur = self._get_internal("pods", name, namespace)
            # copy-on-write along the changed path only: fresh top-level,
            # metadata (update stamps uid/rv into it) and spec dicts;
            # everything else — megabyte annotation maps included — is
            # shared with the frozen previous version
            pod = {
                **cur,
                "metadata": dict(cur["metadata"]),
                "spec": {**(cur.get("spec") or {}), "nodeName": node_name},
            }
            # The Binding subresource only sets spec.nodeName; with no kubelet
            # in the simulator, bound pods stay Pending (as in the reference).
            return self.update("pods", pod, owned=True)

    # ------------------------------------------------------ snapshot / reset

    def dump(self) -> dict[str, list[Obj]]:
        with self._lock:
            # hot-render-ok: snapshot/reset surface, never the commit path
            return {k: [_clone(o) for _, o in sorted(b.items())] for k, b in self._objs.items()}

    def restore(self, data: Mapping[str, list[Obj]], preserve: "Iterable[str]" = ()) -> None:
        """Wholesale state replacement (reset-service restore path,
        reference simulator/reset/reset.go:57-84).

        Deletion runs owners-first (deployments → replicasets → pods …) so
        the synchronous controller manager can't resurrect owned objects
        mid-teardown.  ``preserve`` kinds are left COMPLETELY untouched —
        atomically, under the store lock (the scenario engine preserves
        Scenario objects through its cluster wipe this way; a
        snapshot-then-restore would race concurrent creates)."""
        preserved = frozenset(preserve)
        delete_order = tuple(
            k
            for k in ("deployments", "replicasets")
            + tuple(k for k in KINDS if k not in ("deployments", "replicasets"))
            if k not in preserved
        )
        # Apply dependencies first: namespaces and priorityclasses before
        # pods (Priority admission resolves priorityClassName at pod
        # create, so a payload carrying both must land the class first).
        apply_first = ("namespaces", "priorityclasses")
        apply_order = tuple(
            k
            for k in apply_first + tuple(k for k in KINDS if k not in apply_first)
            if k not in preserved
        )
        # a restore is one atomic state transition — and one journal record
        with self.journal_txn("restore"), self._lock:
            self.restores += 1
            for kind in delete_order:
                # Delete everything not in the target state.  Key
                # computation must default the namespace exactly like
                # create/apply do, or namespaced objects without an explicit
                # namespace would be deleted+recreated instead of updated.
                def keyed(o: Mapping[str, Any]) -> str:
                    meta = dict(o.get("metadata") or {})
                    if kind in NAMESPACED_KINDS:
                        meta.setdefault("namespace", "default")
                    return _key({"metadata": meta})

                want = {keyed(o) for o in data.get(kind, [])}
                for k in list(self._bucket(kind)):
                    if k not in want:
                        obj = self._bucket(kind)[k]
                        self.delete(kind, obj["metadata"]["name"], obj["metadata"].get("namespace"))
            for kind in apply_order:
                for o in data.get(kind, []):
                    self.apply(kind, o)
            # same wholesale state → same generated names afterwards
            # (scenario replay determinism depends on it)
            self._generate_name_counter = 0


def _merge(dst: dict[str, Any], patch: Mapping[str, Any]) -> None:
    for k, v in patch.items():
        if v is None:
            dst.pop(k, None)
        elif isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            # hot-render-ok: merge-patch semantics — the stored object
            # must own its values, never alias the caller's patch body
            dst[k] = _clone(v)
