"""Upstream-shaped scheduling queue: activeQ / backoffQ / unschedulableQ.

The reference inherits kube-scheduler's queue through ``scheduler.New``
(reference simulator/scheduler/scheduler.go:155-183; its own
scheduler/queue/queue.go:1-7 is an empty scaffold).  This build implements
the same state machine natively:

- a pod ready to run sits in **activeQ**;
- a failed attempt moves it to **unschedulableQ** with an exponential
  per-pod backoff (initial 1s, doubling to a 10s cap — upstream
  podInitialBackoffDuration/podMaxBackoffDuration);
- a RELEVANT cluster event (node add/update/delete, pod add/delete, or a
  pod update that changes scheduling-relevant fields — NOT a status-only
  patch) moves unschedulable pods to **backoffQ**, from which they pop
  once their backoff expires (upstream MoveAllToActiveOrBackoffQueue);
- pods stuck in unschedulableQ longer than ``unschedulable_timeout`` are
  flushed to backoff anyway (upstream flushUnschedulablePodsLeftover).

The queue tracks STATE only (pod keys → attempt counts and deadlines);
the pod objects stay in the cluster store.  ``ready()`` decides which
store-pending pods a round may attempt: the scheduler service's
synchronous drain (scenario replay) passes ``ignore_backoff=True`` so
event-moved pods retry deterministically within the drain, while the
background loop enforces real backoff — which is what stops a
persistently unschedulable pod from being re-filtered against every node
on every wakeup (the round-2 churn cliff).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable

from kube_scheduler_simulator_tpu_torch.utils.keys import pod_key as _pod_key

Obj = dict[str, Any]

ACTIVE = "active"
BACKOFF = "backoff"
UNSCHEDULABLE = "unschedulable"


class _PodState:
    __slots__ = ("state", "attempts", "backoff_until", "unschedulable_since")

    def __init__(self) -> None:
        self.state = ACTIVE
        self.attempts = 0
        self.backoff_until = 0.0
        self.unschedulable_since = 0.0


def _scheduling_relevant_update(old: "Obj | None", new: Obj) -> bool:
    """Does this pod MODIFIED event affect OTHER pods' schedulability?
    Binds (nodeName set), label changes and spec changes do; a pure
    status patch (the scheduler's own failure recording) does not —
    that's the event class whose churn upstream's queue absorbs."""
    if old is None:
        return True
    if (old.get("spec") or {}) != (new.get("spec") or {}):
        return True
    if (old["metadata"].get("labels") or {}) != (new["metadata"].get("labels") or {}):
        return True
    if bool(old["metadata"].get("deletionTimestamp")) != bool(new["metadata"].get("deletionTimestamp")):
        return True
    return False


class SchedulingQueue:
    def __init__(
        self,
        clock: "Callable[[], float] | None" = None,
        initial_backoff_s: float = 1.0,
        max_backoff_s: float = 10.0,
        unschedulable_timeout_s: float = 60.0,
    ):
        self._clock = clock or time.monotonic
        self.initial_backoff_s = initial_backoff_s
        self.max_backoff_s = max_backoff_s
        self.unschedulable_timeout_s = unschedulable_timeout_s
        self._pods: dict[str, _PodState] = {}
        self._unschedulable = 0  # fast move_all skip during bind storms
        # monotone move-request counter (upstream moveRequestCycle): a pod
        # whose failure is recorded AFTER a move request that happened
        # during its attempt goes straight to backoffQ — the event that
        # would have re-activated it (e.g. its own preemption's victim
        # deletes) fired while it was still in flight
        self.move_seq = 0
        self._lock = threading.Lock()
        # observability (metrics endpoint)
        self.moves = 0
        self.flushes = 0
        # bumped on EVERY per-pod state change (tracking, transitions,
        # activations): state_snapshot caches on it, so the journal's
        # per-record meta pays the O(pods) snapshot walk only when the
        # queue actually changed
        self.mutation_seq = 0
        self._snap_cache: "tuple[int, dict[str, list[str]]] | None" = None

    # ------------------------------------------------------------ tracking

    def ensure_tracked(self, key: str) -> None:
        with self._lock:
            if key not in self._pods:
                self._pods[key] = _PodState()
                self.mutation_seq += 1

    def forget(self, key: str) -> None:
        with self._lock:
            st = self._pods.pop(key, None)
            if st is not None:
                self.mutation_seq += 1
                if st.state == UNSCHEDULABLE:
                    self._unschedulable -= 1

    def backoff_for(self, attempts: int) -> float:
        """Exponential per-pod backoff: initial * 2^(attempts-1), capped.
        The exponent is clamped too — a pod retried for months must not
        overflow the float pow."""
        if attempts <= 0:
            return 0.0
        return min(self.initial_backoff_s * (2.0 ** min(attempts - 1, 63)), self.max_backoff_s)

    def on_failure(self, key: str, attempt_move_seq: "int | None" = None) -> None:
        """AddUnschedulableIfNotPresent: the pod waits for an event —
        unless a move request fired during its attempt
        (``attempt_move_seq`` older than the current move_seq), in which
        case it re-enters backoffQ directly (upstream moveRequestCycle)."""
        now = self._clock()
        with self._lock:
            st = self._pods.get(key)
            if st is None:
                # the pod was forgotten mid-attempt (deleted while its
                # cycle ran) — do not resurrect a ghost entry
                return
            was_unsched = st.state == UNSCHEDULABLE
            self.mutation_seq += 1
            st.attempts += 1
            st.backoff_until = now + self.backoff_for(st.attempts)
            st.unschedulable_since = now
            if attempt_move_seq is not None and self.move_seq > attempt_move_seq:
                st.state = BACKOFF
                if was_unsched:
                    self._unschedulable -= 1
            else:
                st.state = UNSCHEDULABLE
                if not was_unsched:
                    self._unschedulable += 1

    def on_success(self, key: str) -> None:
        self.forget(key)

    # -------------------------------------------------------------- events

    def note_event(self, ev: Any) -> None:
        """Classify a cluster-store event; relevant ones move the
        unschedulable pods (runs synchronously from the store's emit —
        keep it allocation-light)."""
        if ev.kind == "pods":
            key = _pod_key(ev.obj)
            if ev.type == "ADDED":
                # tracking happens when the service considers the pod for
                # a round (_ready_pending) — pods created already bound or
                # owned by external schedulers must not become phantoms
                self.move_all()
            elif ev.type == "DELETED":
                self.forget(key)
                self.move_all()
            elif ev.type == "MODIFIED":
                if (ev.obj.get("spec") or {}).get("nodeName"):
                    self.forget(key)  # bound (by us or an external binder)
                if _scheduling_relevant_update(getattr(ev, "old_obj", None), ev.obj):
                    self.move_all()
        elif ev.kind == "nodes":
            self.move_all()

    def move_all(self) -> None:
        """MoveAllToActiveOrBackoffQueue: unschedulable pods re-enter
        backoff (or active when their backoff already expired)."""
        now = self._clock()
        with self._lock:
            self.move_seq += 1
            if not self._unschedulable:
                return
            for st in self._pods.values():
                if st.state == UNSCHEDULABLE:
                    st.state = BACKOFF if now < st.backoff_until else ACTIVE
                    self.moves += 1
                    self.mutation_seq += 1
            self._unschedulable = 0

    def flush_stuck(self) -> None:
        """flushUnschedulablePodsLeftover: pods stuck past the timeout
        move even without an event."""
        now = self._clock()
        with self._lock:
            if not self._unschedulable:
                return
            for st in self._pods.values():
                if (
                    st.state == UNSCHEDULABLE
                    and now - st.unschedulable_since >= self.unschedulable_timeout_s
                ):
                    st.state = BACKOFF if now < st.backoff_until else ACTIVE
                    self.flushes += 1
                    self.mutation_seq += 1
                    self._unschedulable -= 1

    # ---------------------------------------------------------------- pops

    def ready(self, ignore_backoff: bool = False) -> "set[str]":
        """Keys a scheduling round may attempt now: activeQ plus the
        backoffQ pods whose backoff expired (or all of backoffQ with
        ``ignore_backoff`` — the deterministic synchronous drain)."""
        now = self._clock()
        out: set[str] = set()
        with self._lock:
            for key, st in self._pods.items():
                if st.state == ACTIVE:
                    out.add(key)
                elif st.state == BACKOFF and (ignore_backoff or now >= st.backoff_until):
                    st.state = ACTIVE
                    self.mutation_seq += 1
                    out.add(key)
        return out

    def unschedulable_keys(self) -> "list[str]":
        """The pods currently parked in unschedulableQ (sorted) — part
        of the queue state every crash-recovery journal record carries
        (state/recovery.scheduler_meta_provider)."""
        with self._lock:
            return sorted(k for k, st in self._pods.items() if st.state == UNSCHEDULABLE)

    def state_snapshot(self) -> dict[str, list[str]]:
        """The per-pod queue states, sorted — rides on every journal
        record's meta so a recovered scheduler resumes with EXACTLY the
        crash-point queue: a fresh queue would re-attempt pods the
        uninterrupted run leaves parked, while a stale one would starve
        pods whose re-activating events are already durable (both were
        real byte divergences the crash harness caught)."""
        with self._lock:
            cached = self._snap_cache
            if cached is not None and cached[0] == self.mutation_seq:
                return cached[1]
            out: dict[str, list[str]] = {ACTIVE: [], BACKOFF: [], UNSCHEDULABLE: []}
            for k, st in self._pods.items():
                out[st.state].append(k)
            for lst in out.values():
                lst.sort()
            # cached + shared: consumers (the journal meta provider)
            # serialize it immediately and must not mutate it
            self._snap_cache = (self.mutation_seq, out)
            return out

    def restore_states(self, snapshot: "dict[str, Iterable[str]] | None") -> None:
        """Recovery: re-arm the journaled queue states.  Attempt counts
        and backoff deadlines are not restored (they only shape backoff
        durations, and the deterministic drains ignore backoff); the
        unschedulable timer restarts at recovery time, like any process
        restart."""
        if not snapshot:
            return
        now = self._clock()
        with self._lock:
            self.mutation_seq += 1
            for state in (ACTIVE, BACKOFF, UNSCHEDULABLE):
                for key in snapshot.get(state) or []:
                    st = self._pods.get(key)
                    if st is None:
                        st = self._pods[key] = _PodState()
                    elif st.state == UNSCHEDULABLE:
                        self._unschedulable -= 1
                    st.state = state
                    if state == UNSCHEDULABLE:
                        st.unschedulable_since = now
                        self._unschedulable += 1

    def has_unschedulable(self) -> bool:
        """Any pod parked in unschedulableQ right now?  O(1) — the
        streaming pipeline's overlap gate polls this at every wave
        boundary (a parked pod could be reactivated by the in-flight
        wave's commit events, so the boundary must serialize)."""
        with self._lock:
            return self._unschedulable > 0

    def next_wakeup_in(self) -> "float | None":
        """Seconds until the earliest backoff expiry (None = nothing
        waiting) — the background loop's sleep bound."""
        now = self._clock()
        with self._lock:
            deadlines = [
                st.backoff_until for st in self._pods.values() if st.state == BACKOFF
            ]
        if not deadlines:
            return None
        return max(0.0, min(deadlines) - now)

    def stats(self) -> dict[str, int]:
        with self._lock:
            counts = {ACTIVE: 0, BACKOFF: 0, UNSCHEDULABLE: 0}
            for st in self._pods.values():
                counts[st.state] += 1
            return {
                "queue_active": counts[ACTIVE],
                "queue_backoff": counts[BACKOFF],
                "queue_unschedulable": counts[UNSCHEDULABLE],
                "queue_moves": self.moves,
                "queue_flushes": self.flushes,
            }
