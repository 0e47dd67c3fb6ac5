"""The Scenario operator: reconcile Scenario objects into finished runs.

The reference scaffolds Scenario as a CRD + controller but
leaves ``Reconcile`` empty (reference
scenario/controllers/scenario_controller.go:48-55; CRD scaffold
scenario/api/v1alpha1/scenario_types.go:27-64).  This operator implements
that reconcile against KEP-140 semantics: a Scenario object created
through the store — REST, kube-API port (``/apis/simulation.…/v1alpha1/
namespaces/{ns}/scenarios``), or a client library — is picked up by a
worker, run to completion on the deterministic ScenarioEngine, and
written back with ``.status`` (phase, stepStatus, scenarioResult with the
per-MajorStep timeline).

Lifecycle notes:

- Reconciles are queued from the store's synchronous event bus and run on
  a dedicated worker thread — a scenario run mutates the whole store
  (KEP determinism: all resources are deleted at scenario start,
  README.md:600-610), which must never happen inside an event callback.
- The scenario wipe preserves Scenario OBJECTS in place, atomically
  (they are the operator's bookkeeping, not simulated cluster resources
  — ``store.restore(preserve=("scenarios",))``), so concurrently created
  scenarios survive an in-flight run and get their turn.  Results write
  back as ``.status``; terminal phases (Succeeded / Failed / Paused) are
  never auto-re-run, so the status write does not loop.
- Scenario runs serialize on the per-store run lock
  (``ScenarioEngine.run_lock_for(store)``) — the synchronous
  ``POST /api/v1/scenarios`` route of the same instance shares it, so an
  operator reconcile and a REST run can never interleave their
  wipes/replays; DISTINCT simulator instances (KEP-159) run
  concurrently.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

from kube_scheduler_simulator_tpu_torch.scenario.engine import ScenarioEngine

Obj = dict[str, Any]

# Paused is terminal FOR THE OPERATOR: the KEP pauses a scenario awaiting
# user action; auto-re-running it would wipe and replay the cluster in a
# hot loop (each reconcile's write re-triggering the next).
_TERMINAL_PHASES = {"Succeeded", "Failed", "Paused"}


def wait_queue_idle(q: "queue.Queue", timeout: float, what: str) -> None:
    """Poll a reconcile queue until drained (shared by the queue-driven
    operators' ``wait_idle``)."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if q.unfinished_tasks == 0:
            return
        time.sleep(0.01)
    raise TimeoutError(f"{what} still busy")


class ScenarioOperator:
    def __init__(self, cluster_store: Any, scheduler_service: Any, controller_manager: Any = None):
        self.store = cluster_store
        self.engine = ScenarioEngine(cluster_store, scheduler_service, controller_manager)
        self._queue: "queue.Queue[tuple[str, str] | tuple[None, int]]" = queue.Queue()
        self._thread: "threading.Thread | None" = None
        self._unsubscribe = None
        # start-generation counter: stop() enqueues a generation-tagged
        # sentinel, and a worker only honors sentinels of ITS OWN (or a
        # later) generation — a stale sentinel left by a timed-out or
        # repeated stop() can never kill a freshly started worker
        self._gen = 0
        self.runs = 0  # observability: completed reconciles since start

    # ---------------------------------------------------------------- wiring

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive() and self._unsubscribe is not None:
            return  # already running and subscribed
        # a previous stop() may have timed out mid-run (worker still
        # draining) or the worker may have exited at its sentinel — either
        # way a NEW generation takes over; the old worker (if any) ignores
        # everything once it sees a sentinel of its own generation
        self._gen += 1
        if self._unsubscribe is None:
            self._unsubscribe = self.store.subscribe(["scenarios"], self._on_event)
        self._thread = threading.Thread(
            target=self._worker, args=(self._gen,), name="scenario-operator", daemon=True
        )
        self._thread.start()
        # adopt scenarios that existed before the operator started
        for obj in self.store.list("scenarios", copy_objects=False):
            if self._should_run(obj):
                self._enqueue(obj)

    def stop(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None
        if self._thread is not None:
            self._queue.put((None, self._gen))
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                # a long scenario replay is still in flight: keep the
                # thread reference; this worker exits at the sentinel when
                # the run ends, and a later start() begins a new
                # generation whose worker ignores stale sentinels
                return
            self._thread = None

    def wait_idle(self, timeout: float = 30.0) -> None:
        """Block until every queued reconcile finished (tests)."""
        wait_queue_idle(self._queue, timeout, "scenario operator")

    # -------------------------------------------------------------- reconcile

    @staticmethod
    def _should_run(obj: Obj) -> bool:
        phase = (obj.get("status") or {}).get("phase")
        return phase not in _TERMINAL_PHASES

    def _on_event(self, ev: Any) -> None:
        if ev.type in ("ADDED", "MODIFIED") and self._should_run(ev.obj):
            self._enqueue(ev.obj)

    def _enqueue(self, obj: Obj) -> None:
        meta = obj["metadata"]
        self._queue.put((meta.get("namespace", "default"), meta["name"]))

    def _worker(self, gen: int) -> None:
        while True:
            item = self._queue.get()
            try:
                if item[0] is None:
                    if item[1] >= gen:
                        return
                    continue  # stale sentinel from an older generation
                ns, name = item
                try:
                    obj = self.store.get("scenarios", name, ns)
                except KeyError:
                    continue  # deleted (or wiped by an earlier run) meanwhile
                if not self._should_run(obj):
                    continue
                # run AND status write-back under THIS STORE's run lock: a
                # concurrent run starting between them could observe the
                # scenario without its terminal status
                with self.engine.RUN_LOCK:
                    try:
                        finished = self.engine.run(obj)
                    except Exception as e:  # scenario bug: record the failure
                        finished = dict(obj)
                        finished["status"] = {"phase": "Failed", "message": f"{type(e).__name__}: {e}"}
                    # the run wiped the simulated cluster but PRESERVED
                    # Scenario objects — write the result back as .status
                    try:
                        self.store.patch("scenarios", name, {"status": finished["status"]}, ns)
                    except KeyError:
                        pass  # deleted while running
                self.runs += 1
            finally:
                self._queue.task_done()
