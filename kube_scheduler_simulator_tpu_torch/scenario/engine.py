"""The Scenario engine: deterministic step-driven replay.

Implements KEP-140's semantics (reference
keps/140-scenario-based-simulation/README.md):

- ``ScenarioOperation`` with ``id`` + ``step`` (MajorStep) and exactly one
  of ``createOperation`` / ``patchOperation`` / ``deleteOperation`` /
  ``doneOperation`` (README.md:117-174).
- Simulated time ``ScenarioStep {major, minor}``: Major advances when the
  controllers can no longer do anything with the current cluster state;
  Minor advances on every resource operation (README.md:176-183).
- Phases ``Pending/Running/Paused/Succeeded/Failed`` and per-step
  ``StepPhase`` transitions (README.md:214-256).
- ``ScenarioResult.Timeline``: map of MajorStep(string) → events, the
  user-defined operations plus generated PodScheduled / pod Delete events
  from the scheduler's work (README.md:261-313).
- Determinism rules: all resources are deleted at scenario start, and the
  run is driven synchronously — same Scenario, same result
  (README.md:600-610).

The "SimulationController" of the KEP maps to the scheduler service's
synchronous ``schedule_pending`` (TPU batch path included) plus the
controller manager's ``reconcile_all``; ControllerWaiter convergence is
detected when a full pass makes no progress (README.md:371-381).

Large replay steps ride the service's pipelined bulk-commit path: the
batch kernel runs in pod windows whose device execution overlaps the
previous window's host-side annotation commit, and each commit wave
lands through one store transaction (docs/batch-engine.md, "The commit
pipeline") — determinism is unaffected because windows chain the scan
carry exactly and commits stay in queue order.
"""

from __future__ import annotations

import copy
import threading
from typing import Any

from kube_scheduler_simulator_tpu_torch.scenario.result import allocation_rate, node_utilization
from kube_scheduler_simulator_tpu_torch.state.store import KIND_NAMES

Obj = dict[str, Any]

VERSION = "kube-scheduler-simulator-tpu/0.1.0"

_KIND_TO_STORE = {v: k for k, v in KIND_NAMES.items()}


class ScenarioError(Exception):
    pass


from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock


class ScenarioClock(SimClock):
    """Deterministic timeline clock for scenario replay — the historical
    name for :class:`~kube_scheduler_simulator_tpu_torch.utils.simclock.SimClock`
    in its service-clock role.

    Construct a SchedulerService with ``clock=ScenarioClock()`` and the
    scheduling queue's backoff AND every framework's Permit deadlines run
    on scenario time instead of ``time.monotonic()``: the engine advances
    it by ``spec.stepSeconds`` (default 1.0) per MajorStep boundary, so
    gang ``scheduleTimeoutSeconds`` expiry replays byte-deterministically
    — the same Scenario always expires the same waits at the same steps
    (KEP-140 determinism rules, README.md:600-610)."""


def _major_of(step: Any) -> int:
    """An operation's MajorStep — the KEP's ``step: {major: N}`` shape
    (README.md:176-183) or a bare int."""
    if isinstance(step, dict):
        return int(step.get("major") or 0)
    return int(step or 0)


def _store_kind(type_meta: "Obj | str") -> str:
    """Map a TypeMeta kind ("Pod") or store kind ("pods") to a store kind."""
    kind = type_meta.get("kind") if isinstance(type_meta, dict) else type_meta
    if kind in _KIND_TO_STORE:
        return _KIND_TO_STORE[kind]
    if kind in KIND_NAMES:
        return str(kind)
    raise ScenarioError(f"unknown resource kind {kind!r}")


class ScenarioEngine:
    # Per-STORE: a scenario run owns its cluster (KEP determinism —
    # concurrent operations are forbidden, README.md:600-610); the
    # operator's worker and the synchronous REST route of the same
    # simulator instance run under one lock so two runs can never
    # interleave wipes/replays.  Distinct simulator instances (KEP-159
    # Simulator objects, KEP-184 runs) have distinct stores and distinct
    # locks — their scenarios run CONCURRENTLY, like the reference's
    # one-Pod-per-Simulator design.  The lock LIVES ON the store object
    # (not in a registry keyed by id(store)): it dies with its store, so
    # ephemeral KEP-184 instances leak nothing and a recycled id can
    # never alias a dead store's lock.
    _RUN_LOCKS_MU = threading.Lock()

    @classmethod
    def run_lock_for(cls, store: Any) -> threading.RLock:
        lock = getattr(store, "_scenario_run_lock", None)
        if lock is None:
            with cls._RUN_LOCKS_MU:
                lock = getattr(store, "_scenario_run_lock", None)
                if lock is None:
                    lock = threading.RLock()
                    store._scenario_run_lock = lock
        return lock

    def __init__(self, cluster_store: Any, scheduler_service: Any, controller_manager: Any = None):
        self.store = cluster_store
        self.scheduler = scheduler_service
        self.controllers = controller_manager
        self.RUN_LOCK = self.run_lock_for(cluster_store)

    # ------------------------------------------------------------------ run

    def run(self, scenario: Obj) -> Obj:
        """Run a Scenario to completion; returns it with status filled."""
        scenario = copy.deepcopy(scenario)
        status: Obj = {
            "phase": "Running",
            "stepStatus": {"step": {"major": 0, "minor": 0}, "phase": "Operating"},
            "scenarioResult": {"simulatorVersion": VERSION, "timeline": {}},
        }
        scenario["status"] = status
        timeline: dict[str, list[Obj]] = status["scenarioResult"]["timeline"]

        # Determinism (README.md:600-610): the scenario owns the cluster —
        # pause the always-on scheduler loop (manual/concurrent operations
        # are forbidden during a scenario) and start from an empty state.
        with self.RUN_LOCK:
            was_background = self.scheduler.is_background_running()
            # the port's loop stops at its first exception and keeps it:
            # stop_background re-raises it here rather than the replay
            # running over a loop that died
            self.scheduler.stop_background()
            try:
                return self._run_steps(scenario, status, timeline)
            finally:
                if was_background:
                    self.scheduler.start_background()

    def _run_steps(self, scenario: Obj, status: Obj, timeline: dict) -> Obj:
        spec = scenario.get("spec") or {}
        # spec.pluginWeights: replay the scenario under a tuned plugin-
        # weight vector (the learned scoring head, tuning/) — applied for
        # exactly this run, then the PREVIOUS override (or the defaults)
        # is reinstated, so the knob is a pure function of the Scenario,
        # replays stay deterministic, and a live operator override
        # survives someone else's scenario run.
        plugin_weights = spec.get("pluginWeights")
        weights_applied = False
        prev_weights = None
        if plugin_weights is not None:
            try:
                prev_weights = getattr(self.scheduler, "_weights_requested", None)
                self.scheduler.set_plugin_weights(plugin_weights)
                weights_applied = True
            except Exception as e:
                status["phase"] = "Failed"
                status["message"] = f"spec.pluginWeights: {e}"
                return scenario
        try:
            return self._run_steps_inner(scenario, spec, status, timeline)
        finally:
            if weights_applied:
                self.scheduler.set_plugin_weights(prev_weights)

    def _run_steps_inner(self, scenario: Obj, spec: Obj, status: Obj, timeline: dict) -> Obj:
        # Wipe the simulated cluster but PRESERVE Scenario objects: they
        # are operator bookkeeping, not cluster resources — wiping them
        # would silently delete scenarios queued behind this run.  The
        # preserve happens atomically inside restore (a list-then-restore
        # snapshot would race scenarios created in the gap).
        # simulators / schedulersimulations are operator bookkeeping too
        # (KEP-159/184): wiping them would tear down live simulator
        # instances and abort queued comparative runs mid-scenario
        self.store.restore({}, preserve=("scenarios", "simulators", "schedulersimulations"))

        ops = list(spec.get("operations") or [])
        for op in ops:
            n_set = sum(
                1
                for f in ("createOperation", "patchOperation", "deleteOperation", "doneOperation")
                if op.get(f) is not None
            )
            if n_set != 1:
                status["phase"] = "Failed"
                status["message"] = f"operation {op.get('id')!r}: exactly one operation field must be set"
                return scenario

        by_major: dict[int, list[Obj]] = {}
        for op in ops:
            by_major.setdefault(_major_of(op.get("step", 0)), []).append(op)

        minor = 0
        done = False
        auto_id = 0
        # a scenario-timeline clock (ScenarioClock on the scheduler
        # service) advances per MajorStep: Permit deadlines — gang
        # scheduleTimeoutSeconds — expire on deterministic replay time
        clk = getattr(self.scheduler, "_clock", None)
        step_seconds = float(spec.get("stepSeconds") or 1.0)
        prev_major: "int | None" = None
        for major in sorted(by_major):
            if prev_major is not None and hasattr(clk, "advance"):
                # MajorSteps are a timeline: simulated time advances by
                # the major DELTA (a jump from major 1 to 4 is 3 steps)
                clk.advance((major - prev_major) * step_seconds)
            prev_major = major
            minor = 0
            events: list[Obj] = []
            timeline[str(major)] = events
            status["stepStatus"]["step"] = {"major": major, "minor": minor}
            status["stepStatus"]["phase"] = "Operating"
            for op in by_major[major]:
                try:
                    event, is_done = self._apply(op, major, minor)
                except Exception as e:
                    status["phase"] = "Failed"
                    status["message"] = f"operation {op.get('id')!r}: {e}"
                    return scenario
                if event is not None:
                    events.append(event)
                    minor += 1  # Minor advances on every resource operation
                    status["stepStatus"]["step"]["minor"] = minor
                done = done or is_done
            status["stepStatus"]["phase"] = "OperatingCompleted"

            # SimulationController runs until nothing changes
            # (ControllerWaiter convergence, README.md:371-381).
            status["stepStatus"]["phase"] = "ControllerRunning"
            generated = self._run_controllers_to_convergence(major, minor)
            for ev in generated:
                auto_id += 1
                ev["id"] = f"auto-{major}-{auto_id}"
                events.append(ev)
                minor += 1
            status["stepStatus"]["step"]["minor"] = minor
            status["stepStatus"]["phase"] = "Finished"
            if done:
                break

        status["phase"] = "Succeeded" if done else "Paused"
        # Result-calc summary (the KEP's result packages: allocation rate,
        # per-node utilization — README.md:553-565).
        status["scenarioResult"]["summary"] = {
            "allocationRate": allocation_rate(self.store),
            "nodeUtilization": node_utilization(self.store),
        }
        return scenario

    # ------------------------------------------------------------ internals

    def _apply(self, op: Obj, major: int, minor: int) -> "tuple[Obj | None, bool]":
        step = {"major": major, "minor": minor}
        oid = op.get("id", "")
        if op.get("doneOperation") is not None:
            return {"id": oid, "step": step, "done": {"operation": op["doneOperation"]}}, True
        if op.get("createOperation") is not None:
            create = op["createOperation"]
            obj = create.get("object") or {}
            # KEP shape carries TypeMeta beside the object; accept either
            kind = _store_kind(create.get("typeMeta") or obj)
            result = self.store.create(kind, obj)
            return {"id": oid, "step": step, "create": {"operation": create, "result": result}}, False
        if op.get("patchOperation") is not None:
            patch = op["patchOperation"]
            kind = _store_kind(patch.get("typeMeta") or {})
            meta = patch.get("objectMeta") or {}
            body = patch.get("patch")
            if isinstance(body, str):
                import json

                body = json.loads(body)
            result = self.store.patch(kind, meta.get("name", ""), body, meta.get("namespace"))
            return {"id": oid, "step": step, "patch": {"operation": patch, "result": result}}, False
        delete = op["deleteOperation"]
        kind = _store_kind(delete.get("typeMeta") or {})
        meta = delete.get("objectMeta") or {}
        self.store.delete(kind, meta.get("name", ""), meta.get("namespace"))
        return {"id": oid, "step": step, "delete": {"operation": delete}}, False

    def _run_controllers_to_convergence(self, major: int, minor: int) -> list[Obj]:
        """Run controllers + scheduler until quiescent; emit generated
        timeline events (PodScheduled, preemption-victim Delete, and —
        with the capacity engine enabled — Autoscale actions).

        The autoscaler joins the convergence loop exactly like the KEP's
        SimulationController members: when a scheduling pass makes no
        progress, one autoscaler pass runs; if it acted (nodes added or
        drained), the loop continues — the node events re-activated the
        unschedulable pods — and only a pass where BOTH are quiescent
        ends the step.  Actions are deterministic functions of cluster
        state (docs/autoscaler.md), so replays stay byte-identical."""
        events: list[Obj] = []
        before = {
            f"{p['metadata'].get('namespace', 'default')}/{p['metadata']['name']}": (p.get("spec") or {}).get("nodeName")
            for p in self.store.list("pods")
        }
        get_asc = getattr(self.scheduler, "scenario_autoscaler", None)
        autoscaler = get_asc() if get_asc is not None else None
        if autoscaler is not None:
            # actions from outside this step must not leak into its timeline
            autoscaler.drain_events()
        for _ in range(50):
            if self.controllers is not None:
                self.controllers.reconcile_all()
            results = self.scheduler.schedule_pending(max_rounds=1) if self.scheduler.framework else {}
            progressed = any(r.success or r.nominated_node for r in results.values())
            if self.controllers is not None:
                self.controllers.reconcile_all()
            if not progressed:
                if autoscaler is not None and autoscaler.run_once()["actions"]:
                    continue
                break
        after_pods = self.store.list("pods")
        after = {
            f"{p['metadata'].get('namespace', 'default')}/{p['metadata']['name']}": p for p in after_pods
        }
        m = minor
        # Autoscale actions first: the capacity they added/drained is what
        # the PodScheduled events below landed on.
        if autoscaler is not None:
            for act in autoscaler.drain_events():
                events.append(
                    {"step": {"major": major, "minor": m}, "autoscale": act}
                )
                m += 1
        for key, pod in after.items():
            node = (pod.get("spec") or {}).get("nodeName")
            if node and before.get(key) != node:
                events.append(
                    {
                        "step": {"major": major, "minor": m},
                        "podScheduled": {"result": pod},
                    }
                )
                m += 1
        for key, old_node in before.items():
            if key not in after:  # deleted during the step (preemption victim)
                ns, name = key.split("/", 1)
                events.append(
                    {
                        "step": {"major": major, "minor": m},
                        "delete": {
                            "operation": {
                                "typeMeta": {"kind": "Pod", "apiVersion": "v1"},
                                "objectMeta": {"name": name, "namespace": ns},
                            }
                        },
                    }
                )
                m += 1
        return events
