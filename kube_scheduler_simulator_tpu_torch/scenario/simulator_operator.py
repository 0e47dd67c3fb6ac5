"""KEP-159 Simulator operator: reconcile Simulator objects into live,
isolated simulator instances — and KEP-184 SchedulerSimulation objects
into finished comparative runs.

The reference designs (design-only; no controller ships) a `Simulator`
CRD whose controller creates a Pod running the whole simulator stack —
own kube-apiserver, scheduler, and simulator server on spec'd ports —
per object (reference keps/159-scheduler-simulator-operator/README.md:
40-120: SimulatorSpec.KubeAPIServerPort / SimulatorServerPort, phases
Pending → Creating → Available).  This build reconciles each Simulator
object into the in-process analog of that Pod: a fresh ``DIContainer``
(own ClusterStore + controllers + SchedulerService + scenario operator)
fronted by its own ``SimulatorServer`` (REST + kube ports).  The bound
ports land in ``.status`` so "other CRDs or controllers … get the
information for the simulator easily by accessing the Simulator
resource" (README.md:11-12).  Two Simulator objects are two fully
isolated clusters with their own per-store scenario run locks — their
scenarios run CONCURRENTLY, like the reference's one-Pod-per-Simulator
design.

`SchedulerSimulation` objects (KEP-184) are reconciled by the same loop
through :func:`run_scheduler_simulation` — the KEP's controller flow
(create simulator → run scenario → collect result → delete simulator →
Completed) collapsed onto ephemeral in-process instances.

Spec (``simulation.kube-scheduler-simulator.sigs.k8s.io/v1alpha1``,
kind ``Simulator``):

    spec:
      kubeAPIServerPort: 0      # optional; 0/absent = ephemeral
      simulatorServerPort: 0    # optional; 0/absent = ephemeral
      schedulerConfig: {...}    # optional KubeSchedulerConfiguration
      useBatch: auto|off|force  # optional

Status: ``phase`` (Creating/Available/Failed), bound
``kubeAPIServerPort``/``simulatorServerPort``, ``message`` on failure.
Deleting the object tears the instance down (the KEP's controller
deletes the Pod).

The port's copy of the JAX package's ``scenario/simulator_operator.py``.
Every instance and every comparative run takes the operator's ``device``
(the host container's: the card unless it was built with "cpu"), and the
worker thread makes that card its current device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

Obj = dict[str, Any]

_SIM_TERMINAL = {"Failed"}  # Available stays reconciled (idempotent)
_RUN_TERMINAL = {"Completed", "Failed"}


class _Instance:
    """One live simulator: DIContainer + its own HTTP servers."""

    def __init__(self, spec: Obj, device: Any = None):
        from kube_scheduler_simulator_tpu_torch.server import DIContainer, SimulatorServer

        self.di = DIContainer(
            initial_scheduler_cfg=spec.get("schedulerConfig"),
            use_batch=spec.get("useBatch", "auto"),
            seed=int(spec.get("seed") or 0),
            # the instance's own store holds no Simulator/
            # SchedulerSimulation CRs; a nested operator would be pure
            # thread overhead (and unbounded recursion bait)
            enable_simulator_operator=False,
            device=device,
        )
        try:
            self.server = SimulatorServer(
                self.di,
                port=int(spec.get("simulatorServerPort") or 0),
                kube_api_port=int(spec.get("kubeAPIServerPort") or 0),
            )
            self.server.start(background=True)
        except BaseException:
            # a bad port spec/bind failure must not leak the fully
            # booted container's threads and subscriptions
            self.di.close()
            raise

    def ports(self) -> Obj:
        return {
            "simulatorServerPort": self.server.port,
            "kubeAPIServerPort": self.server.kube_api_port,
        }

    def close(self) -> None:
        try:
            self.server.shutdown()
        finally:
            self.di.close()


class SimulatorOperator:
    """Reconciles ``simulators`` and ``schedulersimulations`` buckets of
    the HOST store (the "user's cluster" in KEP terms) — structured like
    ScenarioOperator: synchronous event bus → queue → one worker."""

    def __init__(self, cluster_store: Any, device: Any = None):
        self.store = cluster_store
        self.device = device
        self.instances: dict[tuple[str, str], _Instance] = {}
        self._queue: "queue.Queue[tuple[str, str, str, str] | tuple[None, int, None, None]]" = (
            queue.Queue()
        )
        self._thread: "threading.Thread | None" = None
        self._unsubscribe = None
        self._gen = 0
        self.reconciles = 0
        # guards `instances` + the stopping flag: a stop() that times out
        # waiting for a long reconcile must not race the still-draining
        # worker into creating instances nothing will ever close
        self._mu = threading.Lock()
        self._stopping = False

    # ---------------------------------------------------------------- wiring

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive() and self._unsubscribe is not None:
            return
        self._gen += 1
        with self._mu:
            self._stopping = False
        if self._unsubscribe is None:
            self._unsubscribe = self.store.subscribe(
                ["simulators", "schedulersimulations"], self._on_event
            )
        self._thread = threading.Thread(
            target=self._worker, args=(self._gen,), name="simulator-operator", daemon=True
        )
        self._thread.start()
        for kind in ("simulators", "schedulersimulations"):
            for obj in self.store.list(kind, copy_objects=False):
                self._enqueue(kind, "ADDED", obj)

    def stop(self) -> None:
        with self._mu:
            self._stopping = True
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None
        if self._thread is not None:
            self._queue.put((None, self._gen, None, None))
            self._thread.join(timeout=10)
            if not self._thread.is_alive():
                self._thread = None
            # a still-draining worker (long comparative run in flight)
            # sees _stopping and closes anything it creates itself
        with self._mu:
            insts = [i for i in self.instances.values() if i is not None]
            self.instances.clear()
        for inst in insts:
            inst.close()

    def wait_idle(self, timeout: float = 30.0) -> None:
        from kube_scheduler_simulator_tpu_torch.scenario.operator import wait_queue_idle

        wait_queue_idle(self._queue, timeout, "simulator operator")

    # -------------------------------------------------------------- reconcile

    def _on_event(self, ev: Any) -> None:
        self._enqueue(ev.kind, ev.type, ev.obj)

    def _enqueue(self, kind: str, ev_type: str, obj: Obj) -> None:
        meta = obj["metadata"]
        self._queue.put((kind, ev_type, meta.get("namespace", "default"), meta["name"]))

    def _worker(self, gen: int) -> None:
        if self.device is not None:
            import torch

            if torch.device(self.device).type == "cuda":
                torch.cuda.set_device(torch.device(self.device))
        while True:
            item = self._queue.get()
            try:
                if item[0] is None:
                    if item[1] >= gen:
                        return
                    continue
                kind, ev_type, ns, name = item
                if kind == "simulators":
                    self._reconcile_simulator(ev_type, ns, name)
                else:
                    self._reconcile_run(ev_type, ns, name)
                self.reconciles += 1
            finally:
                self._queue.task_done()

    def _patch_status(self, kind: str, ns: str, name: str, status: Obj) -> None:
        try:
            self.store.patch(kind, name, {"status": status}, ns)
        except KeyError:
            pass  # deleted meanwhile

    def _pop_instance(self, key: "tuple[str, str]") -> "_Instance | None":
        with self._mu:
            return self.instances.pop(key, None)

    def _reconcile_simulator(self, ev_type: str, ns: str, name: str) -> None:
        key = (ns, name)
        if ev_type == "DELETED":
            inst = self._pop_instance(key)
            if inst is not None:
                inst.close()
            return
        try:
            obj = self.store.get("simulators", name, ns)
        except KeyError:  # deleted before we got to it
            inst = self._pop_instance(key)
            if inst is not None:
                inst.close()
            return
        with self._mu:
            if self._stopping or key in self.instances:
                # shutting down / Available already (spec immutable, KEP) /
                # reserved by a concurrently-draining older worker
                return
            # reserve BEFORE building: after a timed-out stop() + restart
            # two workers can drain the same queue, and a check-then-
            # create outside the lock would build two instances for one
            # key, the dict overwrite leaking the first one's servers
            self.instances[key] = None
        if (obj.get("status") or {}).get("phase") in _SIM_TERMINAL:
            self._pop_instance(key)
            return
        self._patch_status("simulators", ns, name, {"phase": "Creating"})
        try:
            inst = _Instance(obj.get("spec") or {}, self.device)
        except Exception as e:
            self._pop_instance(key)
            self._patch_status(
                "simulators", ns, name,
                {"phase": "Failed", "message": f"{type(e).__name__}: {e}"},
            )
            return
        with self._mu:
            # keep only if the reservation survived (no stop(), no DELETE
            # raced the build) — else close what we just booted
            keep = not self._stopping and key in self.instances
            if keep:
                self.instances[key] = inst
            else:
                self.instances.pop(key, None)
        if not keep:
            inst.close()
            return
        self._patch_status("simulators", ns, name, {"phase": "Available", **inst.ports()})

    def _reconcile_run(self, ev_type: str, ns: str, name: str) -> None:
        if ev_type == "DELETED":
            return
        try:
            obj = self.store.get("schedulersimulations", name, ns)
        except KeyError:
            return
        if (obj.get("status") or {}).get("phase") in _RUN_TERMINAL:
            return
        with self._mu:
            if self._stopping:
                # runs queued behind a timed-out stop() must not keep
                # spawning nested containers into a torn-down host
                return
        from kube_scheduler_simulator_tpu_torch.scenario.simulation import now_rfc3339, run_scheduler_simulation

        # observable lifecycle (KEP-184 status): Running + startTime land
        # on the object BEFORE the (potentially minutes-long) run; the
        # Running-MODIFIED event re-enqueues, but by the time it drains
        # the phase is terminal and the reconcile no-ops.  Note the
        # single worker serializes runs behind Simulator reconciles —
        # KEP-184 runs are batch jobs; Simulator objects created during
        # one wait their turn.
        self._patch_status(
            "schedulersimulations", ns, name, {"phase": "Running", "startTime": now_rfc3339()}
        )
        finished = run_scheduler_simulation(obj, device=self.device)
        self._patch_status("schedulersimulations", ns, name, finished["status"])
