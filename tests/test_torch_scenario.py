"""The port's scenario engine, controllers and operator against the JAX
package's.

Each case runs the same objects, in the same order, through both packages:
the JAX package in float64 (scoped per test), the port on the CPU
(``device="cpu"``: the plain versions stand in for the kernels), both with
their store clocks pinned by ``SimClock``.  The returned Scenario
(``json.dumps(..., sort_keys=True)``), the store's ``dump()`` and every
pod's ``pod_parity_state`` must be byte-equal.  The cases follow
tests/test_controllers_scenario.py (the controllers and the engine),
tests/test_scenario_operator.py (the operator cases that need no kube API),
the autoscale scenario of tests/test_autoscaler.py and the
``spec.pluginWeights`` cases of tests/test_tuning.py; scheduling cases run
with ``use_batch`` "off" and "auto" (``batch_min_work=0``).  Then the port's
own contract: cfg11-scenario at a cut, a replay over a restored store taking
a full encode and a fresh upload, a convergence pass with nothing pending
launching no scan, and the engine's handling of the background loop (the
port's loop keeps its first exception for ``stop_background`` to re-raise).
"""

from __future__ import annotations

import functools
import json
import sys
import time
import types
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tests.test_autoscaler import _autoscale_scenario  # noqa: E402
from tests.test_batch_parity import profile_with  # noqa: E402
from tests.test_scenario_operator import mk_scenario  # noqa: E402
from tests.test_tuning import PLUGINS, _cluster, mk_pod as tune_pod  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops.kernels import KernelBuildError  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state  # noqa: E402

T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def package(name: str) -> types.SimpleNamespace:
    """The classes a case needs, from the port (on the CPU) or the JAX
    package."""
    if name == "port":
        from kube_scheduler_simulator_tpu_torch.controllers import ControllerManager
        from kube_scheduler_simulator_tpu_torch.scenario import ScenarioEngine, ScenarioOperator, allocation_rate
        from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
        from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
        from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

        service = functools.partial(SchedulerService, device="cpu")
    else:
        from kube_scheduler_simulator_tpu.controllers import ControllerManager
        from kube_scheduler_simulator_tpu.scenario import ScenarioEngine, ScenarioOperator, allocation_rate
        from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService
        from kube_scheduler_simulator_tpu.state.store import ClusterStore
        from kube_scheduler_simulator_tpu.utils.simclock import SimClock

        service = SchedulerService
    return types.SimpleNamespace(
        name=name, Store=ClusterStore, Service=service, Engine=ScenarioEngine, CM=ControllerManager,
        Operator=ScenarioOperator, Clock=SimClock, allocation_rate=allocation_rate,
    )


PORT, JAX = package("port"), package("jax")


def dumped(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def assert_same_bytes(what: str, got: str, want: str) -> None:
    """Equal strings; a difference is reported by its offset (the texts run
    to megabytes, too long for a diff)."""
    if got != want:
        at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        raise AssertionError(f"{what}: lengths {len(got)} / {len(want)}, first difference at {at}: "
                             f"{got[max(at - 80, 0):at + 80]!r} vs {want[max(at - 80, 0):at + 80]!r}")


def assert_same_run(got: tuple, want: tuple) -> None:
    """(returned Scenario or None, store) of the port against the JAX
    package's: the Scenario, the store's dump and the pod states byte-equal."""
    (scn_p, store_p), (scn_j, store_j) = got, want
    if scn_j is not None:
        assert_same_bytes("returned Scenario", dumped(scn_p), dumped(scn_j))
    assert_same_bytes("store dump", dumped(store_p.dump()), dumped(store_j.dump()))
    assert_same_bytes("pod states", dumped(pod_parity_state(store_p)), dumped(pod_parity_state(store_j)))


def _node(name: str, cpu: str = "8") -> dict:
    return {"kind": "Node", "metadata": {"name": name},
            "status": {"allocatable": {"cpu": cpu, "memory": "16Gi", "pods": "110"}}}


def _deployment(name: str, replicas: int, app: str, cpu: "str | None" = None) -> dict:
    container = {"name": "c"}
    if cpu:
        container["resources"] = {"requests": {"cpu": cpu}}
    return {
        "metadata": {"name": name},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {"app": app}},
            "template": {"metadata": {"labels": {"app": app}}, "spec": {"containers": [container]}},
        },
    }


# ----------------------------------------------------------- controllers
# tests/test_controllers_scenario.py's controller cases, each a function of
# the package: it runs the case with the reference's assertions and returns
# its store

def deployment_creates_replicaset_and_pods(P):
    store = P.Store(clock=P.Clock(T0))
    cm = P.CM(store)
    cm.start()
    store.create("deployments", _deployment("web", 3, "web", cpu="100m"))
    rs = store.list("replicasets")
    assert len(rs) == 1 and rs[0]["spec"]["replicas"] == 3
    pods = store.list("pods")
    assert len(pods) == 3 and all(p["metadata"]["labels"] == {"app": "web"} for p in pods)
    assert all(p["metadata"]["ownerReferences"][0]["kind"] == "ReplicaSet" for p in pods)
    store.patch("deployments", "web", {"spec": {"replicas": 1}})
    assert len(store.list("pods")) == 1
    store.patch("deployments", "web", {"spec": {"replicas": 2}})
    assert len(store.list("pods")) == 2
    cm.stop()
    return store


def cascade_gc_on_observed_deletion_only(P):
    store = P.Store(clock=P.Clock(T0))
    cm = P.CM(store)
    cm.start()
    store.create("persistentvolumeclaims", {"metadata": {"name": "claim"}, "spec": {"storageClassName": "none"}})
    store.create("pods", {
        "metadata": {"name": "imported",
                     "ownerReferences": [{"kind": "ReplicaSet", "uid": "never-seen-uid", "controller": True}]},
        "spec": {"containers": [{"name": "c"}]},
    })
    store.create("deployments", _deployment("web", 2, "web"))
    assert len(store.list("replicasets")) == 1
    store.delete("deployments", "web")
    cm.reconcile_all()
    assert store.list("replicasets") == []
    assert [p["metadata"]["name"] for p in store.list("pods")] == ["imported"]
    cm.stop()
    return store


def surplus_owned_pod_triggers_scale_down(P):
    store = P.Store(clock=P.Clock(T0))
    cm = P.CM(store)
    cm.start()
    rs = _deployment("rs", 2, "a")
    rs["metadata"]["labels"] = {"app": "a"}
    store.create("replicasets", rs)
    assert len(store.list("pods")) == 2
    rs_uid = store.list("replicasets")[0]["metadata"]["uid"]
    store.create("pods", {
        "metadata": {"name": "extra", "labels": {"app": "a"},
                     "ownerReferences": [{"kind": "ReplicaSet", "name": "rs", "uid": rs_uid, "controller": True}]},
        "spec": {"containers": [{"name": "c"}]},
    })
    assert len(store.list("pods")) == 2
    cm.stop()
    return store


def pv_controller_binds_claims(P):
    store = P.Store(clock=P.Clock(T0))
    cm = P.CM(store)
    for name, size in (("pv-big", "100Gi"), ("pv-small", "10Gi")):
        store.create("persistentvolumes", {"metadata": {"name": name}, "spec": {
            "capacity": {"storage": size}, "accessModes": ["ReadWriteOnce"], "storageClassName": "fast"}})
    store.create("persistentvolumeclaims", {"metadata": {"name": "claim"}, "spec": {
        "storageClassName": "fast", "accessModes": ["ReadWriteOnce"], "resources": {"requests": {"storage": "5Gi"}}}})
    cm.reconcile_all()
    pvc = store.get("persistentvolumeclaims", "claim")
    assert pvc["spec"]["volumeName"] == "pv-small" and pvc["status"]["phase"] == "Bound"
    pv = store.get("persistentvolumes", "pv-small")
    assert pv["status"]["phase"] == "Bound" and pv["spec"]["claimRef"]["uid"] == pvc["metadata"]["uid"]
    return store


def restore_empties_cluster_despite_controllers(P):
    store = P.Store(clock=P.Clock(T0))
    cm = P.CM(store)
    cm.start()
    store.create("deployments", _deployment("web", 3, "web"))
    assert len(store.list("pods")) == 3
    store.restore({})
    assert store.list("pods") == [] and store.list("replicasets") == [] and store.list("deployments") == []
    store.create("deployments", _deployment("web2", 2, "w2"))
    assert len(store.list("pods")) == 2
    store.delete("deployments", "web2")
    assert store.list("pods") == [] and store.list("replicasets") == []
    cm.stop()
    return store


def specless_deployment_and_name_collisions(P):
    store = P.Store(clock=P.Clock(T0))
    cm = P.CM(store)
    cm.start()
    store.create("deployments", {"metadata": {"name": "bare"}})
    store.create("pods", {"metadata": {"name": "web-rs-0"}, "spec": {}})
    store.create("deployments", _deployment("web", 2, "web"))
    owned = [p for p in store.list("pods")
             if p["metadata"].get("ownerReferences") and p["metadata"]["name"].startswith("web-rs-")]
    assert len(owned) == 2
    assert store.get("pods", "web-rs-0")["metadata"].get("ownerReferences") is None
    assert store.get("pods", "bare-rs-0")
    cm.stop()
    return store


CONTROLLER_CASES = {f.__name__: f for f in (
    deployment_creates_replicaset_and_pods, cascade_gc_on_observed_deletion_only,
    surplus_owned_pod_triggers_scale_down, pv_controller_binds_claims,
    restore_empties_cluster_despite_controllers, specless_deployment_and_name_collisions,
)}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_case_matches_the_reference(case):
    assert_same_run((None, CONTROLLER_CASES[case](PORT)), (None, CONTROLLER_CASES[case](JAX)))


# --------------------------------------------------------------- scenario

def build_engine(P, use_batch: str, controllers: bool = True, **svc_kw):
    store = P.Store(clock=P.Clock(T0))
    svc = P.Service(store, tie_break="first", use_batch=use_batch, batch_min_work=0, clock=P.Clock(0.0), **svc_kw)
    svc.start_scheduler(None)
    return store, svc, P.Engine(store, svc, P.CM(store) if controllers else None)


def _ops(ops: list) -> dict:
    return {"metadata": {"name": "s1"}, "spec": {"operations": ops}}


def _pod_op(step: int, name: str, cpu: str = "1") -> dict:
    return {"id": f"op-{name}", "step": step, "createOperation": {"object": {
        "metadata": {"name": name, "namespace": "default"}, "kind": "Pod",
        "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]}}}}


def steps_schedule_and_timeline(P, use_batch):
    store, _svc, engine = build_engine(P, use_batch)
    store.create("nodes", _node("stale-node"))
    out = engine.run(_ops([
        {"id": "op1", "step": 1, "createOperation": {"object": _node("node-1")}},
        _pod_op(2, "p1"),
        {"id": "op3", "step": 3, "doneOperation": {}},
    ]))
    status = out["status"]
    assert status["phase"] == "Succeeded"
    timeline = status["scenarioResult"]["timeline"]
    assert set(timeline) == {"1", "2", "3"}
    assert [n["metadata"]["name"] for n in store.list("nodes")] == ["node-1"]
    assert [next(k for k in ev if k not in ("id", "step")) for ev in timeline["2"]] == ["create", "podScheduled"]
    assert status["scenarioResult"]["summary"]["allocationRate"] == 1.0
    return out, store


def deployment_and_patch(P, use_batch):
    store, _svc, engine = build_engine(P, use_batch)
    dep = _deployment("web", 2, "w", cpu="100m")
    dep["kind"] = "Deployment"
    dep["metadata"]["namespace"] = "default"
    out = engine.run(_ops([
        {"id": "n", "step": 1, "createOperation": {"object": _node("node-1")}},
        {"id": "d", "step": 1, "createOperation": {"object": dep}},
        {"id": "scale", "step": 2, "patchOperation": {
            "typeMeta": {"kind": "Deployment"}, "objectMeta": {"name": "web", "namespace": "default"},
            "patch": '{"spec": {"replicas": 4}}'}},
        {"id": "done", "step": 3, "doneOperation": {}},
    ]))
    assert out["status"]["phase"] == "Succeeded", out["status"]
    pods = store.list("pods")
    assert len(pods) == 4 and all(p["spec"].get("nodeName") == "node-1" for p in pods)
    assert P.allocation_rate(store) == 1.0
    t = out["status"]["scenarioResult"]["timeline"]
    assert sum("podScheduled" in ev for ev in t["1"]) == 2 and sum("podScheduled" in ev for ev in t["2"]) == 2
    return out, store


def invalid_operation_fails(P, use_batch):
    store, _svc, engine = build_engine(P, use_batch)
    out = engine.run(_ops([{"id": "bad", "step": 1}]))
    assert out["status"]["phase"] == "Failed" and "exactly one" in out["status"]["message"]
    return out, store


def without_done_pauses(P, use_batch):
    store, _svc, engine = build_engine(P, use_batch)
    out = engine.run(_ops([{"id": "n", "step": 1, "createOperation": {"object": _node("n1")}}]))
    assert out["status"]["phase"] == "Paused"
    return out, store


def unschedulable_pods_stay_pending(P, use_batch):
    """A step whose pods do not all fit: the convergence pass records the
    failures (sequential PostFilter in "auto") and the summary's rate."""
    store, _svc, engine = build_engine(P, use_batch)
    out = engine.run(_ops(
        [{"id": "n", "step": 1, "createOperation": {"object": _node("node-1", cpu="2")}}]
        + [_pod_op(2, f"p{i}", cpu="700m") for i in range(4)]
        + [{"id": "done", "step": 3, "doneOperation": {}}]
    ))
    assert out["status"]["phase"] == "Succeeded"
    assert out["status"]["scenarioResult"]["summary"]["allocationRate"] == 0.5
    return out, store


SCENARIO_CASES = {f.__name__: f for f in (
    steps_schedule_and_timeline, deployment_and_patch, invalid_operation_fails, without_done_pauses,
    unschedulable_pods_stay_pending,
)}


@pytest.mark.parametrize("use_batch", ["off", "auto"])
@pytest.mark.parametrize("case", sorted(SCENARIO_CASES))
def test_scenario_case_matches_the_reference(case, use_batch):
    assert_same_run(SCENARIO_CASES[case](PORT, use_batch), SCENARIO_CASES[case](JAX, use_batch))


@pytest.mark.parametrize("use_batch", ["off", "auto"])
def test_cfg11_scenario_cut_matches_the_reference(use_batch):
    """cfg11-scenario (``workloads.scenario_churn``) at a cut: 40 nodes, 200
    bench pods over 5 majors, a Deployment of 6 then 12 replicas, deletes by
    name and a rolling cordon of 3 nodes.  Every created pod binds, the
    timeline holds one podScheduled a binding and one delete an operation,
    and both packages leave the same bytes."""
    scn = workloads.scenario_churn(40, 200, 5, web=6, cordon=3)
    runs = []
    for P in (PORT, JAX):
        store, svc, engine = build_engine(P, use_batch)
        out = engine.run(scn)
        runs.append((out, store))
        assert out["status"]["phase"] == "Succeeded", out["status"]
        tl = out["status"]["scenarioResult"]["timeline"]
        pods = store.list("pods")
        assert len(pods) == 200 - 4 * 4 + 12 and all(p["spec"].get("nodeName") for p in pods)
        assert sum("podScheduled" in ev for evs in tl.values() for ev in evs) == 200 + 12
        assert sum("delete" in ev for evs in tl.values() for ev in evs) == 4 * 4
        assert not svc.stats["batch_fallbacks"]
        if use_batch == "auto":
            assert svc.stats["batch_pods"] == 212 and svc.stats["sequential_pods"] == 0
    assert_same_run(*runs)


# --------------------------------------------------------------- operator

def operator_reconciles_created_scenario(P):
    store = P.Store(clock=P.Clock(T0))
    svc = P.Service(store, tie_break="first", clock=P.Clock(0.0))
    svc.start_scheduler(None)
    op = P.Operator(store, svc)
    op.start()
    try:
        store.create("scenarios", mk_scenario())
        op.wait_idle()
        status = store.get("scenarios", "scn-1", "default")["status"]
        assert status["phase"] == "Succeeded", status
        assert any("podScheduled" in ev for evs in status["scenarioResult"]["timeline"].values() for ev in evs)
        assert op.runs == 1
        store.patch("scenarios", "scn-1", {"metadata": {"labels": {"touched": "yes"}}}, "default")
        op.wait_idle()
        assert op.runs == 1
    finally:
        op.stop()
    return store


def paused_scenario_runs_once_and_sibling_survives_wipe(P):
    store = P.Store(clock=P.Clock(T0))
    svc = P.Service(store, tie_break="first", clock=P.Clock(0.0))
    svc.start_scheduler(None)
    op = P.Operator(store, svc)
    op.start()
    try:
        paused = mk_scenario("scn-paused")
        paused["spec"]["operations"] = paused["spec"]["operations"][:2]
        store.create("scenarios", paused)
        store.create("scenarios", mk_scenario("scn-after"))
        op.wait_idle()
        time.sleep(0.2)
        op.wait_idle()
        assert store.get("scenarios", "scn-paused", "default")["status"]["phase"] == "Paused"
        assert store.get("scenarios", "scn-after", "default")["status"]["phase"] == "Succeeded"
        assert op.runs == 2, op.runs
    finally:
        op.stop()
    return store


def generate_name_determinism_across_replays(P):
    store = P.Store(clock=P.Clock(T0))
    svc = P.Service(store, tie_break="first", clock=P.Clock(0.0))
    svc.start_scheduler(None)
    engine = P.Engine(store, svc)
    scn = {"metadata": {"name": "scn-gen", "namespace": "default"}, "spec": {"operations": [
        {"id": "1", "step": {"major": 1}, "createOperation": {"typeMeta": {"kind": "Node"}, "object": {
            "metadata": {"generateName": "node-"},
            "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "110"}}}}},
        {"id": "2", "step": {"major": 2}, "doneOperation": {}},
    ]}}
    engine.run(scn)
    first = sorted(n["metadata"]["name"] for n in store.list("nodes"))
    store.create("pods", {"metadata": {"generateName": "noise-", "namespace": "default"}, "spec": {}})
    engine.run(scn)
    assert sorted(n["metadata"]["name"] for n in store.list("nodes")) == first
    return store


OPERATOR_CASES = {f.__name__: f for f in (
    operator_reconciles_created_scenario, paused_scenario_runs_once_and_sibling_survives_wipe,
    generate_name_determinism_across_replays,
)}


@pytest.mark.parametrize("case", sorted(OPERATOR_CASES))
def test_operator_case_matches_the_reference(case):
    assert_same_run((None, OPERATOR_CASES[case](PORT)), (None, OPERATOR_CASES[case](JAX)))


def test_a_failed_run_is_recorded_on_the_scenario():
    """The operator's worker records a run that raised as ``phase: Failed``
    with the exception's message, as the reference does (here a kernel
    library that fails to load at the port's launch: the error a round never
    degrades)."""
    store = PORT.Store(clock=PORT.Clock(T0))
    svc = PORT.Service(store, tie_break="first", use_batch="auto", batch_min_work=0, clock=PORT.Clock(0.0))
    svc.start_scheduler(None)
    op = PORT.Operator(store, svc)
    real = TB.build_batch_fn

    def failing(*a, **kw):
        def fn(*args):
            raise KernelBuildError("injected launch error")
        return fn

    TB.build_batch_fn = failing
    try:
        op.start()
        store.create("scenarios", mk_scenario())
        op.wait_idle()
    finally:
        TB.build_batch_fn = real
        op.stop()
    status = store.get("scenarios", "scn-1", "default")["status"]
    assert status == {"phase": "Failed", "message": "KernelBuildError: injected launch error"}


# ------------------------------------------------- autoscaler and weights

def autoscale_scenario(P, autoscale: str):
    store = P.Store(clock=lambda: 0.0)
    svc = P.Service(store, tie_break="first", use_batch="off", autoscale=autoscale,
                    autoscaler_opts={"expander": "least-waste"})
    svc.start_scheduler(None)
    return P.Engine(store, svc, None).run(_autoscale_scenario()), store


def test_scenario_replay_with_autoscaler_matches_the_reference():
    """tests/test_autoscaler.py's acceptance case under
    ``autoscale="scenario"``: the timeline carries the autoscaler's
    scale-up (estimated through the lane scan), every pod lands on the new
    capacity, and two port replays and the reference's are byte-equal."""
    a, b = autoscale_scenario(PORT, "scenario"), autoscale_scenario(PORT, "scenario")
    assert a[0]["status"]["phase"] == "Succeeded"
    tl = a[0]["status"]["scenarioResult"]["timeline"]
    events = [ev for evs in tl.values() for ev in evs if "autoscale" in ev]
    assert events and events[0]["autoscale"]["action"] == "ScaleUp" and events[0]["autoscale"]["nodeGroup"] == "pool"
    assert events[0]["autoscale"]["method"] == "xla-batch"
    assert {"major", "minor"} <= set(events[0]["step"])
    assert a[0]["status"]["scenarioResult"]["summary"]["allocationRate"] == 1.0
    assert_same_bytes("two port replays", dumped(a[0]), dumped(b[0]))
    assert_same_run(a, autoscale_scenario(JAX, "scenario"))


def test_scenario_mode_off_keeps_autoscaler_out():
    got = autoscale_scenario(PORT, "off")
    tl = got[0]["status"]["scenarioResult"]["timeline"]
    assert not [ev for evs in tl.values() for ev in evs if "autoscale" in ev]
    assert got[0]["status"]["scenarioResult"]["summary"]["allocationRate"] == 0.0
    assert_same_run(got, autoscale_scenario(JAX, "off"))


def tuned_service(P, mode: str, n_nodes: int):
    store = P.Store(clock=P.Clock(T0))
    for n in _cluster(n_nodes):
        store.create("nodes", n)
    svc = P.Service(store, tie_break="first", use_batch=mode, batch_min_work=0)
    svc.start_scheduler({"profiles": [profile_with(PLUGINS)], "percentageOfNodesToScore": 100})
    return store, svc


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_scenario_plugin_weights_knob_applies_and_restores(mode):
    """tests/test_tuning.py's knob case: the run uses the scenario's weights,
    the override is gone afterwards, and a bad vector fails the run."""
    ops = [{"id": "1", "step": {"major": 1}, "createOperation": {
        "typeMeta": {"kind": "Pod"}, "object": tune_pod("sc-pod-0", cpu_m=100, mem_mi=128)}},
        {"id": "2", "step": {"major": 2}, "doneOperation": {}}]
    runs = []
    for P in (PORT, JAX):
        store, svc = tuned_service(P, mode, 6)
        engine = P.Engine(store, svc, None)
        out = engine.run({"metadata": {"name": "tuned-run", "namespace": "default"},
                          "spec": {"operations": ops, "pluginWeights": [1, 3.5, 1]}})
        assert out["status"]["phase"] == "Succeeded", out["status"]
        assert svc.plugin_weights() is None
        bad = engine.run({"metadata": {"name": "bad-run", "namespace": "default"},
                          "spec": {"operations": ops, "pluginWeights": [1, -1]}})
        assert bad["status"]["phase"] == "Failed" and "pluginWeights" in bad["status"]["message"]
        runs.append(((out, bad), store))
    assert_same_run(*runs)


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_scenario_restores_preexisting_override(mode):
    ops = [{"id": "1", "step": {"major": 1}, "doneOperation": {}}]
    runs = []
    for P in (PORT, JAX):
        store, svc = tuned_service(P, mode, 4)
        live = svc.set_plugin_weights({"NodeResourcesFit": 2.5})
        out = P.Engine(store, svc, None).run({"metadata": {"name": "scoped", "namespace": "default"},
                                              "spec": {"operations": ops, "pluginWeights": [1, 1, 1]}})
        assert out["status"]["phase"] == "Succeeded", out["status"]
        assert svc.plugin_weights() == live
        runs.append((out, store))
    assert_same_run(*runs)


# ------------------------------------------------------------ port contract

def test_a_replay_over_a_restored_store_encodes_and_uploads_afresh():
    """A second replay on the same service wipes the store under the live
    engine: its first round takes a full encode counted as "store
    restored" and uploads every plane (nothing scattered against the
    planes of the wiped cluster); both replays equal the reference's."""
    scn = workloads.scenario_churn(24, 60, 3, web=4, cordon=2)
    outs = {}
    for P in (PORT, JAX):
        store, svc, engine = build_engine(P, "auto")
        first = engine.run(scn)
        if P is PORT:
            eng = svc._batch_engine
            full0 = eng._placer.full_uploads
            reasons0 = dict(eng.encode_stats()["encode_fallbacks_by_reason"])
        second = engine.run(scn)
        outs[P.name] = ((first, second), store)
        if P is PORT:
            assert second["status"]["phase"] == "Succeeded"
            reasons = eng.encode_stats()["encode_fallbacks_by_reason"]
            assert reasons.get("store restored", 0) == reasons0.get("store restored", 0) + 1
            assert "store restored" not in reasons0
            assert eng._placer.full_uploads > full0
    # the second replay binds every pod where the first did
    first, second = outs["port"][0]
    for out in (first, second):
        assert out["status"]["scenarioResult"]["summary"] == first["status"]["scenarioResult"]["summary"]
    assert_same_run(outs["port"], outs["jax"])


def test_a_convergence_pass_with_nothing_pending_launches_no_scan(monkeypatch):
    """Majors whose operations leave nothing pending (and the convergence
    pass after the last pod bound) never call the scan: the engine is not
    reached on an empty queue.  ``kernels.scan`` refuses a launch over no
    pods outright."""
    calls = []
    real = TB.build_batch_fn

    def counting(*a, **kw):
        fn = real(*a, **kw)

        def wrapped(*args):
            calls.append(len(args))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(TB, "build_batch_fn", counting)
    store, svc, engine = build_engine(PORT, "auto")
    out = engine.run(_ops(
        [{"id": f"n{i}", "step": 1, "createOperation": {"object": _node(f"node-{i}")}} for i in range(3)]
        + [_pod_op(2, "p1", cpu="100m")]
        + [{"id": "n9", "step": 3, "createOperation": {"object": _node("node-9")}}]
        + [{"id": "done", "step": 4, "doneOperation": {}}]
    ))
    assert out["status"]["phase"] == "Succeeded"
    # one round: step 2's pod; steps 1 and 3 had nothing pending
    assert len(calls) == 1 and svc.stats["batch_commits"] == 1
    from kube_scheduler_simulator_tpu_torch.ops import kernels

    dims = {"P": 0, "N": 8}
    with pytest.raises(ValueError, match="no pods"):
        kernels.scan(None, dims, None)
    with pytest.raises(ValueError, match="no pods"):
        kernels.scan(None, dict(dims, P=256), None, window=0)


def test_a_replay_stops_and_restarts_the_background_loop():
    """The engine stops a running loop for the replay and starts it again
    after; an exception raised while the loop is stopped (a library load
    error at a convergence round's launch, which the round does not
    degrade) propagates out of ``run`` and the loop is running again
    afterwards, with no error of its own."""
    store, svc, engine = build_engine(PORT, "auto")
    svc.start_background(poll_interval=0.02)
    seen = []
    real_run = engine._run_steps

    def watching(*a, **kw):
        seen.append(svc.is_background_running())
        return real_run(*a, **kw)

    engine._run_steps = watching
    try:
        out = engine.run(_ops([{"id": "n", "step": 1, "createOperation": {"object": _node("node-1")}},
                               _pod_op(2, "p1"), {"id": "d", "step": 3, "doneOperation": {}}]))
        assert out["status"]["phase"] == "Succeeded" and seen == [False] and svc.is_background_running()
        real = TB.build_batch_fn
        failures = []

        def failing_once(*a, **kw):
            if failures:
                return real(*a, **kw)

            def fn(*args):
                failures.append(1)
                raise KernelBuildError("injected launch error")
            return fn

        TB.build_batch_fn = failing_once
        try:
            with pytest.raises(RuntimeError, match="injected launch error"):
                engine.run(_ops([{"id": "n", "step": 1, "createOperation": {"object": _node("node-1")}},
                                 _pod_op(1, "p2"), {"id": "d", "step": 2, "doneOperation": {}}]))
            assert seen == [False, False] and svc.is_background_running()
            # the restarted loop schedules the pod the failed round left
            deadline = time.monotonic() + 20
            while not store.get("pods", "p2", "default")["spec"].get("nodeName") and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            TB.build_batch_fn = real
        assert store.get("pods", "p2", "default")["spec"]["nodeName"] == "node-1"
    finally:
        svc.stop_background()  # the loop itself met no error: raises nothing
    assert not svc.is_background_running()


def test_a_replay_surfaces_the_error_of_a_loop_that_died():
    """A loop that died of a launch error it does not degrade (a library
    load error) keeps it; the next replay calls ``stop_background``, which
    re-raises it, instead of running over it."""
    store, svc, engine = build_engine(PORT, "auto")
    store.create("nodes", _node("node-1"))
    real = TB.build_batch_fn

    def failing(*a, **kw):
        def fn(*args):
            raise KernelBuildError("injected launch error")
        return fn

    TB.build_batch_fn = failing
    try:
        svc.start_background(poll_interval=0.02)
        store.create("pods", {"metadata": {"name": "p0", "namespace": "default"},
                              "spec": {"containers": [{"name": "c"}]}})
        deadline = time.monotonic() + 20
        while svc.is_background_running() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        TB.build_batch_fn = real
    assert not svc.is_background_running()
    with pytest.raises(RuntimeError, match="injected launch error"):
        engine.run(_ops([{"id": "d", "step": 1, "doneOperation": {}}]))
    # raised once: the replay now runs
    assert engine.run(_ops([{"id": "d", "step": 1, "doneOperation": {}}]))["status"]["phase"] == "Succeeded"
    assert not svc.is_background_running()
