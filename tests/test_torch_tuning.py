"""The port's weight tuner (tuning/) and plugin-weight override against the
JAX package's.

- Validation and finalScore rendering: the port's copies accept, reject
  and render as the reference's (the reject cases of tests/test_tuning.py).
- Objectives: each objective's value and its cotangent d objective /
  d final_nonzero against the reference's ``objective_value`` and
  ``jax.grad`` of it, on a rollout's final carry (1e-12 relative: the port
  sums in a fixed pairwise tree, XLA in its own order).
- Population (K9's plain version): ``evaluate_population`` against the
  reference's ``build_population_fn`` (1e-12 relative), every lane's
  selections against the reference's one-rollout selections.
- The relaxed head: the plain straight-through scan's forward is bitwise the
  hard scan's at tau 1, 50 and 1000.
- The gradient (K2g's plain version, ``grad_plain``): against
  ``jax.value_and_grad`` through the reference's straight-through scan and
  against torch autograd through the port's, to 1e-9 of the gradient's
  norm; pending_age's is exactly 0.  If a score ever passed gradient
  through the carry, the closed form would miss it and these fail.
- ``run_tuning`` at the bench's ``--quick`` size for the bench's three rows:
  CEM reports equal, grad reports within 1e-9.
- The service's override: float weights through the batch round and the
  sequential cycle give the reference's bytes; the default weights as an
  override give the bytes of no override; the scale-up estimator keeps its
  own profile under a live override.
- Exactness: a session whose values pass float32's exact integers runs in
  float64.

The port runs on the CPU (``device="cpu"``, float64, the plain versions);
the reference in float64 (x64 scoped per test).  The CUDA kernels are held
against the plain versions by the ``gpu`` tests of
tests/test_torch_kernels.py and by chip_smoke.py.
"""

from __future__ import annotations

import copy
import random
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.ops import batch as JB  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from kube_scheduler_simulator_tpu.tuning import objective as JO  # noqa: E402
from kube_scheduler_simulator_tpu.tuning import scenario as JS  # noqa: E402
from kube_scheduler_simulator_tpu.tuning import tuner as JT  # noqa: E402
from kube_scheduler_simulator_tpu.tuning import validate as JV  # noqa: E402
from test_batch_parity import mk_node, mk_pod, profile_with  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402
from kube_scheduler_simulator_tpu_torch.tuning import objective as TO  # noqa: E402
from kube_scheduler_simulator_tpu_torch.tuning import tuner as TT  # noqa: E402
from kube_scheduler_simulator_tpu_torch.tuning import validate as TV  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    """The reference runs in float64 here (the port's CPU dtype), scoped to
    each test so other test files keep the process default."""
    with jax.enable_x64(True):
        yield


GRAD_TOL = 1e-9  # ||g_port - g_ref|| <= GRAD_TOL * ||g_ref||: sums in another order
VALUE_TOL = 1e-12  # objective values: the tree's order against XLA's


# --------------------------------------------------------------- validation


@pytest.mark.parametrize(
    "weights,names,defaults",
    [([1, 2.5, 0], ["A", "B", "C"], None), ({"B": 3}, ["A", "B"], {"A": 1, "B": 1})],
)
def test_validation_accepts_as_the_reference(weights, names, defaults):
    got = TV.validate_plugin_weights(weights, names, defaults=defaults)
    assert got.dtype == np.float64 and got.tolist() == JV.validate_plugin_weights(weights, names, defaults).tolist()


@pytest.mark.parametrize(
    "bad",
    [
        [1, 2],
        [1, 2, 3, 4],
        [1, -2, 3],
        [1, float("nan"), 3],
        [1, float("inf"), 3],
        [1, "x", 3],
        [1, True, 3],
        {"Nope": 1},
        "1,2,3",
        42,
    ],
)
def test_validation_rejects_as_the_reference(bad):
    defaults = {"A": 1, "B": 1, "C": 1}
    with pytest.raises(TV.WeightValidationError) as got:
        TV.validate_plugin_weights(bad, ["A", "B", "C"], defaults=defaults)
    with pytest.raises(JV.WeightValidationError) as want:
        JV.validate_plugin_weights(bad, ["A", "B", "C"], defaults=defaults)
    assert str(got.value) == str(want.value)


def test_validation_rejects_a_missing_weight_without_default():
    with pytest.raises(TV.WeightValidationError):
        TV.validate_plugin_weights({"A": 1}, ["A", "B"])


def test_format_weighted_score_renders_as_the_reference():
    for norm in (0, 1, 37, 100):
        for w in (0, 1, 2, 10, 1.5, 0.5, 2.37, 1 / 3):
            assert TV.format_weighted_score(norm, float(w)) == JV.format_weighted_score(norm, float(w))
    assert TV.format_weighted_score(37, 0.5) == "18.5" and TV.format_weighted_score(100, 1.5) == "150"


# ------------------------------------------------------------------ sessions

_PROFILE: dict = {}


def _profile():
    """(port scores, filters) of a default port service, checked against the
    reference's once."""
    if not _PROFILE:
        got = TT.profile_scores(device="cpu")
        assert got == JT.profile_scores()
        _PROFILE["v"] = got
    return _PROFILE["v"]


def _sessions(family, objective=None, n_nodes=8, n_pods=48, seed=1):
    """(port session on the CPU, reference session) on the same family."""
    nodes, pods, fam_obj = workloads.tune(family, n_nodes=n_nodes, n_pods=n_pods, seed=seed)
    assert (nodes, pods, fam_obj) == JS.build_family(family, n_nodes=n_nodes, n_pods=n_pods, seed=seed)
    scores, filters = _profile()
    obj = objective or fam_obj
    port = TT.TuningSession(nodes, pods, scores, filters=filters, objective=obj, device="cpu")
    ref = JT.TuningSession(copy.deepcopy(nodes), copy.deepcopy(pods), scores, filters=filters, objective=obj)
    return port, ref


def _weights(S, seed):
    return np.random.default_rng(seed).uniform(0.2, 3.0, size=S)


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ---------------------------------------------------------------- objectives


@pytest.mark.parametrize("name", ["utilization", "fragmentation", "pending_age"])
@pytest.mark.parametrize("family,seed", [("imbalance", 3), ("consolidate", 4)])
def test_objective_and_its_cotangent_match_the_reference(name, family, seed):
    port, ref = _sessions(family, name, n_pods=40, seed=seed)
    w = torch.as_tensor(_weights(len(port.scores), seed), dtype=torch.float64)
    ys = TB.scan_plain(port.cfg, port.dims, port.dp, weights=w)
    fnz = ys["final_nonzero"].numpy()
    sel = ys["selected"].numpy()
    got = float(TO.objective_plain(name, ys, port.dp, port.age_w))
    jys = {"final_nonzero": jnp.asarray(fnz), "selected": jnp.asarray(sel)}
    want = float(JO.objective_value(name, jys, ref.dp, ref.age_w))
    assert abs(got - want) <= VALUE_TOL * max(abs(want), 1e-300), (got, want)
    assert got == float(TO.objective_value(name, ys, port.dp, port.age_w))
    F = TO.objective_grad_plain(name, ys, port.dp, port.age_w).numpy()
    jF = np.asarray(jax.grad(lambda u: JO.objective_value(name, {**jys, "final_nonzero": u}, ref.dp, ref.age_w))(
        jys["final_nonzero"]))
    assert F.shape == fnz.shape
    if name == "pending_age":
        assert not F.any() and not jF.any()
    else:
        assert _rel(F, jF) <= VALUE_TOL, _rel(F, jF)
    # a lane axis gives each lane's value
    lanes = {"final_nonzero": ys["final_nonzero"][None].repeat(2, 1, 1), "selected": ys["selected"][None].repeat(2, 1)}
    assert TO.objective_plain(name, lanes, port.dp, port.age_w).tolist() == [got, got]


def test_tree_sum_pads_to_a_power_of_two():
    x = torch.arange(1, 6, dtype=torch.float64)
    assert float(TO.tree_sum(x)) == 15.0
    assert TO.tree_sum(torch.ones(3, 5, dtype=torch.float64)).tolist() == [5.0, 5.0, 5.0]
    assert float(TO.tree_sum(torch.zeros(0, dtype=torch.float64))) == 0.0


# ---------------------------------------------------------------- population


@pytest.mark.parametrize("family", ["imbalance", "consolidate"])
def test_population_matches_the_reference(family):
    port, ref = _sessions(family, seed=2)
    S = len(port.scores)
    W = np.stack([_weights(S, 10 + g) for g in range(4)] + [np.zeros(S), np.eye(S)[2] * 3.0])
    got = port.evaluate_population(W)
    want = ref.evaluate_population(W)
    assert np.all(np.abs(got - want) <= VALUE_TOL * np.maximum(np.abs(want), 1e-300)), (got, want)
    lanes = TB.scan_lanes_plain(port.cfg, port.dims, port.dp, weights=torch.as_tensor(W))
    fn = JB.build_batch_fn(ref.cfg, ref.dims)
    for g, w in enumerate(W):
        ys = fn(ref.dp._replace(plugin_w=jnp.asarray(w)))
        assert np.array_equal(lanes["selected"][g].numpy(), np.asarray(ys["selected"])), g
        assert np.array_equal(lanes["final_nonzero"][g].numpy(), np.asarray(ys["final_nonzero"])), g
    assert port.dispatches == 1 and port.rollouts == len(W)


# ------------------------------------------------------------- relaxed head


@pytest.mark.parametrize("tau", [1.0, 50.0, 1000.0])
def test_relaxed_plain_forward_is_the_hard_rollout(tau):
    port, _ref = _sessions("imbalance", "fragmentation", n_pods=32)
    w = torch.as_tensor(_weights(len(port.scores), 5), dtype=torch.float64)
    hard = TB.scan_plain(port.cfg, port.dims, port.dp, weights=w)
    wg = w.clone().requires_grad_(True)
    soft = TB.scan_plain(port.cfg._replace(relax_tau=tau), port.dims, port.dp, weights=wg)
    for k, v in hard.items():
        if k == "final_carry":
            for f in TB.CARRY0_FIELDS:
                assert torch.equal(torch.as_tensor(soft[k][f]).detach(), torch.as_tensor(v[f])), (tau, f)
        else:
            assert torch.equal(soft[k].detach(), v), (tau, k)
    assert soft["final_nonzero"].requires_grad
    v, _g = port.value_and_grad(w.numpy(), tau)
    assert v == port.evaluate(w.numpy())


# ------------------------------------------------------------------ gradient


def _autograd(port, w: np.ndarray, tau: float) -> np.ndarray:
    """d objective / d weights by torch autograd through the port's plain
    straight-through scan and plain objective."""
    wg = torch.as_tensor(w, dtype=torch.float64).clone().requires_grad_(True)
    ys = TB.scan_plain(port.cfg._replace(relax_tau=tau), port.dims, port.dp, weights=wg)
    TO.objective_plain(port.objective, ys, port.dp, port.age_w).backward()
    return wg.grad.numpy()


@pytest.mark.parametrize(
    "family,objective", [("imbalance", "fragmentation"), ("consolidate", "utilization"), ("imbalance", "utilization")]
)
@pytest.mark.parametrize("wseed", [21, 22])
def test_grad_matches_jax_value_and_grad_and_torch_autograd(family, objective, wseed):
    port, ref = _sessions(family, objective, n_pods=40, seed=wseed)
    w = _weights(len(port.scores), wseed)
    tau = 50.0
    v, g = port.value_and_grad(w, tau)
    jv, jg = ref.value_and_grad(w, tau)
    assert abs(v - jv) <= VALUE_TOL * max(abs(jv), 1e-300)
    assert np.linalg.norm(jg) > 0, "the reference's gradient is zero: the case checks nothing"
    assert _rel(g, jg) <= GRAD_TOL, (_rel(g, jg), g, jg)
    ag = _autograd(port, w, tau)
    assert _rel(g, ag) <= GRAD_TOL, (_rel(g, ag), g, ag)
    assert port.grad_dispatches == 1 and port.dispatches == 1


def test_grad_plain_is_the_rollout_and_pending_age_has_zero_gradient():
    port, ref = _sessions("tail", "pending_age", n_pods=30)
    w = torch.as_tensor(_weights(len(port.scores), 7), dtype=torch.float64)
    F = torch.zeros(port.dims["N"], 2, dtype=torch.float64)
    dw, out = TB.grad_plain(port.cfg, port.dims, port.dp, w, F, 50.0)
    assert dw.dtype == torch.float64 and not dw.any()
    hard = TB.scan_plain(port.cfg, port.dims, port.dp, weights=w)
    assert torch.equal(out["packed_pod"], hard["packed_pod"]) and torch.equal(out["final_nonzero"], hard["final_nonzero"])
    _v, g = port.value_and_grad(w.numpy(), 50.0)
    _jv, jg = ref.value_and_grad(w.numpy(), 50.0)
    assert not np.any(g) and not np.any(jg)


# -------------------------------------------------------------- run_tuning

QUICK = dict(n_nodes=8, n_pods=48, steps=3, pop=6)


@pytest.mark.parametrize("family,tuner", workloads.TUNE_ROWS)
def test_run_tuning_reports_match_the_reference(family, tuner):
    kw = dict(QUICK, seed=11, tau=50.0, lr=1.0)
    if tuner == "grad":
        kw.pop("pop")
    got = TT.run_tuning(family=family, tuner=tuner, device="cpu", **kw)
    want = JT.run_tuning(family=family, tuner=tuner, **kw)
    assert got["kernelPlatform"] == "cpu"
    assert set(got) == set(want)
    exact = [k for k in want if k not in ("kernelPlatform", "weights", "history")]
    assert {k: got[k] for k in exact} == {k: want[k] for k in exact}
    assert got["tunedObjective"] >= got["defaultObjective"]
    if tuner == "cem":
        assert got["weights"] == want["weights"] and got["history"] == want["history"]
        assert got["dispatches"] == 1 + QUICK["steps"] and got["rollouts"] == 1 + QUICK["steps"] * QUICK["pop"]
    else:
        assert _rel(got["weights"], want["weights"]) <= GRAD_TOL
        assert len(got["history"]) == len(want["history"])
        for a, b in zip(got["history"], want["history"]):
            assert a["objective"] == b["objective"] and a["bestSoFar"] == b["bestSoFar"]
            assert abs(a["gradNorm"] - b["gradNorm"]) <= GRAD_TOL * b["gradNorm"]


def test_run_tuning_feeds_the_service_counters():
    svc = SchedulerService(ClusterStore(), device="cpu")
    svc.start_scheduler(None)
    r = TT.run_tuning(family="imbalance", tuner="grad", svc=svc, n_nodes=6, n_pods=24, steps=2)
    assert svc.stats["tuning_runs"] == 1 and svc.stats["tuning_rollouts"] == r["rollouts"]
    assert svc.stats["tuning_grad_dispatches"] == r["gradDispatches"] == 2
    assert svc.stats["tuning_objective"] == {"fragmentation": r["tunedObjective"]}
    assert TT.tuning_families() == sorted(JT.tuning_families())


def test_session_past_the_float32_bound_runs_in_float64():
    """A problem whose scaled values pass 2^24 (memory of GCD 1) runs in
    float64 even when float32 is asked for, and equals the float64 run."""
    nodes, pods, _obj = workloads.tune("imbalance", n_nodes=6, n_pods=24, seed=1)
    for i, n in enumerate(nodes):
        n["status"]["allocatable"]["memory"] = str(33554431 + 2 * i)
    scores, filters = _profile()
    s32 = TT.TuningSession(nodes, pods, scores, filters=filters, objective="fragmentation", dtype=torch.float32, device="cpu")
    s64 = TT.TuningSession(nodes, pods, scores, filters=filters, objective="fragmentation", dtype=torch.float64, device="cpu")
    assert s32.promotion is not None and "2^24" in s32.promotion and s32.dp.alloc.dtype == torch.float64
    w = _weights(len(scores), 3)
    assert s32.evaluate(w) == s64.evaluate(w)
    fine = TT.TuningSession(*workloads.tune("imbalance", 6, 24, 1)[:2], scores, filters=filters,
                            objective="fragmentation", dtype=torch.float32, device="cpu")
    assert fine.promotion is None and fine.dp.alloc.dtype == torch.float32


# ------------------------------------------------------------ the override

PLUGINS = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "TaintToleration"]


def _cluster(n_nodes=10, seed=99):
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {"kubernetes.io/hostname": f"node-{i}", "topology.kubernetes.io/zone": f"z{i % 3}"}
        taints = [{"key": "spot", "value": "true", "effect": "NoSchedule"}] if i % 5 == 4 else None
        nodes.append(mk_node(f"node-{i}", cpu_m=rng.choice([4000, 8000, 16000]), mem_mi=rng.choice([8192, 16384]),
                             labels=labels, taints=taints))
    return nodes


def _pods(lo, hi, seed=7):
    rng = random.Random(seed)
    return [
        mk_pod(f"pod-{i:04d}", cpu_m=rng.choice([100, 300, 700, 1500]), mem_mi=rng.choice([128, 512, 2048]),
               labels={"app": f"a{i % 3}"})
        for i in range(lo, hi)
    ]


def _run(Svc, Store, nodes, mode, weights, waves=3, seed=3, **kw):
    """Seeded churn (waves of 20 pods) through a service under ``weights``:
    (pod states, service)."""
    store = Store(clock=lambda: 0.0)
    for n in nodes:
        store.create("nodes", copy.deepcopy(n))
    svc = Svc(store, tie_break="first", use_batch=mode, batch_min_work=0, weights=weights, **kw)
    svc.start_scheduler({"profiles": [profile_with(PLUGINS)], "percentageOfNodesToScore": 100})
    created = 0
    for w in range(waves):
        for p in _pods(created, created + 20, seed=seed + w):
            store.create("pods", p)
            created += 1
        svc.schedule_pending(max_rounds=1)
    states = {
        p["metadata"]["name"]: ((p.get("spec") or {}).get("nodeName"), p["metadata"].get("annotations") or {})
        for p in store.list("pods")
    }
    return states, svc


@pytest.mark.parametrize("mode", ["force", "off"])
@pytest.mark.parametrize("trial", [0, 1])
def test_float_weights_give_the_reference_bytes(mode, trial):
    """Seeded float weights: the port's batch round (and its sequential
    cycle) under the override leave every pod with the reference's node and
    annotations, finalScore rendered fractional."""
    weights = [round(float(w), 2) for w in np.random.default_rng(100 + trial).uniform(0.0, 4.0, size=len(PLUGINS))]
    nodes = _cluster(10, seed=trial)
    got, svc = _run(SchedulerService, ClusterStore, nodes, mode, weights, device="cpu")
    want, _ = _run(JaxService, JaxStore, nodes, mode, weights)
    assert got.keys() == want.keys()
    bad = [k for k in want if got[k] != want[k]]
    assert not bad, (len(bad), bad[:3])
    if mode == "force":
        assert svc.stats["batch_pods"] > 0 and svc._batch_engine.weight_override is not None
    fin = [a.get("scheduler-simulator/finalscore-result", "") for _n, a in got.values()]
    assert any("." in f for f in fin), "no fractional finalScore rendered"


def test_default_weights_as_an_override_change_no_byte():
    nodes = _cluster(10, seed=42)
    folded, svc_f = _run(SchedulerService, ClusterStore, nodes, "force", None, device="cpu")
    defaults = {n: float(w) for n, w in svc_f.framework.score_weights.items()}
    traced, svc_t = _run(SchedulerService, ClusterStore, nodes, "force", defaults, device="cpu")
    want, _ = _run(JaxService, JaxStore, nodes, "force", None)
    assert svc_t.plugin_weights() is not None and svc_t._batch_engine.weight_override is not None
    assert svc_f._batch_engine.weight_override is None
    assert folded == traced == want


def test_set_plugin_weights_validates_swaps_and_clears():
    nodes = _cluster(4)
    _states, svc = _run(SchedulerService, ClusterStore, nodes, "force", None, waves=1, device="cpu")
    with pytest.raises(TV.WeightValidationError):
        svc.set_plugin_weights([1, -1, 1])
    assert svc.plugin_weights() is None
    got = svc.set_plugin_weights([1, 2.5, 1])
    assert got == dict(zip(svc.score_plugin_names(), [1.0, 2.5, 1.0]))
    eng = svc._engine_for(svc.framework)
    assert svc.framework.score_weight_override == got and eng.weight_override.tolist() == [1.0, 2.5, 1.0]
    svc.set_plugin_weights({"TaintToleration": 0.5})
    assert svc._engine_for(svc.framework) is eng and eng.weight_override.tolist() == [1.0, 1.0, 0.5]
    assert eng._round_weights(torch.float64).tolist() == [1.0, 1.0, 0.5]
    svc.set_plugin_weights(None)
    assert svc.plugin_weights() is None and svc.framework.score_weight_override is None
    assert svc._engine_for(svc.framework) is eng and eng.weight_override is None
    assert eng._round_weights(torch.float64).tolist() == [float(w) for _s, w in eng.scores]
    store = ClusterStore()
    bad = SchedulerService(store, weights=[1, 2], device="cpu")
    with pytest.raises(TV.WeightValidationError):
        bad.start_scheduler({"profiles": [profile_with(PLUGINS)]})


def test_the_estimator_keeps_its_profile_under_a_live_override():
    """The scale-up estimate runs its own packing profile while an override
    is installed (the reference's tests/test_tuning.py:359)."""
    from kube_scheduler_simulator_tpu_torch.autoscaler import ClusterAutoscaler

    store = ClusterStore()
    store.create("nodegroups", {
        "metadata": {"name": "g1"},
        "spec": {
            "minSize": 0, "maxSize": 8, "priority": 0,
            "template": {"metadata": {"labels": {}}, "spec": {},
                         "status": {"allocatable": {"cpu": "4000m", "memory": "8Gi", "pods": "20"}}},
        },
    })
    svc = SchedulerService(store, tie_break="first", use_batch="off", device="cpu")
    svc.start_scheduler(None)
    svc.set_plugin_weights({"NodeResourcesFit": 2.5})
    for i in range(4):
        store.create("pods", mk_pod(f"asc-{i}", cpu_m=1500, mem_mi=1024))
    svc.schedule_pending(max_rounds=1)
    asc = ClusterAutoscaler(store, svc)
    action = asc.scale_up(svc.pending_pods())
    assert action["method"] == "xla-batch", action
    est = asc._estimator
    assert est is not None and est.dispatches >= 1 and est.kernel_errors == 0
    assert est.engine.weight_override is None
    assert est.engine._round_weights(torch.float64).tolist() == [float(w) for _s, w in est.engine.scores]
