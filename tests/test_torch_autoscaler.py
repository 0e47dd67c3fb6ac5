"""The port's capacity engine (autoscaler/) against the JAX package's.

- (a) The plain lane scan (K8's plain version, ``ops/batch.scan_lanes_plain``
  through ``build_lanes_fn``) against the JAX estimator's function built as
  ``ScaleUpEstimator._estimate_kernel`` builds it: ``jax.vmap`` of
  ``build_batch_fn`` over the [G, N] node_active mask, on one problem
  lowered by the JAX package and carried across.  Every output the JAX
  function returns must be equal.
- (b) The two ``ScaleUpEstimator``s on the same groups, headroom and
  pending pods give equal ``GroupEstimate`` lists, on the lane path and on
  the resource fallback.
- (c) The reference's tests of the engine (tests/test_autoscaler.py) that
  need neither ``scenario/`` nor ``server/``, run through both packages:
  action records, pass summaries, ``status()["stats"]``, node names and
  bindings must be equal.
- (d) ``schedule_pending_autoscaled`` at a cut of cfg6-autoscale through
  both services on the batch path: every pod's annotations, node and
  status, and the autoscaler's events, equal.
- (e) What the port's service and estimator accept and refuse.

The port runs on the CPU in float64 (the plain versions standing in for
the kernels), the reference in float64 (x64 scoped per test); both sides
compute on integer-valued data, so every comparison is exact.  The CUDA
kernel is held against the plain version by the ``gpu`` tests of
tests/test_torch_kernels.py and by chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
import random
import re
import sys
from pathlib import Path
from typing import Any

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu import autoscaler as JA  # noqa: E402
from kube_scheduler_simulator_tpu.autoscaler import estimator as JEst  # noqa: E402
from kube_scheduler_simulator_tpu.autoscaler import nodegroups as JNG  # noqa: E402
from kube_scheduler_simulator_tpu.ops import batch as JB  # noqa: E402
from kube_scheduler_simulator_tpu.ops import encode as JE  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from kube_scheduler_simulator_tpu_torch import autoscaler as TA  # noqa: E402
from kube_scheduler_simulator_tpu_torch import interop, workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.autoscaler import estimator as TEst  # noqa: E402
from kube_scheduler_simulator_tpu_torch.autoscaler import nodegroups as TNG  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402

Obj = dict[str, Any]


@pytest.fixture(autouse=True)
def _x64():
    """The reference runs in float64 here (the port's CPU dtype), scoped to
    each test so other test files keep the process default."""
    with jax.enable_x64(True):
        yield


# upstream's default profile: the registry's filter order
DEFAULT_FILTERS = [
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
    "VolumeRestrictions", "EBSLimits", "GCEPDLimits", "NodeVolumeLimits", "AzureDiskLimits",
    "VolumeBinding", "VolumeZone", "PodTopologySpread", "InterPodAffinity",
]
TAINT = [{"key": "gpu", "value": "true", "effect": "NoSchedule"}]


def seeded_case(name: str) -> "tuple[list[Obj], dict[str, int], list[Obj]]":
    """(groups, headroom, pending) of a seeded estimate: three groups (8, 16
    and 64 CPU; the middle one tainted NoSchedule; disk ssd, hdd, ssd, so
    the bench pods' ``disk: ssd`` selectors rule the hdd group out), and
    bench pods from seed 11.  "spread" gives every pod bench's two spread
    constraints (zone and hostname: the per-lane spread carries are
    used); "interpod" every pod its inter-pod terms; "burst" is
    ``workloads.autoscale_burst`` cut to 6 groups of 6 copies; "hostname"
    is 12 pods of one app under a hostname DoNotSchedule constraint of
    maxSkew 1."""
    if name == "burst":
        return workloads.autoscale_burst(n_groups=6, copies=6, n_pending=60, seed=3)
    rng = random.Random(11)
    groups = [
        workloads.node_group("small", "8", "32Gi", {"disk": "ssd"}, 8),
        workloads.node_group("tainted", "16", "64Gi", {"disk": "hdd"}, 8, taints=TAINT),
        workloads.node_group("big", "64", "256Gi", {"disk": "ssd"}, 8),
    ]
    if name == "hostname":
        pods = [hostname_pod(i) for i in range(12)]
    else:
        pods = [workloads.mk_pod(i, rng, spread=name == "spread", interpod=name == "interpod") for i in range(60)]
    return groups, {"small": 8, "tainted": 8, "big": 3}, pods


def hostname_pod(i: int) -> Obj:
    """A pod of app ``web`` that PodTopologySpread keeps one skew from the
    least loaded included node (kubernetes.io/hostname, DoNotSchedule)."""
    return {
        "metadata": {"name": f"web-{i}", "namespace": "default", "labels": {"app": "web"}},
        "spec": {
            "containers": [{"name": "c", "resources": {"requests": {"cpu": "100m", "memory": "128Mi"}}}],
            "topologySpreadConstraints": [{
                "maxSkew": 1, "topologyKey": "kubernetes.io/hostname", "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": "web"}},
            }],
        },
    }


def lane_masks(case: str, blocks: list, N: int, n_true: int) -> np.ndarray:
    """The estimate's [G, N] lane masks, each lane its group's block of
    template rows, and for the masked lane scan's hazards:
    "noncontiguous" draws each lane's rows at random over every real row;
    "empty" leaves lane 0 no row; "hostname" leaves lane 0 three of its
    block's eight rows, so the other five, included but inactive, hold
    the hostname constraint's minimum at 0."""
    masks = np.zeros((len(blocks), N), dtype=bool)
    for g, (lo, hi) in enumerate(blocks):
        masks[g, lo:hi] = True
    if case == "noncontiguous":
        masks = np.random.default_rng(5).random((len(blocks), N)) < 0.45
        masks[:, n_true:] = False
    elif case == "empty":
        masks[0] = False
    elif case == "hostname":
        masks[0, blocks[0][0] + 3 :] = False
    return masks


def jax_fields(dp) -> dict:
    return {
        k: tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v)
        for k, v in dp._asdict().items()
    }


# ------------------------------------------------- (a) the plain lane scan

@pytest.mark.parametrize("case", ["plain", "spread", "interpod", "burst", "noncontiguous", "empty", "hostname"])
def test_plain_lane_scan_matches_the_vmapped_reference(case):
    groups, headroom, pending = seeded_case({"noncontiguous": "spread", "empty": "plain"}.get(case, case))
    est = JEst.ScaleUpEstimator(filters=DEFAULT_FILTERS)
    blocks, synth = [], []
    for g in groups:
        room = min(headroom[g["metadata"]["name"]], len(pending))
        lo = len(synth)
        synth.extend(JNG.synthetic_node(g, i) for i in range(room))
        blocks.append((lo, len(synth)))
    # estimator.py:188-237, the reference's dispatch
    pr = JE.pad_problem(JE.encode(synth, [], pending, None, volumes={}))
    dp, dims = JB.lower(pr, dtype=np.float64)
    cfg = est.engine.cfg._replace(sampling=False, trace=False, traced_weights=False)
    masks = lane_masks(case, blocks, dims["N"], pr.N_true)
    axes = JB.DeviceProblem(**{f: (0 if f == "node_active" else None) for f in JB.DeviceProblem._fields})
    fn = jax.jit(jax.vmap(JB.build_batch_fn(cfg, dims), in_axes=(axes,)))
    want = {k: np.asarray(v) for k, v in fn(jax.device_put(dp._replace(node_active=masks))).items()}

    tdp, tdims = interop.from_jax_problem(jax_fields(dp), dims, device="cpu")
    tcfg = TB.BatchConfig(filters=tuple(DEFAULT_FILTERS), scores=(("NodeResourcesFit", 1),),
                          fit_strategy="MostAllocated", tie_break="first")
    got = TB.build_lanes_fn(tcfg, tdims)(tdp, torch.from_numpy(masks))
    assert set(want) <= set(got)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape, k
        assert np.array_equal(g, v), k
    # the final carry is the stacked lanes' carry
    assert got["final_carry"]["requested0"] is got["final_requested"]
    placed = (want["packed_pod"][:, 0, : pr.P_true] >= 0).sum(axis=1)
    assert placed.max() > 0
    if case not in ("burst", "noncontiguous"):
        assert placed[1] == 0  # the tainted group helps no pod
    if case in ("spread", "noncontiguous"):
        assert np.asarray(tdp.spread_counts0).shape[0] > 1 and got["final_spread_counts"].any()
    if case == "empty":
        assert placed[0] == 0 and not got["final_pod_count"][0].any()
    if case == "hostname":
        # one pod a node: the five inactive rows keep the minimum at 0 (over
        # the lane's three rows alone, the pods would stack two and more a
        # node), and lane 2's three rows take one each too
        assert placed[0] == 3 and placed[2] == 3


def test_fetch_outputs_splits_one_copy_into_the_estimate_outputs():
    """The estimate reads packed_pod (int32), final_pod_count and
    final_requested (the working dtype) in one copy: their bytes gathered,
    fetched and split again give the same arrays, in either dtype."""
    rng = np.random.default_rng(2)
    for dt in (torch.float32, torch.float64):
        out = {
            "packed_pod": torch.from_numpy(rng.integers(-1, 50, (3, 5, 7)).astype(np.int32)),
            "final_pod_count": torch.from_numpy(rng.integers(0, 9, (3, 11))).to(dt),
            "final_requested": torch.from_numpy(rng.integers(0, 1 << 20, (3, 11, 2))).to(dt),
        }
        keys = ("packed_pod", "final_pod_count", "final_requested")
        got = TEst.fetch_outputs(out, keys)
        for k, g in zip(keys, got):
            assert g.dtype == out[k].numpy().dtype and np.array_equal(g, out[k].numpy()), (dt, k)


def test_lane_scan_refuses_the_trace_and_a_bad_mask():
    groups, headroom, pending = seeded_case("plain")
    synth = [TNG.synthetic_node(groups[0], i) for i in range(4)]
    from kube_scheduler_simulator_tpu_torch.ops import encode as TE

    dp, dims = TB.lower(TE.pad_problem(TE.encode(synth, [], pending[:8])), device="cpu")
    cfg = TB.BatchConfig(filters=("NodeResourcesFit",), scores=(("NodeResourcesFit", 1),))
    with pytest.raises(ValueError, match="trace off"):
        TB.build_lanes_fn(cfg._replace(trace=True), dims)(dp, torch.ones(1, dims["N"], dtype=torch.bool))
    fn = TB.build_lanes_fn(cfg, dims)
    with pytest.raises(ValueError, match="lane_active"):
        fn(dp, torch.ones(2, dims["N"] + 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="lane_active"):
        fn(dp, torch.ones(2, dims["N"], dtype=torch.int32))
    out = fn(dp, torch.ones(1, dims["N"], dtype=torch.bool))
    one = TB.scan_plain(cfg, dims, dp)
    assert torch.equal(out["packed_pod"][0], one["packed_pod"])


# ------------------------------------------------ (b) the two estimators

def as_tuples(estimates) -> list:
    return [dataclasses.astuple(e) for e in estimates]


@pytest.mark.parametrize("case", ["plain", "spread", "interpod", "burst", "fallback"])
def test_estimators_agree(case):
    groups, headroom, pending = seeded_case("plain" if case == "fallback" else case)
    if case == "fallback":
        # a claim that does not exist: supported() refuses the workload
        pending[0]["spec"]["volumes"] = [{"name": "v", "persistentVolumeClaim": {"claimName": "missing"}}]
    want_est = JEst.ScaleUpEstimator(filters=DEFAULT_FILTERS)
    got_est = TEst.ScaleUpEstimator(filters=DEFAULT_FILTERS, device="cpu")
    want = want_est.estimate(groups, headroom, pending, volumes={})
    got = got_est.estimate(groups, headroom, pending, volumes={})
    assert as_tuples(got) == as_tuples(want)
    method = "resource-fallback" if case == "fallback" else "xla-batch"
    assert {e.method for e in got} == {method}
    assert (got_est.dispatches, got_est.compiles) == (want_est.dispatches, want_est.compiles)
    assert got_est.kernel_errors == 0 and not got_est.promotions
    assert any(e.pods_fit for e in got)


def test_estimator_dispatch_past_the_float32_bound_runs_in_float64():
    """A float32 estimate whose memory values pass 2^24 after GCD scaling
    (a one-byte-granular template) runs in float64, counted with its
    reason, and gives the float64 estimate."""
    group = workloads.node_group("odd", "4", "33554438", {}, 2)
    pod = {"metadata": {"name": "p0", "namespace": "default"},
           "spec": {"containers": [{"name": "c", "resources": {"requests": {"memory": "33554439"}}}]}}
    small = {"metadata": {"name": "p1", "namespace": "default"},
             "spec": {"containers": [{"name": "c", "resources": {"requests": {"memory": "1"}}}]}}
    e32 = TEst.ScaleUpEstimator(filters=["NodeResourcesFit"], device="cpu", dtype=torch.float32)
    e64 = TEst.ScaleUpEstimator(filters=["NodeResourcesFit"], device="cpu")
    got = e32.estimate([group], {"odd": 2}, [pod, small], volumes={})
    assert as_tuples(got) == as_tuples(e64.estimate([group], {"odd": 2}, [pod, small], volumes={}))
    assert got[0].pods_fit == 1 and sum(e32.promotions.values()) == 1 and not e64.promotions
    assert e32.last_bound[0] == "resource memory"


# ------------------------------------------- (c) the reference's scenarios

def mk_group(name: str, mx: int, cpu: str = "4000m", mem: str = "8Gi", mn: int = 0,
             priority: int = 0, labels: "dict | None" = None, taints=None) -> Obj:
    template: Obj = {
        "metadata": {"labels": labels or {}},
        "spec": ({"taints": taints} if taints else {}),
        "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "20"}},
    }
    return {"metadata": {"name": name}, "spec": {"minSize": mn, "maxSize": mx, "priority": priority,
                                                 "template": template}}


def mk_pod(name: str, cpu: str = "1000m", mem: str = "1Gi", labels=None, **spec_extra) -> Obj:
    spec: Obj = {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}
    spec.update(spec_extra)
    return {"metadata": {"name": name, "namespace": "default", "labels": labels or {}}, "spec": spec}


STATIC_NODE = {
    "metadata": {"name": "static-0", "labels": {"kubernetes.io/hostname": "static-0"}},
    "status": {"allocatable": {"cpu": "4000m", "memory": "8Gi", "pods": "20"}},
}
PACKAGES = {
    "port": dict(store=ClusterStore, svc=SchedulerService, asc=TA.ClusterAutoscaler, ng=TNG,
                 validate=TA.validate_node_group, pick=TA.pick, est=TEst.GroupEstimate, kw={"device": "cpu"}),
    "jax": dict(store=JaxStore, svc=JaxService, asc=JA.ClusterAutoscaler, ng=JNG,
                validate=JA.validate_node_group, pick=JA.pick, est=JEst.GroupEstimate, kw={}),
}


class Run:
    """One package's side of a scenario: its store, a service factory and a
    log of what the scenario observed."""

    def __init__(self, pkg: dict):
        self.pkg = pkg
        self.store = pkg["store"](clock=lambda: 0.0)
        self.log: list = []

    def service(self, **kw):
        svc = self.pkg["svc"](self.store, tie_break="first", use_batch="off", **kw, **self.pkg["kw"])
        svc.start_scheduler(None)
        return svc

    def autoscaler(self, svc, **kw):
        return self.pkg["asc"](self.store, svc, **kw)

    def note(self, *items) -> None:
        self.log.append(items)

    def state(self) -> list:
        nodes = sorted(n["metadata"]["name"] for n in self.store.list("nodes"))
        binds = sorted((p["metadata"]["name"], (p.get("spec") or {}).get("nodeName")) for p in self.store.list("pods"))
        return [nodes, binds]


def _validation(r: Run) -> None:
    v = r.pkg["validate"]
    v(mk_group("ok", 3))
    bad = [{"metadata": {"name": ""}, "spec": {"maxSize": 1}}, mk_group("bad-bounds", 1, mn=5),
           mk_group("bad-qty", 2, cpu="lots")]
    g = mk_group("no-alloc", 2)
    g["spec"]["template"]["status"] = {}
    bad.append(g)
    g = mk_group("bad-prio", 2)
    g["spec"]["priority"] = "high"
    bad.append(g)
    for g in bad:
        with pytest.raises(ValueError) as exc:
            v(g)
        r.note(str(exc.value))


def _malformed_group(r: Run) -> None:
    r.store.create("nodegroups", mk_group("broken", mx=4, cpu="not-a-quantity"))
    r.store.create("nodegroups", mk_group("pool", mx=4))
    svc = r.service()
    for i in range(2):
        r.store.create("pods", mk_pod(f"p{i}"))
    svc.schedule_pending(max_rounds=1)
    asc = r.autoscaler(svc)
    s = asc.run_once()
    assert s["scaled_up"]["nodeGroup"] == "pool" and asc._estimator.kernel_errors == 0
    svc.schedule_pending(max_rounds=2)
    r.note(s, asc.run_once(), asc.status()["stats"])


def _one_dispatch(r: Run) -> None:
    r.store.create("nodegroups", mk_group("small", mx=8, cpu="2000m", mem="4Gi"))
    r.store.create("nodegroups", mk_group("big", mx=8, cpu="8000m", mem="16Gi"))
    svc = r.service()
    for i in range(6):
        r.store.create("pods", mk_pod(f"p{i}", cpu="1500m"))
    svc.schedule_pending(max_rounds=1)
    asc = r.autoscaler(svc)
    action = asc.scale_up(svc.pending_pods())
    assert asc._estimator.dispatches == 1 and action["method"] == "xla-batch"
    by_group = {e["group"]: e for e in action["estimates"]}
    assert (by_group["big"]["nodesNeeded"], by_group["small"]["nodesNeeded"]) == (2, 6)
    r.note(action, asc._estimator.dispatches)


def _profile_filters(r: Run) -> None:
    r.store.create("nodegroups", mk_group("tainted", mx=4, taints=TAINT))
    r.store.create("nodegroups", mk_group("plain", mx=4))
    svc = r.service()
    for i in range(3):
        r.store.create("pods", mk_pod(f"p{i}"))
    svc.schedule_pending(max_rounds=1)
    action = r.autoscaler(svc).scale_up(svc.pending_pods())
    assert action["nodeGroup"] == "plain"
    r.note(action)


def _expanders(r: Run) -> None:
    Est = r.pkg["est"]
    ests = [
        Est("a", 8, 4, 4, waste=0.50, priority=1, method="xla-batch"),
        Est("b", 8, 2, 6, waste=0.30, priority=5, method="xla-batch"),
        Est("c", 8, 3, 5, waste=0.10, priority=0, method="xla-batch"),
        Est("never", 8, 0, 0, waste=0.0, priority=99, method="xla-batch"),
    ]
    picks = [r.pkg["pick"](x, ests).group for x in ("least-waste", "most-pods", "priority")]
    assert picks == ["c", "b", "b"] and r.pkg["pick"]("least-waste", []) is None
    r.note(picks)


def _unknown_expander(r: Run) -> None:
    svc = r.service()
    with pytest.raises(ValueError) as exc:
        r.autoscaler(svc, expander="random")
    r.note(str(exc.value))


def _scale_up_end_to_end(r: Run) -> None:
    r.store.create("nodegroups", mk_group("pool", mx=4))
    svc = r.service(autoscale="on")
    for i in range(4):
        r.store.create("pods", mk_pod(f"p{i}", cpu="3000m"))
    results = svc.schedule_pending_autoscaled(max_rounds=2)
    assert sum(1 for x in results.values() if x.success) == 4
    nodes = r.store.list("nodes")
    assert all(n["metadata"]["labels"].get(TNG.NODE_GROUP_LABEL) == "pool" for n in nodes)
    assert all("kubernetes.io/hostname" in n["metadata"]["labels"] for n in nodes)
    r.note(sorted(results), svc.autoscaler.status()["stats"], svc.autoscaler.events)


def _max_size_and_names(r: Run) -> None:
    r.store.create("nodegroups", mk_group("pool", mx=2))
    svc = r.service(autoscale="on")
    for i in range(5):
        r.store.create("pods", mk_pod(f"p{i}", cpu="3000m"))
    svc.schedule_pending_autoscaled(max_rounds=2)
    r.note(r.state())
    r.store.delete("nodes", "pool-0")
    svc.schedule_pending_autoscaled(max_rounds=2)
    assert sorted(n["metadata"]["name"] for n in r.store.list("nodes")) == ["pool-0", "pool-1"]
    r.note(svc.autoscaler.status()["stats"], svc.autoscaler.events)


def _no_group_helps(r: Run) -> None:
    r.store.create("nodegroups", mk_group("tiny", mx=3, cpu="500m", mem="1Gi"))
    svc = r.service(autoscale="on")
    r.store.create("pods", mk_pod("huge", cpu="64000m"))
    svc.schedule_pending_autoscaled(max_rounds=1)
    assert r.store.list("nodes") == [] and svc.autoscaler.stats["scale_ups"] == 0
    r.note(svc.autoscaler.status()["stats"])


def _scale_down_min_size(r: Run) -> None:
    r.store.create("nodegroups", mk_group("pool", mx=4, mn=1))
    svc = r.service()
    asc = r.autoscaler(svc, scale_down_unneeded_rounds=2)
    g = r.store.get("nodegroups", "pool")
    for i in range(3):
        r.store.create("nodes", r.pkg["ng"].synthetic_node(g, i))
    passes = [asc.run_once() for _ in range(3)]
    assert [len(p["scaled_down"]) for p in passes] == [0, 2, 0]
    r.note(passes, asc.durability_state())


def _drain_and_reschedule(r: Run) -> None:
    r.store.create("nodegroups", mk_group("pool", mx=4))
    svc = r.service(autoscale="on")
    g = r.store.get("nodegroups", "pool")
    for i in range(2):
        r.store.create("nodes", r.pkg["ng"].synthetic_node(g, i))
    for i in range(2):
        p = mk_pod(f"p{i}", cpu="100m", mem="128Mi")
        p["spec"]["nodeName"] = f"pool-{i}"
        r.store.create("pods", p)
    asc = r.autoscaler(svc, scale_down_unneeded_rounds=1)
    svc.autoscaler = asc
    down = asc.run_once()["scaled_down"]
    assert down and down[0]["drainedPods"]
    svc.schedule_pending(max_rounds=2)
    assert all(p["spec"].get("nodeName") for p in r.store.list("pods"))
    r.note(down)


def _pdb_blocks(r: Run) -> None:
    r.store.create("nodegroups", mk_group("pool", mx=4))
    svc = r.service()
    g = r.store.get("nodegroups", "pool")
    r.store.create("nodes", r.pkg["ng"].synthetic_node(g, 0))
    r.store.create("nodes", STATIC_NODE)
    p = mk_pod("guarded", cpu="100m", labels={"app": "db"})
    p["spec"]["nodeName"] = "pool-0"
    r.store.create("pods", p)
    r.store.create("poddisruptionbudgets", {
        "metadata": {"name": "pdb", "namespace": "default"},
        "spec": {"selector": {"matchLabels": {"app": "db"}}},
        "status": {"disruptionsAllowed": 0},
    })
    asc = r.autoscaler(svc, scale_down_unneeded_rounds=1)
    first = asc.run_once()
    assert first["scaled_down"] == []
    r.store.patch("poddisruptionbudgets", "pdb", {"status": {"disruptionsAllowed": 1}}, "default")
    second = asc.run_once()
    assert len(second["scaled_down"]) == 1
    r.note(first, second)


def _relocation_promises(r: Run) -> None:
    r.store.create("nodegroups", mk_group("pool", mx=4, cpu="8000m", mem="16Gi"))
    svc = r.service()
    g = r.store.get("nodegroups", "pool")
    for i in range(2):
        r.store.create("nodes", r.pkg["ng"].synthetic_node(g, i))
        p = mk_pod(f"p{i}", cpu="3000m", mem="1Gi")
        p["spec"]["nodeName"] = f"pool-{i}"
        r.store.create("pods", p)
    r.store.create("nodes", STATIC_NODE)
    asc = r.autoscaler(svc, scale_down_unneeded_rounds=1)
    down = asc.run_once()["scaled_down"]
    assert [a["nodes"] for a in down] == [["pool-0"]]
    svc.schedule_pending(max_rounds=2)
    r.note(down)


def _no_scale_down_after_scale_up(r: Run) -> None:
    r.store.create("nodegroups", mk_group("pool", mx=4))
    svc = r.service()
    asc = r.autoscaler(svc, scale_down_unneeded_rounds=1)
    g = r.store.get("nodegroups", "pool")
    r.store.create("nodes", r.pkg["ng"].synthetic_node(g, 3))
    r.note(asc.run_once())
    r.store.create("pods", mk_pod("p0", cpu="3000m"))
    svc.schedule_pending(max_rounds=1)
    s = asc.run_once()
    assert s["scaled_up"] is not None and s["scaled_down"] == []
    r.note(s, asc.status()["stats"], asc.metrics()["groups"])


SCENARIOS = {
    "validation": _validation,
    "malformed_group": _malformed_group,
    "one_dispatch": _one_dispatch,
    "profile_filters": _profile_filters,
    "expanders": _expanders,
    "unknown_expander": _unknown_expander,
    "scale_up_end_to_end": _scale_up_end_to_end,
    "max_size_and_lowest_names": _max_size_and_names,
    "no_group_helps": _no_group_helps,
    "scale_down_min_size": _scale_down_min_size,
    "drain_and_reschedule": _drain_and_reschedule,
    "pdb_blocks": _pdb_blocks,
    "relocation_promises": _relocation_promises,
    "no_scale_down_after_scale_up": _no_scale_down_after_scale_up,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_reference_scenario_through_both_packages(name):
    runs = {}
    for pkg_name, pkg in PACKAGES.items():
        r = Run(pkg)
        SCENARIOS[name](r)
        runs[pkg_name] = (r.log, r.state())
    assert runs["port"] == runs["jax"]


# --------------------------------------------------- (d) a cut of cfg6

def pod_states(store) -> dict:
    return {
        p["metadata"]["name"]: (
            (p.get("spec") or {}).get("nodeName"), p["metadata"].get("annotations") or {}, p.get("status") or {},
        )
        for p in store.list("pods")
    }


def test_cfg6_cut_through_both_services():
    """cfg6-autoscale cut to one seed node, the three groups at maxSize 8
    and 300 pods (4 seed nodes hold a 150-pod cut whole, so nothing
    scales): three scale-ups, one to each group, every round batched."""
    out = {}
    for name, Svc, Store, extra in (("port", SchedulerService, ClusterStore, {"device": "cpu"}),
                                    ("jax", JaxService, JaxStore, {})):
        def start(store, Svc=Svc, extra=extra):
            svc = Svc(store, tie_break="first", use_batch="auto", batch_min_work=0, autoscale="on",
                      autoscaler_opts={"expander": "least-waste"}, **extra)
            svc.start_scheduler(None)
            return svc

        store = Store(clock=lambda: 0.0)
        svc = workloads.autoscale(store, start, n_pods=300, seed_nodes=1, max_size=8)
        svc.schedule_pending_autoscaled(max_rounds=2, max_passes=12)
        asc = svc.autoscaler
        out[name] = (pod_states(store), asc.events, asc.status()["stats"], svc.pending_pods(), svc.stats["batch_fallbacks"])
    (got, got_ev, got_st, got_pend, got_fb), (want, want_ev, want_st, want_pend, _fb) = out["port"], out["jax"]
    assert got.keys() == want.keys()
    bad = [k for k in want if got[k] != want[k]]
    assert not bad, (len(bad), bad[:3])
    assert got_ev == want_ev and got_st == want_st and got_pend == want_pend == []
    assert [e["nodeGroup"] for e in got_ev] == ["pool-small", "pool-mid", "pool-big"]
    assert {e["method"] for e in got_ev} == {"xla-batch"} and got_fb == {}


# ------------------------------------------------- (e) knobs and refusals

def test_service_accepts_the_autoscale_knob():
    for knob in ("on", "scenario"):
        svc = SchedulerService(ClusterStore(), autoscale=knob, device="cpu")
        assert svc.autoscaler is not None
        assert svc.scenario_autoscaler() is svc.autoscaler
    off = SchedulerService(ClusterStore(), device="cpu")
    assert off.autoscaler is None and off.scenario_autoscaler() is None
    with pytest.raises(ValueError, match=re.escape("autoscale must be off|on|scenario")):
        SchedulerService(ClusterStore(), autoscale="always", device="cpu")


def test_estimator_refuses_a_mesh():
    with pytest.raises(ValueError, match="mesh"):
        TEst.ScaleUpEstimator(mesh=object(), device="cpu")
    est = TEst.ScaleUpEstimator(device="cpu")
    assert est.engine.dtype == torch.float64 and est.engine.cfg.fit_strategy == "MostAllocated"
