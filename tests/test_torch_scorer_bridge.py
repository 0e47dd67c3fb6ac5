"""The port's TPUScorerBridge (scheduler/scorer_bridge.py) against the JAX
package's: both bridges answer extenderv1 Filter and Prioritize alike, and
the three BatchResult methods the bridge reads (``filter_annotation``,
``totals_map``, ``feasible_idx``) equal the reference's.  One deliberate
difference: where the candidates are a subset of the cluster, the port's
kernel pass counts ImageLocality's spread over the cluster, as both
packages' oracle fallbacks (and upstream) do; the reference's kernel pass
counts it over the candidates."""

from __future__ import annotations

import random
import sys
import threading
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.scheduler.batch_engine import BatchEngine as JaxEngine  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.scorer_bridge import TPUScorerBridge as JaxBridge  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.scorer_bridge import TPUScorerBridge  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def mk_node(name: str, cpu_m: int, taints=None, labels=None) -> dict:
    return {"metadata": {"name": name, "labels": {"kubernetes.io/hostname": name, **(labels or {})}},
            "spec": {"taints": taints} if taints else {},
            "status": {"allocatable": {"cpu": f"{cpu_m}m", "memory": "8Gi", "pods": "110"}}}


def mk_pod(name: str, cpu_m: int, **spec_extra) -> dict:
    spec: dict = {"containers": [{"name": "c", "resources": {"requests": {"cpu": f"{cpu_m}m"}}}]}
    spec.update(spec_extra)
    return {"metadata": {"name": name, "namespace": "default"}, "spec": spec}


def small(store) -> None:
    """tests/test_scorer_bridge.py's cluster: a free node, a tight one (a
    bound pod takes 800m of 1000m) and a tainted one."""
    store.create("nodes", mk_node("node-free", 8000))
    store.create("nodes", mk_node("node-tight", 1000))
    store.create("nodes", mk_node("node-tainted", 8000, taints=[{"key": "gpu", "value": "yes",
                                                                 "effect": "NoSchedule"}]))
    bound = mk_pod("existing", 800)
    bound["spec"]["nodeName"] = "node-tight"
    store.create("pods", bound)


def seeded(store) -> None:
    """A seeded cluster with images on the nodes: 30 nodes, 40 bound pods."""
    nodes, all_pods, _pending = workloads.cluster(6, 30, seed=5, n_bound=40)
    store.create("namespaces", {"metadata": {"name": "default"}})
    for n in nodes:
        store.create("nodes", n)
    for p in all_pods[:40]:
        store.create("pods", p)


def bridges(build):
    out = []
    for Svc, Store, Bridge, extra in ((JaxService, JaxStore, JaxBridge, {}),
                                      (SchedulerService, ClusterStore, TPUScorerBridge, {"device": "cpu"})):
        store = Store(clock=lambda: 0.0)
        build(store)
        svc = Svc(store, use_batch="off", **extra)
        svc.start_scheduler(None)
        out.append(Bridge(svc))
    return out


def names(store) -> list:
    return [n["metadata"]["name"] for n in store.list("nodes")]


def seeded_pending() -> list:
    return workloads.cluster(6, 30, seed=5, n_bound=40)[2]


# each case: (cluster, verb, the args from the store's node list)
CASES = {
    "filter, nodes": (small, "filter", lambda nodes: {"pod": mk_pod("incoming", 2000), "nodes": {"items": nodes}}),
    "filter, nodenames, unresolvable": (small, "filter", lambda nodes: {
        "pod": mk_pod("incoming", 100, nodeSelector={"zone": "z9"}), "nodenames": ["node-free", "node-tight"]}),
    "prioritize, nodes": (small, "prioritize", lambda nodes: {
        "pod": mk_pod("incoming", 500), "nodes": {"items": [n for n in nodes if n["metadata"]["name"] != "node-tainted"]}}),
    "prioritize, nodenames": (small, "prioritize", lambda nodes: {
        "pod": mk_pod("incoming", 100), "nodenames": ["node-tight", "node-free"]}),
    "filter, an unsupported pod (the oracle)": (small, "filter", lambda nodes: {
        "pod": mk_pod("incoming", 100, volumes=[{"name": "v", "persistentVolumeClaim": {"claimName": "c"}}]),
        "nodes": {"items": nodes}}),
    "prioritize, an unsupported pod (the oracle)": (small, "prioritize", lambda nodes: {
        "pod": mk_pod("incoming", 100, volumes=[{"name": "v", "persistentVolumeClaim": {"claimName": "c"}}]),
        "nodes": {"items": nodes}}),
    "filter, no nodes (the oracle)": (small, "filter", lambda nodes: {"pod": mk_pod("incoming", 100),
                                                                      "nodenames": []}),
    **{f"{verb}, seeded pod {i}, every node": (seeded, verb, lambda nodes, i=i: {
        "pod": seeded_pending()[i], "nodes": {"items": nodes}}) for i in range(6) for verb in ("filter", "prioritize")},
}


@pytest.mark.parametrize("case", list(CASES))
def test_both_bridges_answer_alike(case):
    build, verb, args = CASES[case]
    ref, port = bridges(build)
    answers = [getattr(b, verb)(args(b.scheduler_service.cluster_store.list("nodes"))) for b in (ref, port)]
    assert answers[1] == answers[0]
    assert (port.requests, port.fallbacks) == (ref.requests, ref.fallbacks)
    if isinstance(answers[1], dict):
        assert answers[1]["error"] == ""


def test_the_bridge_reads_the_kernel_trace_as_the_reference_test_does():
    _ref, port = bridges(small)
    nodes = port.scheduler_service.cluster_store.list("nodes")
    out = port.filter({"pod": mk_pod("incoming", 2000), "nodes": {"items": nodes}})
    assert {n["metadata"]["name"] for n in out["nodes"]["items"]} == {"node-free"}
    assert "Insufficient cpu" in out["failedNodes"]["node-tight"]
    assert "untolerated taint" in out["failedAndUnresolvableNodes"]["node-tainted"]
    got = {e["host"]: e["score"] for e in port.prioritize({"pod": mk_pod("incoming", 500),
                                                           "nodenames": ["node-free", "node-tight"]})}
    assert got["node-free"] > 0 and got["node-tight"] == 0 and port.fallbacks == 0


def test_the_kernel_pass_counts_image_spread_over_the_cluster():
    """Candidates a subset of a cluster whose nodes publish images: the
    port's kernel answers equal its own oracle and the reference's oracle;
    the reference's kernel pass divides by the candidates instead."""
    ref, port = bridges(seeded)
    rng = random.Random(3)
    pods = seeded_pending()
    differ = 0
    for i, pod in enumerate(pods):
        cand = rng.sample(names(port.scheduler_service.cluster_store), 7)
        by = {n["metadata"]["name"]: n for n in port.scheduler_service.cluster_store.list("nodes")}
        f = port.filter({"pod": pod, "nodenames": cand})
        oracle = port._filter_fallback(pod, [by[n] for n in cand])
        assert f["nodenames"] == [n["metadata"]["name"] for n in oracle[0]]
        assert (f["failedNodes"], f["failedAndUnresolvableNodes"]) == oracle[1:]
        if not f["nodenames"]:
            continue
        got = port.prioritize({"pod": pod, "nodenames": f["nodenames"]})
        passed = [by[n] for n in f["nodenames"]]
        assert got == port._prioritize_fallback(pod, passed) == ref._prioritize_fallback(pod, passed)
        differ += ref.prioritize({"pod": pod, "nodenames": f["nodenames"]}) != got
    assert port.fallbacks == 0 and differ > 0


def probe(store) -> None:
    """A seeded cluster whose topology domains reach past any candidate
    list: 40 nodes, 120 bound pods, spread constraints on every pod and
    inter-pod terms on every other one."""
    nodes, all_pods, _pending = probe_cluster()
    store.create("namespaces", {"metadata": {"name": "default"}})
    for n in nodes:
        store.create("nodes", n)
    for p in all_pods[:120]:
        store.create("pods", p)


def probe_cluster():
    return workloads.cluster(20, 40, seed=9, n_bound=120, spread=lambda i: True, interpod=lambda i: i % 2 == 0)


def probe_answers(bridge, oracle) -> "tuple[int, int]":
    """Ask the bridge Filter and Prioritize about the probe's 20 pods over
    seeded 8-node candidate lists: (pods whose Filter differs from
    ``oracle``'s, pods whose Prioritize differs)."""
    store = bridge.scheduler_service.cluster_store
    by = {n["metadata"]["name"]: n for n in store.list("nodes")}
    rng = random.Random(17)
    f_diff = p_diff = 0
    for pod in probe_cluster()[2]:
        cand = rng.sample(sorted(by), 8)
        f = bridge.filter({"pod": pod, "nodenames": cand})
        want = oracle._filter_fallback(pod, [by[n] for n in cand])
        f_diff += (f["nodenames"], f["failedNodes"], f["failedAndUnresolvableNodes"]) != (
            [n["metadata"]["name"] for n in want[0]], *want[1:])
        passed = [by[n] for n in f["nodenames"]]
        if passed:
            p_diff += bridge.prioritize({"pod": pod, "nodenames": f["nodenames"]}) != oracle._prioritize_fallback(
                pod, passed)
    return f_diff, p_diff


def test_the_kernel_pass_sees_the_cluster_and_answers_over_the_candidates():
    """The port's kernel pass encodes every node and bound pod and masks
    the non-candidates out of feasibility: its Filter and Prioritize equal
    its oracle's for every probe pod."""
    _ref, port = bridges(probe)
    assert probe_answers(port, port) == (0, 0)
    assert port.fallbacks == 0 and port.requests["prioritize"] > 0


def test_the_reference_bridge_differs_from_its_oracle_on_the_probe():
    """Records a fault of the REFERENCE, not a test of the port: the JAX
    package's kernel pass encodes the candidates and their pods only, so
    its Prioritize differs from its own oracle where spread domains and
    inter-pod terms reach past the candidates."""
    ref, _port = bridges(probe)
    _f_diff, p_diff = probe_answers(ref, ref)
    assert p_diff > 0


def test_result_methods_equal_the_references():
    """``filter_annotation``, ``totals_map`` and ``feasible_idx`` of one
    round, without and with a float weight override."""
    nodes, all_pods, pending = workloads.cluster(12, 20, seed=3, n_bound=10)
    scores = [("NodeResourcesFit", 1), ("NodeResourcesBalancedAllocation", 1), ("ImageLocality", 1),
              ("TaintToleration", 3), ("NodeAffinity", 2)]
    filters = ["NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodeResourcesFit"]
    for weights in (None, [1.5, 0.25, 2.0, 3.0, 0.5]):
        kw = dict(filters=filters, scores=scores, trace=True, tie_break="first")
        ref = JaxEngine(**kw, weights=weights).schedule(nodes, all_pods, pending)
        got = BatchEngine(**kw, weights=weights, device="cpu").schedule(nodes, all_pods, pending)
        for i in range(len(pending)):
            assert got.filter_annotation(i) == ref.filter_annotation(i)
            assert got.totals_map(i) == ref.totals_map(i)
            assert got.feasible_idx(i) == ref.feasible_idx(i)


def test_a_handler_thread_runs_the_pass_and_errors_travel_in_the_wire():
    _ref, port = bridges(small)
    out: list = []
    t = threading.Thread(target=lambda: out.append(port.filter({"pod": mk_pod("incoming", 100),
                                                                "nodenames": ["node-free"]})))
    t.start()
    t.join()
    assert out[0]["nodenames"] == ["node-free"] and out[0]["error"] == ""
    port.scheduler_service.framework = None
    assert port.filter({"pod": mk_pod("x", 1), "nodenames": ["node-free"]})["error"] == "scheduler not started"
    with pytest.raises(RuntimeError, match="scheduler not started"):
        port.prioritize({"pod": mk_pod("x", 1), "nodenames": ["node-free"]})
