"""The port's SchedulerService against the JAX package's.

Both services run on identical stores (the same objects created in the
same order, a frozen store clock, deterministic creation stamps); the port
on the CPU (``device="cpu"``, float64, the plain versions standing in for
the kernels), the reference in float64.  Afterwards every pod must carry
equal annotations, node and status.  Covered: the sequential cycle
(``use_batch="off"``), the windowed double-buffered round (``pipeline=True``
with enough pending pods to split P = 512 into two windows of 256), BASELINE
cfg5's churn cut to three small waves with deletes and a rolling cordon
(both tie-breaks), a kernel-failed pod resolved by the batched
DefaultPreemption, two profiles (segments), and what the port refuses
(the lifecycle beside it: restart, reset, the loop and ``metrics()``).
Mirrors tests/test_batch_parity.py and tests/test_commit_pipeline.py.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from test_batch_parity import mk_node, mk_pod, profile_with  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    """The reference runs in float64 here (the port's CPU dtype), scoped to
    each test."""
    with jax.enable_x64(True):
        yield


def pod_states(store) -> dict:
    """name → (node, annotations, status) of every pod."""
    return {
        p["metadata"]["name"]: (
            (p.get("spec") or {}).get("nodeName"),
            p["metadata"].get("annotations") or {},
            p.get("status") or {},
        )
        for p in store.list("pods")
    }


def run_pair(build, drive, **svc_kw):
    """Build identical stores for both packages (``build(store)``), start a
    service on each with ``svc_kw`` (the port's on the CPU), run
    ``drive(store, service)`` on each; returns (port service, port states,
    reference states)."""
    out = []
    for Svc, Store, extra in ((SchedulerService, ClusterStore, {"device": "cpu"}), (JaxService, JaxStore, {})):
        store = Store(clock=lambda: 0.0)
        cfg = build(store)
        svc = Svc(store, **svc_kw, **extra)
        svc.start_scheduler(cfg)
        drive(store, svc)
        out.append((svc, pod_states(store)))
    (port, got), (_ref, want) = out
    return port, got, want


def assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    bad = [k for k in want if got[k] != want[k]]
    assert not bad, (len(bad), bad[:3], got[bad[0]][0], want[bad[0]][0])


def _pods(store, n: int, first: int = 0, spread=lambda i: i % 3 == 0) -> None:
    import random

    rng = random.Random(first)
    for i in range(first, first + n):
        store.create("pods", workloads.stamp(workloads.mk_pod(i, rng, spread=spread(i)), i))


def _nodes(store, n: int) -> None:
    for i in range(n):
        store.create("nodes", workloads.mk_node(i))


def test_sequential_cycle_matches_the_reference():
    """``use_batch="off"``: the port's framework runner, plugins, queue,
    result store and reflector against the reference's, pod for pod."""
    def build(store):
        _nodes(store, 12)
        _pods(store, 30)
        return None

    port, got, want = run_pair(build, lambda s, svc: svc.schedule_pending(), tie_break="reservoir", use_batch="off")
    assert_same(got, want)
    assert port.stats["sequential_pods"] == 30 and sum(n is not None for n, _a, _s in got.values()) > 20


@pytest.mark.parametrize("tie", ["first", "reservoir"])
def test_windowed_round_matches_the_reference(tie):
    """460 pending pods pad to P = 512, split into two windows of 256 that
    chain their carry (the plain scan here; ``pipeline=True`` stands for the
    card, where "auto" turns it on): the committed bytes equal the
    reference's windowed round."""
    def build(store):
        _nodes(store, 24)
        _pods(store, 460)
        return {"percentageOfNodesToScore": 50}

    port, got, want = run_pair(build, lambda s, svc: svc.schedule_pending(max_rounds=1), tie_break=tie,
                               use_batch="auto", pipeline=True)
    assert_same(got, want)
    eng = port._batch_engine
    assert eng.last_timings["windows"] == 2 and port.stats["batch_pods"] == 460
    assert port.stats["commit_waves"] == 2 and not port.stats["batch_fallbacks"]


@pytest.mark.parametrize("tie", ["first", "reservoir"])
def test_churn_with_rolling_cordon_matches_the_reference(tie):
    """BASELINE cfg5's churn cut to 3 waves of 100 pods on 120 nodes, 10 %
    of the bound pods deleted after each wave, 4 nodes cordoned before
    waves 2 and 3 (and the earlier ones uncordoned): equal bytes every
    wave, the node_unsched plane updated by the scatter."""
    def drive(store, svc):
        for _w in workloads.churn(store, 300, 120, 3, cordon=4):
            svc.schedule_pending(max_rounds=1)

    # the churn creates the nodes: the stores start empty
    port, got, want = run_pair(lambda store: None, drive, tie_break=tie, use_batch="auto", batch_min_work=0)
    assert_same(got, want)
    stats = port._batch_engine.encode_stats()
    assert port.stats["batch_commits"] == 3 and not port.stats["batch_fallbacks"]
    assert stats["device_scatter_updates_total"] >= 2 and stats["device_plane_reuses_total"] > 0
    assert all(node is not None for node, _a, _s in got.values())


def test_sequential_preemption_after_a_kernel_failure_matches_the_reference():
    """A high-priority pod that fits nowhere fails the kernel; under the
    default profile its PostFilter runs as the batched victim search
    (preemption/), which deletes a victim and nominates its node; the round
    restarts the kernel on the tail.  Equal store state and
    nominatedNodeName, no preemption fallback, at least one victim-search
    dispatch.  (The name predates the batched search: the sequential
    DefaultPreemption is now the path of pods outside its envelope,
    tests/test_torch_preemption.py's volumes case.)"""
    def build(store):
        for i in range(4):
            store.create("nodes", mk_node(f"node-{i}", 1000, 4096))
        for i in range(4):
            store.create("pods", mk_pod(f"low-{i}", cpu_m=800, mem_mi=256, nodeName=f"node-{i}", priority=0))
        store.create("pods", mk_pod("high", cpu_m=600, mem_mi=256, priority=100))
        for i in range(6):
            store.create("pods", mk_pod(f"small-{i}", cpu_m=100, mem_mi=64, priority=10))
        return {"percentageOfNodesToScore": 100}

    port, got, want = run_pair(build, lambda s, svc: svc.schedule_pending(max_rounds=1), tie_break="first",
                               use_batch="auto", batch_min_work=0)
    assert_same(got, want)
    deleted = {f"low-{i}" for i in range(4)} - got.keys()
    assert len(deleted) == 1 and got["high"][2].get("nominatedNodeName")
    assert port.stats["preempt_fallbacks"] == {} and port.stats["preempt_dispatches"] >= 1
    assert port.stats["preempt_nominations"] == 1 and port.stats["batch_pods"] > 0


def test_two_profiles_run_as_segments():
    """Pods of two profiles interleave in queue order: each maximal run is a
    segment on its profile's engine, with the rotation and attempt
    counters synced after each; equal bytes."""
    def build(store):
        _nodes(store, 16)
        import random

        rng = random.Random(3)
        for i in range(48):
            p = workloads.stamp(workloads.mk_pod(i, rng, spread=i % 4 == 0), i // 12)
            if (i // 12) % 2:
                p["spec"]["schedulerName"] = "packer"
            store.create("pods", p)
        packer = profile_with(["NodeResourcesFit", "TaintToleration", "NodeAffinity"])
        packer["schedulerName"] = "packer"
        packer["pluginConfig"] = [{"name": "NodeResourcesFit", "args": {"scoringStrategy": {"type": "MostAllocated"}}}]
        return {"profiles": [{"schedulerName": "default-scheduler"}, packer], "percentageOfNodesToScore": 100}

    port, got, want = run_pair(build, lambda s, svc: svc.schedule_pending(max_rounds=1), tie_break="reservoir",
                               use_batch="auto", batch_min_work=0)
    assert_same(got, want)
    assert set(port._batch_engines) == {"default-scheduler", "packer"} and not port.stats["batch_fallbacks"]


def test_the_port_refuses_what_it_has_not_ported(tmp_path):
    store = ClusterStore()
    for kw, what in (
        ({"mesh": object()}, "mesh"),
    ):
        with pytest.raises(ValueError, match=what):
            SchedulerService(store, device="cpu", **kw)
    # the weight override is ported: the knob is accepted, and a vector of
    # the wrong arity is refused when the profile is known
    with pytest.raises(ValueError, match="expected 7 weights"):
        SchedulerService(store, device="cpu", weights=[1.0]).start_scheduler(None)
    # the capacity engine is ported: the knob is accepted
    assert SchedulerService(store, device="cpu", autoscale="on").autoscaler is not None
    svc = SchedulerService(store, device="cpu", use_batch="auto")
    # the extender webhooks are ported: a stanza is accepted, and its
    # ExtenderService is shared by the profiles
    ext = SchedulerService(ClusterStore(), device="cpu")
    ext.start_scheduler({"extenders": [{"urlPrefix": "http://localhost:1", "filterVerb": "filter"}]})
    assert [e.name for e in ext.extender_service.extenders] == ["http://localhost:1"]
    assert ext.framework.extender_service is ext.extender_service
    # the gang path is ported: a Coscheduling profile starts and batches
    gang = profile_with(["NodeResourcesFit", "Coscheduling"])
    svc.start_scheduler({"profiles": [gang]})
    assert [wp.original.name for wp in svc.framework.plugins["permit"]] == ["Coscheduling"]

    class Gate:
        name = "Gate"

        def permit(self, state, pod, node_name):
            return None, 0

    # any other permit plugin starts too, and its rounds take the sequential
    # cycle with a counted reason, as in the reference
    svc.set_out_of_tree_registries({"Gate": lambda args, handle: Gate()})
    svc.start_scheduler({"profiles": [profile_with(["NodeResourcesFit", "Gate"])]})
    svc.batch_min_work = 0
    store.create("nodes", mk_node("node-0", 4000, 8192))
    store.create("pods", {"metadata": {"name": "p0"}, "spec": {"containers": [{"name": "c"}]}})
    svc.schedule_pending(max_rounds=1)
    assert svc.stats["batch_fallbacks"] == {"permit plugins ['Gate']": 1}
    assert store.get("pods", "p0")["spec"]["nodeName"] == "node-0"
    # the streaming pipeline is ported: a permit profile's wave drains to
    # the sequential path, counted by reason, as in the reference
    store.create("pods", {"metadata": {"name": "p1"}, "spec": {"containers": [{"name": "c"}]}})
    svc.schedule_stream()
    assert svc.stats["stream_drains"] == {"gang": 1} and svc.stats["stream_waves"] == 0
    assert store.get("pods", "p1")["spec"]["nodeName"] == "node-0"
    # the write-ahead journal is ported: the store attaches one, and each
    # mutation from then on is a durable record
    from kube_scheduler_simulator_tpu_torch.state.journal import Journal

    journal = Journal(str(tmp_path))
    store.attach_journal(journal)
    store.create("pods", {"metadata": {"name": "p2"}, "spec": {"containers": [{"name": "c"}]}})
    assert store.journal is journal and journal.stats["records"] == 1
    # the lifecycle is ported: a bad configuration rolls back, the reset
    # returns to the first configuration started, the loop runs and stops,
    # and metrics() answers
    with pytest.raises(KeyError, match="NoSuchPlugin"):
        svc.restart_scheduler({"profiles": [profile_with(["NoSuchPlugin"])]})
    assert [wp.original.name for wp in svc.framework.plugins["permit"]] == ["Gate"]
    svc.reset_scheduler_configuration()
    assert [wp.original.name for wp in svc.framework.plugins["permit"]] == ["Coscheduling"]
    svc.start_background(poll_interval=0.01)
    assert svc.is_background_running()
    svc.stop_background()
    assert not svc.is_background_running() and svc.metrics()["batch_fallbacks"] == svc.stats["batch_fallbacks"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SchedulerService(store)
