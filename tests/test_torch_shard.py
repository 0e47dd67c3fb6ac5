"""The node axis sharded over a mesh: the port against its own single-device
run and against the JAX package's sharded run (tests/test_shard.py).

Each round runs three times on the same store contents: the port on one
device, the port on an explicit ``NodeMesh`` of n CPU shards (the port's
CPU is one device, so the shards share it, as the reference's tests share
8 virtual CPU devices), and the JAX package on ``cpu_mesh(n)`` under
``jax.enable_x64(True)`` (float64, the port's CPU dtype); the annotation
bytes (``pod_parity_state``) must be equal.  On the CPU a mesh runs
``ops/batch.scan_plain_sharded``: each pod's step shard by shard, the
cross-shard reductions through the shard combines, never ``scan_plain`` on
the concatenated problem.  The victim search and the estimator on a
4-shard mesh are held over randomized churn as the reference's are.  The
``gpu``-marked tests hold the CUDA shard mode (csrc/scan_shard_*.cu)
against ``scan_plain_sharded`` and the unsharded kernel, and skip without
a card.
"""

from __future__ import annotations

import random
import sys
from pathlib import Path
from typing import Any

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from kube_scheduler_simulator_tpu.scheduler.batch_engine import BatchEngine as JaxEngine  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from kube_scheduler_simulator_tpu.utils.parity import pod_parity_state as jax_parity_state  # noqa: E402
from test_batch_parity import mk_node, mk_pod, profile_with  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import encode as TE  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops.mesh import NodeMesh  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine, MeshStreamNotPorted  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state  # noqa: E402

Obj = dict[str, Any]
CPU = torch.device("cpu")

FIVE = ["NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodeResourcesFit",
        "NodeResourcesBalancedAllocation", "ImageLocality"]
SEVEN = FIVE + ["PodTopologySpread", "InterPodAffinity"]


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def cpu_mesh(n: int):
    from jax.sharding import Mesh

    devices = jax.devices("cpu")
    assert len(devices) >= n, "tests/conftest.py forces an 8-device virtual CPU mesh"
    return Mesh(np.array(devices[:n]), ("nodes",))


def port_mesh(n: int) -> NodeMesh:
    return NodeMesh((CPU,) * n)


def _stamp(p: Obj, i: int) -> Obj:
    p["metadata"]["creationTimestamp"] = f"2024-01-01T00:{i // 60:02d}:{i % 60:02d}Z"
    return p


def three_runs(build, n: int, drive=None, jax_too: bool = True, port_kw=None, **svc_kw):
    """(single-device port state, sharded port state, sharded JAX state, the
    sharded port service) of one store built by ``build(store) -> config``
    and driven by ``drive(store, svc)`` (default: one round)."""
    drive = drive or (lambda store, svc: svc.schedule_pending(max_rounds=1))
    runs = [(SchedulerService, ClusterStore, dict(device="cpu", mesh=None, **(port_kw or {})), pod_parity_state),
            (SchedulerService, ClusterStore, dict(device="cpu", mesh=port_mesh(n), **(port_kw or {})),
             pod_parity_state)]
    if jax_too:
        runs.append((JaxService, JaxStore, dict(mesh=cpu_mesh(n)), jax_parity_state))
    out, svcs = [], []
    for Svc, Store, extra, state in runs:
        store = Store(clock=lambda: 0.0)
        cfg = build(store)
        svc = Svc(store, **svc_kw, **extra)
        svc.start_scheduler(cfg)
        drive(store, svc)
        out.append(state(store))
        svcs.append(svc)
    return (*out, *([None] * (3 - len(out))), svcs[1])


def assert_equal_states(*states):
    want = states[0]
    for got in states[1:]:
        if got is None:
            continue
        assert got.keys() == want.keys()
        bad = [k for k in want if got[k] != want[k]]
        assert not bad, (len(bad), bad[:3])


# ------------------------------------------------------- the boundary


def test_service_mesh_plumbing_and_metrics():
    """13 nodes on a 4-shard mesh (the engine pads the node axis to 16): the
    round equals the single-device one and the JAX package's on cpu_mesh(4),
    and the mesh's counters land in metrics() and /metrics."""
    def build(store):
        for i in range(13):
            store.create("nodes", mk_node(f"n-{i}", cpu_m=4000, mem_mi=8192))
        rng = random.Random(5)
        for i in range(30):
            store.create("pods", _stamp(mk_pod(f"p-{i}", cpu_m=rng.choice([100, 200, 400]), mem_mi=128), i))
        return None

    one, sharded, ref, svc = three_runs(build, 4, tie_break="first", use_batch="force", batch_min_work=0)
    assert_equal_states(one, sharded, ref)
    m = svc.metrics()
    assert m["shard_devices"] == 4 and m["sharded_dispatches_total"] >= 1
    assert 0 < m["plane_shard_bytes_per_device"] < m["device_bytes_uploaded_total"]
    assert not svc.stats["batch_fallbacks"]

    class _DI:
        def __init__(self, s):
            self._svc = s
            self.cluster_store = s.cluster_store

        def scheduler_service(self):
            return self._svc

    from kube_scheduler_simulator_tpu_torch.server.metrics import render_metrics

    text = render_metrics(_DI(svc))
    assert "simulator_shard_devices 4" in text
    assert "simulator_sharded_dispatches_total" in text and "simulator_plane_shard_bytes_per_device" in text


def test_field_sharding_non_divisible_is_a_clear_error():
    with pytest.raises(ValueError, match="not divisible"):
        TB.field_sharding(port_mesh(8), "alloc", np.zeros((13, 2)))
    assert TB.field_sharding(port_mesh(4), "gdom", np.zeros((3, 16))) == 1
    assert TB.field_sharding(port_mesh(4), "pod_req", np.zeros((5, 2))) is None
    with pytest.raises(ValueError, match="not divisible"):
        TB.shard_host({"alloc": np.zeros((10, 2))} | {k: np.zeros((3, 10)) for k in ("gdom",)}, 4)


def test_the_stream_over_a_mesh_is_not_ported():
    """schedule_async and a StreamSession on a mesh raise the 7c error rather
    than run unsharded."""
    store = ClusterStore()
    for i in range(4):
        store.create("nodes", mk_node(f"n-{i}", cpu_m=4000, mem_mi=8192))
    store.create("pods", _stamp(mk_pod("p-0", cpu_m=100, mem_mi=64), 0))
    eng = BatchEngine(device="cpu", trace=True, scores=[("NodeResourcesFit", 1)], mesh=port_mesh(2))
    with pytest.raises(MeshStreamNotPorted, match="ROADMAP 7c"):
        eng.schedule_async(store.list("nodes"), store.list("pods"), store.list("pods"))
    svc = SchedulerService(store, device="cpu", mesh=port_mesh(2), use_batch="force", batch_min_work=0)
    svc.start_scheduler(None)
    with pytest.raises(MeshStreamNotPorted, match="ROADMAP 7c"):
        svc.schedule_stream(max_waves=1)
    assert svc.metrics()["shard_devices"] == 2


# ------------------------------------------------------- round parity


def _cluster(store, n_nodes: int, n_pods: int, spread=lambda i: False, interpod=lambda i: False, seed: int = 3):
    rng = random.Random(seed)
    for i in range(n_nodes):
        store.create("nodes", workloads.mk_node(i))
    for i in range(n_pods):
        store.create("pods", workloads.stamp(workloads.mk_pod(i, rng, spread=spread(i), interpod=interpod(i)), i))


ROUNDS = {
    # name: (profile plugins, nodes, pods, spread, interpod, percentage)
    "five": (FIVE, 37, 40, lambda i: False, lambda i: False, None),
    "seven": (SEVEN, 29, 36, lambda i: i % 3 == 0, lambda i: i % 2 == 0, None),
    # 5 nodes on 8 shards: shards 5-7 hold only padding
    "padding-shards": (SEVEN, 5, 12, lambda i: i % 2 == 0, lambda i: True, None),
    # sampling: 150 nodes, 50 % scored (the 100-node floor), start rotating
    "sampling": (FIVE, 150, 30, lambda i: False, lambda i: False, 50),
}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_round_parity(name, n):
    plugins, n_nodes, n_pods, spread, interpod, pct = ROUNDS[name]

    def build(store):
        _cluster(store, n_nodes, n_pods, spread, interpod)
        cfg = {"profiles": [profile_with(plugins)]}
        if pct is not None:
            cfg["percentageOfNodesToScore"] = pct
        return cfg

    # the JAX package's sharded run at every mesh size of the five-plugin
    # round, and at 4 shards elsewhere (its compiles dominate the test's time)
    jax_too = name == "five" or n == 4
    one, sharded, ref, svc = three_runs(build, n, jax_too=jax_too, tie_break="reservoir", use_batch="force",
                                        batch_min_work=0)
    assert_equal_states(one, sharded, ref)
    assert svc.metrics()["sharded_dispatches_total"] >= 1 and not svc.stats["batch_fallbacks"]
    assert sum(v[0] is not None for v in one.values()) > 0


def test_round_parity_ports_and_volumes():
    """Host ports and the volume filters (every carry of the default
    profile) on a 4-shard mesh."""
    def build(store):
        nodes, all_pods, _pending = workloads.cluster(30, 24, seed=9, n_bound=10)
        workloads.add_host_ports(all_pods)
        vols = workloads.add_volumes(nodes, all_pods, 10)
        for kind, objs in vols.items():
            for o in objs:
                store.create(kind, o)
        for o in nodes:
            store.create("nodes", o)
        for o in all_pods:
            store.create("pods", o)
        return None

    one, sharded, ref, svc = three_runs(build, 4, tie_break="first", use_batch="force", batch_min_work=0)
    assert_equal_states(one, sharded, ref)
    assert not svc.stats["batch_fallbacks"]


def test_sampling_start_in_the_last_shard_wraps_across_the_boundary():
    """Rounds of churn move the rotation start: a round whose start lies in
    the last shard samples across the wrap into shard 0."""
    starts = []

    def drive(store, svc):
        rng = random.Random(11)
        for wave in range(4):
            for i in range(12):
                k = 100 + wave * 12 + i
                store.create("pods", workloads.stamp(workloads.mk_pod(k, rng), k))
            svc.schedule_pending(max_rounds=1)
            starts.append(getattr(svc, "next_start_node_index", None))

    def build(store):
        _cluster(store, 120, 0)
        return {"percentageOfNodesToScore": 50}

    one, sharded, ref, _svc = three_runs(build, 4, drive=drive, tie_break="first", use_batch="force",
                                         batch_min_work=0)
    assert_equal_states(one, sharded, ref)


def test_equal_top_scores_on_both_sides_of_a_boundary():
    """Identical nodes: every pod's top score ties across every shard
    boundary; both tie-breaks pick the reference's node."""
    for tie in ("first", "reservoir"):
        def build(store):
            for i in range(16):
                store.create("nodes", mk_node(f"n-{i:02d}", cpu_m=8000, mem_mi=16384))
            for i in range(20):
                store.create("pods", _stamp(mk_pod(f"p-{i}", cpu_m=300, mem_mi=64), i))
            return None

        one, sharded, ref, _svc = three_runs(build, 4, tie_break=tie, use_batch="force", batch_min_work=0)
        assert_equal_states(one, sharded, ref)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_windows_of_a_few_pods_chain_shard_for_shard(dtype):
    """The engine's windows on a mesh (K2w): windows of 8 pods hand on each
    shard's carry, shard for shard; every window's decisions and annotations
    equal the one-launch single-device round's, in float64 and float32."""
    nodes, all_pods, pending = workloads.cluster(30, 40, seed=4, n_bound=8, spread=lambda i: i % 3 == 0,
                                                 interpod=lambda i: i % 2 == 0)
    scores = [("NodeResourcesFit", 1), ("TaintToleration", 3), ("PodTopologySpread", 2), ("InterPodAffinity", 2)]
    kw = dict(device="cpu", trace=True, scores=scores, dtype=dtype, tie_break="reservoir", seed=3,
              percentage_of_nodes_to_score=50)
    want = BatchEngine(**kw).schedule(nodes, all_pods, pending, start_index=7)
    eng = BatchEngine(mesh=port_mesh(4), **kw)
    got = list(eng.schedule_waves(nodes, all_pods, pending, start_index=7, wave_pods=8))
    assert len(got) > 1 and eng.sharded_dispatches == 1
    for res, off, cnt in got:
        for j in range(cnt):
            assert res.selected[j] == want.selected[off + j]
            assert res.filter_annotation_json(j) == want.filter_annotation_json(off + j)
            assert res.score_annotations_json(j) == want.score_annotations_json(off + j)


def test_float32_round_parity():
    """The reference's float32 regime (x64 off) against the port's float32
    CPU run on a 4-shard mesh and on one device."""
    def build(store):
        _cluster(store, 29, 30, lambda i: i % 3 == 0, lambda i: i % 2 == 0)
        return {"profiles": [profile_with(SEVEN)]}

    with jax.enable_x64(False):
        one, sharded, ref, _svc = three_runs(build, 4, port_kw={"dtype": torch.float32}, tie_break="first",
                                             use_batch="force", batch_min_work=0)
    assert_equal_states(one, sharded, ref)


# ------------------------------------------------------- the combines


def test_shard_combines_on_their_edge_cases():
    # visit order: every first run (ids >= start) in shard order, then the second runs
    hi_off, lo_off, total = TB.shard_visit_offsets([2, 0, 3], [1, 4, 0])
    assert hi_off == [0, 2, 2] and lo_off == [5, 6, 10] and total == 10
    # a shard of only padding publishes neutral partials
    assert TB.shard_visit_offsets([0, 0], [0, 0]) == ([0, 0], [0, 0], 0)
    assert TB.shard_exclusive_scan([3, 0, 2]) == ([0, 3, 3], 5)
    assert TB.shard_kth_rank([0, 17, 0]) == 17
    # equal top totals on both sides: the least visit rank wins
    assert TB.shard_best([(5.0, 9), (5.0, 3), (4.0, 0)]) == (5.0, 3)
    assert TB.shard_best([(-1e18, 2**31 - 1), (7.0, 40)]) == (7.0, 40)
    assert TB.shard_min([float("inf"), 3.0]) == 3.0 and TB.shard_max([float("-inf"), -2.0]) == -2.0
    sums = TB.shard_domain_sums([torch.tensor([1.0, 0.0]), torch.tensor([2.0, 5.0])])
    assert sums.tolist() == [3.0, 5.0]


@pytest.mark.parametrize("n,start,tie", [(2, 0, "first"), (4, 33, "reservoir"), (8, 35, "first"), (4, 38, "reservoir")])
def test_plain_sharded_scan_equals_the_plain_scan(n, start, tie):
    """scan_plain_sharded against scan_plain on one problem, every output
    and the final carry, with the start in the last shard (35, 38 of 40
    nodes), sampling narrowing the nodes (in-step compaction) and one pod."""
    nodes, all_pods, pending = workloads.cluster(24, 37, seed=5, n_bound=20, spread=lambda i: i % 3 == 0,
                                                 interpod=lambda i: True)
    del nodes[13]["metadata"]["labels"]["topology.kubernetes.io/zone"]
    cfg = TB.BatchConfig(filters=tuple(TB.FILTER_KERNELS), scores=(
        ("NodeResourcesFit", 1), ("NodeResourcesBalancedAllocation", 1), ("ImageLocality", 1),
        ("TaintToleration", 3), ("NodeAffinity", 2), ("PodTopologySpread", 2), ("InterPodAffinity", 2)),
        trace=True, tie_break=tie, seed=7)
    for p_count in (len(pending), 1):
        pr = TE.pad_problem(TE.encode(nodes, all_pods, pending[:p_count]), node_multiple=n)
        dp, dims = TB.lower(pr, dtype=torch.float64, device="cpu")
        dp = dp._replace(sample_k=20, start0=start, tb_base=4294967290)
        want = TB.scan_plain(cfg, dims, dp, ws0=24)
        got = TB.scan_plain_sharded(cfg, dims, TB.shard_device_problem(dp, port_mesh(n)), ws0=24)
        for k, v in want.items():
            if k != "final_carry":
                assert torch.equal(got[k], v), k


# ------------------------------------------- preemption and the estimator


def _preempt_cluster(store, seed: int, n_nodes: int) -> None:
    rng = random.Random(seed)
    for i in range(n_nodes):
        store.create("nodes", mk_node(f"node-{i}", cpu_m=1000, mem_mi=2048))
    k = 0
    for i in range(n_nodes):
        for j in range(rng.choice([1, 2])):
            v = mk_pod(f"victim-{i}-{j}", cpu_m=rng.choice([400, 500]), mem_mi=128, labels={"app": f"a{i % 3}"})
            v["spec"]["nodeName"] = f"node-{i}"
            v["spec"]["priority"] = rng.choice([0, 10])
            v.setdefault("status", {})["startTime"] = f"2024-01-01T01:00:{k % 60:02d}Z"
            store.create("pods", _stamp(v, k))
            k += 1
    store.create("poddisruptionbudgets", {
        "metadata": {"name": "pdb-a0", "namespace": "default"},
        "spec": {"maxUnavailable": 1, "selector": {"matchLabels": {"app": "a0"}}},
    })
    for i in range(3):
        vip = mk_pod(f"vip-{i}", cpu_m=rng.choice([600, 700]), mem_mi=64)
        vip["spec"]["priority"] = 1000
        store.create("pods", _stamp(vip, 100 + i))


@pytest.mark.parametrize("seed,n_nodes", [(11, 7), (12, 8)])
def test_preemption_sharded_parity_randomized_churn(seed, n_nodes):
    """The victim search on a 4-shard mesh (7 nodes: the last shard short)
    equals the unsharded search and the reference's sharded one over churn."""
    def build(store):
        _preempt_cluster(store, seed, n_nodes)
        return {"percentageOfNodesToScore": 100}

    def drive(store, svc):
        svc.schedule_pending(max_rounds=1)
        for nm in sorted(
            p["metadata"]["name"] for p in store.list("pods")
            if p["metadata"]["name"].startswith("victim") and p["spec"].get("nodeName")
        )[:2]:
            store.delete("pods", nm, "default")
        extra = mk_pod("vip-late", cpu_m=500, mem_mi=64)
        extra["spec"]["priority"] = 2000
        store.create("pods", _stamp(extra, 200))
        svc.schedule_pending(max_rounds=1)

    one, sharded, ref, svc = three_runs(build, 4, drive=drive, tie_break="first", use_batch="auto",
                                        batch_min_work=0)
    assert_equal_states(one, sharded, ref)
    assert svc.stats["preempt_sharded_dispatches"] >= 1 and svc.stats["preempt_nominations"] >= 1


@pytest.mark.parametrize("seed", [3, 4])
def test_estimator_sharded_parity_randomized_churn(seed):
    """Scale-up estimates on a 4-shard mesh equal the unsharded dispatch's
    and the reference's sharded ones as groups and pending pods churn."""
    from test_autoscaler import mk_group, mk_pod as as_pod

    from kube_scheduler_simulator_tpu.autoscaler.engine import ClusterAutoscaler as JaxAutoscaler
    from kube_scheduler_simulator_tpu_torch.autoscaler.engine import ClusterAutoscaler

    def run(Svc, Store, Asc, extra):
        rng = random.Random(seed)
        store = Store()
        store.create("nodegroups", mk_group("small", mx=6, cpu="2000m", mem="4Gi"))
        store.create("nodegroups", mk_group("big", mx=5, cpu="8000m", mem="16Gi"))
        svc = Svc(store, tie_break="first", use_batch="off", **extra)
        svc.start_scheduler(None)
        for i in range(rng.choice([5, 7])):
            store.create("pods", as_pod(f"p{i}", cpu=f"{rng.choice([500, 1500])}m"))
        svc.schedule_pending(max_rounds=1)
        asc = Asc(store, svc)
        groups = lambda: sorted(asc.node_groups(), key=lambda g: g["metadata"]["name"])  # noqa: E731
        est1 = asc._estimator_for(svc.framework).estimate(groups(), {"small": 6, "big": 5},
                                                          svc.framework.sort_pods(svc.pending_pods()))
        for i in range(3):
            store.create("pods", as_pod(f"q{i}", cpu="1200m"))
        est2 = asc._estimator_for(svc.framework).estimate(groups(), {"small": 2, "big": 5},
                                                          svc.framework.sort_pods(svc.pending_pods()))
        return [e.__dict__ for e in est1 + est2], asc._estimator

    r1, e1 = run(SchedulerService, ClusterStore, ClusterAutoscaler, {"device": "cpu", "mesh": None})
    r2, e2 = run(SchedulerService, ClusterStore, ClusterAutoscaler, {"device": "cpu", "mesh": port_mesh(4)})
    r3, e3 = run(JaxService, JaxStore, JaxAutoscaler, {"mesh": cpu_mesh(4)})
    assert e2.sharded_dispatches == 2 and e1.sharded_dispatches == 0 and e3.sharded_dispatches == 2
    assert e1.kernel_errors == 0 and e2.kernel_errors == 0
    assert all(e["method"] == "xla-batch" for e in r1)
    assert r1 == r2 == r3
    assert e2.shard_plane_bytes_per_device > 0


# ---- the shard mode's launch order across cards, with the CUDA calls
# stubbed: two fake cards (CPU devices 0 and 1), a shard each


class _Stream:
    def __init__(self, log, dev):
        self.log, self.dev, self.cuda_stream = log, dev, 0

    def synchronize(self):
        # the first shard's device (the mailbox's) is the plain CPU: card 0
        self.log.append(("sync", self.dev.index or 0))


def _fake_cards(monkeypatch, rc):
    """``kernels._scan_setup`` and the CUDA calls stubbed: shard s of a
    two-shard problem on fake card s; the entry returns ``rc(card, check)``
    and logs each call.  Returns (the log, each shard's mailbox part)."""
    import contextlib
    import types

    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    log, parts = [], []
    cards = [torch.device("cpu", 0), torch.device("cpu", 1)]

    def entry(card):
        def fn(h, d, n_local, blocks, stream):
            log.append(("check" if d is None else "launch", card.index))
            return rc(card.index, d is None)
        return fn

    def setup(cfg, sdims, dp, blocks, ws0, carry0, offset, window, lane_active=None, tile=None, shard=None,
              weights=None):
        parts.append(shard)
        card = cards[shard["shard"]]
        return entry(card), K.ScanArgs(), 1, {"_shard": shard["shard"]}, None, False, card

    monkeypatch.setattr(K, "_scan_setup", setup)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream(log, dev))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "a fake card")
    sp = types.SimpleNamespace(shards=[types.SimpleNamespace(alloc=torch.zeros(2)) for _ in cards])
    cfg = TB.BatchConfig(filters=("NodeResourcesFit",), scores=(("NodeResourcesFit", 1),), trace=False)
    dims = dict(N=4, P=3, KC=0, KS=0, G=0, key_struct=[])
    return log, parts, lambda: K.scan_sharded(cfg, dims, sp)


def test_every_card_is_checked_before_any_card_launches(monkeypatch):
    """The second card's co-residency refusal comes before the first card
    launches: nothing runs, nothing waits."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    log, _parts, run = _fake_cards(monkeypatch, lambda card, check: K.RC_NOT_RESIDENT if card == 1 else 0)
    with pytest.raises(K.KernelArgumentError, match="resident"):
        run()
    assert log == [("check", 0), ("check", 1)]


def test_a_launch_refused_on_one_card_waits_for_the_cards_already_launched(monkeypatch):
    """The second card's launch fails after the first card's ran: the first
    card is synchronized (its waits end at their cap) before the error
    propagates, so none of the first card's mailbox is freed under it."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    log, _parts, run = _fake_cards(monkeypatch, lambda card, check: 2 if card == 1 and not check else 0)
    before = dict(K.LAUNCHES)
    with pytest.raises(K.KernelLaunchError, match="cudaError 2"):
        run()
    assert log[:5] == [("check", 0), ("check", 1), ("sync", 0), ("launch", 0), ("launch", 1)]
    assert ("sync", 0) in log[5:]
    assert K.LAUNCHES == before


def test_a_shard_marked_dead_in_the_mailbox_raises_naming_it(monkeypatch):
    """A launch whose waits on shard 1 reached their cap (its error word
    set): every card synchronized, then KernelLaunchError names the shard;
    the mailbox starts zeroed."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    def rc(card, check):
        if not check and card == 1:
            assert not parts[0]["mbox"].any() and not parts[0]["mbox_flags"].any()
            parts[0]["mbox_err"][1] = 1
        return 0

    log, parts, run = _fake_cards(monkeypatch, rc)
    with pytest.raises(K.KernelLaunchError, match=r"shards \[1\]"):
        run()
    assert log[-2:] == [("sync", 0), ("sync", 1)]
