"""The shard mode of the CUDA kernels on the card: K2/K2w (csrc/scan_shard_
trace.cu, scan_shard_cluster.cu), K5 over each shard's node range and K8
(csrc/scan_shard_masked.cu), each held bitwise against its plain sharded
version (``ops/batch.scan_plain_sharded``, ``scan_lanes_plain_sharded``)
and against the unsharded kernel, at small sizes, with the shards of the
mesh on one card (``NodeMesh((cuda:0,) * n)``: the layout and the
in-launch exchange a mesh of cards runs).  Every test skips without a card;
the two-card case skips below two cards.  This file imports no JAX (the
card's machine has none): run it there with ``python -m pytest --noconftest
-m gpu tests/test_torch_shard_gpu.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu_torch import workloads
from kube_scheduler_simulator_tpu_torch.ops import batch as TB
from kube_scheduler_simulator_tpu_torch.ops import encode as TE
from kube_scheduler_simulator_tpu_torch.ops.mesh import NodeMesh

TOPO_SCORES = (
    ("NodeResourcesFit", 1), ("NodeResourcesBalancedAllocation", 1), ("ImageLocality", 1),
    ("TaintToleration", 3), ("NodeAffinity", 2), ("PodTopologySpread", 2), ("InterPodAffinity", 2),
)
SEVEN = ("NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodeResourcesFit",
         "PodTopologySpread", "InterPodAffinity")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    K.build()
    return torch.device("cuda", 0)


def _problem(n_pods, n_nodes, shards, dt, dev, volumes=False, seed=5):
    nodes, all_pods, pending = workloads.cluster(n_pods, n_nodes, seed=seed, n_bound=n_pods // 2,
                                                 spread=lambda i: i % 3 == 0, interpod=lambda i: i % 2 == 0)
    vols = None
    if volumes:
        workloads.add_host_ports(all_pods)
        vols = workloads.add_volumes(nodes, all_pods, n_pods // 2)
        pending = all_pods[n_pods // 2:]
    pr = TE.pad_problem(TE.encode(nodes, all_pods, pending, volumes=vols), node_multiple=shards)
    dp, dims = TB.lower(pr, dtype=dt, device=dev)
    return pr, dp, dims


def _same(got: dict, want: dict, keys=None):
    keys = keys or [k for k in want if k != "final_carry"]
    for k in keys:
        g, w = got[k], want[k]
        assert torch.equal(g.cpu(), w.cpu()), k


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("tie,trace,sampling", [
    ("first", True, False), ("reservoir", True, True), ("first", False, True), ("reservoir", False, False),
])
def test_sharded_scan_matches_plain_and_unsharded_on_the_card(shards, dt, tie, trace, sampling):
    dev = _card()
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    pr, dp, dims = _problem(23, 3000, shards, dt, dev)
    N = dims["N"]
    # sampling: the start in the last shard, so the sampled set wraps
    dp = dp._replace(sample_k=300 if sampling else pr.N_true, start0=N - N // shards // 2 if sampling else 0,
                     tb_base=4294967290)
    cfg = TB.BatchConfig(filters=SEVEN, scores=TOPO_SCORES, trace=trace, tie_break=tie, seed=7)
    ws0 = 512 if sampling and trace else None
    sp = TB.shard_device_problem(dp, NodeMesh((dev,) * shards))
    got = K.scan_sharded(cfg, dims, sp, ws0=ws0)
    want = K.scan(cfg, dims, dp, ws0=ws0)
    keys = [k for k in want if k != "final_carry"]
    _same(got, want, keys)
    plain = TB.scan_plain_sharded(cfg, dims, sp, ws0=ws0)
    _same(got, plain, keys)
    assert (want["selected"][:23] >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("n_pods", [1, 7])
def test_one_pod_and_odd_pod_counts_and_padding_shards_on_the_card(n_pods):
    """A round of one pod and one of an odd count (the mailbox is never reset
    within a launch), on 8 shards of which the last hold only padding."""
    dev = _card()
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    pr, dp, dims = _problem(n_pods, 5, 8, torch.float32, dev)
    cfg = TB.BatchConfig(filters=SEVEN, scores=TOPO_SCORES, trace=True, tie_break="reservoir", seed=3)
    sp = TB.shard_device_problem(dp, NodeMesh((dev,) * 8))
    got = K.scan_sharded(cfg, dims, sp)
    _same(got, K.scan(cfg, dims, dp))
    _same(got, TB.scan_plain_sharded(cfg, dims, sp))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_sharded_windows_chain_to_one_launch_on_the_card(dt):
    """Windows of 8 pods (K2w) hand on each shard's carry and equal the
    sharded one-launch round and the unsharded one, volumes included."""
    dev = _card()
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    pr, dp, dims = _problem(64, 700, 4, dt, dev, volumes=True)
    cfg = TB.BatchConfig(filters=tuple(TB.FILTER_KERNELS), scores=TOPO_SCORES, trace=True, tie_break="first", seed=1)
    sp = TB.shard_device_problem(dp, NodeMesh((dev,) * 4))
    one = K.scan_sharded(cfg, dims, sp)
    carry = None
    P, W = dims["P"], 8
    for off in range(0, P, W):
        w = K.scan_sharded(cfg, dims, sp, carry0=carry, offset=off, window=W)
        for k in ("fail_code", "fail_plug", "feasible"):
            assert torch.equal(w[k].cpu(), one[k][off:off + W].cpu()), k
        assert torch.equal(w["packed_pod"][:4].cpu(), one["packed_pod"][:4, off:off + W].cpu())
        carry = w["final_carry"]
    for k in ("final_requested", "final_pod_count", "final_spread_counts", "final_ip_sel", "final_csi_att"):
        assert torch.equal(w[k].cpu(), one[k].cpu()), k
    _same(one, K.scan(cfg, dims, dp))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_sharded_lanes_match_plain_and_unsharded_on_the_card(dt):
    """K8 over 4 shards: each lane's template rows cross shard boundaries,
    and one lane has no rows in some shards."""
    dev = _card()
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    pr, dp, dims = _problem(30, 200, 4, dt, dev)
    N = dims["N"]
    masks = np.zeros((5, N), dtype=bool)
    for g, (lo, hi) in enumerate(((0, 60), (40, 120), (100, 200), (7, 9), (150, 151))):
        masks[g, lo:hi] = True
    cfg = TB.BatchConfig(filters=SEVEN, scores=(("NodeResourcesFit", 1),), fit_strategy="MostAllocated",
                         trace=False, tie_break="first")
    want = K.scan_lanes(cfg, dims, dp, torch.from_numpy(masks).to(dev))
    sp = TB.shard_device_problem(dp, NodeMesh((dev,) * 4))
    Ns = N // 4
    lanes = [torch.from_numpy(masks[:, s * Ns:(s + 1) * Ns].copy()).to(dev) for s in range(4)]
    got = K.scan_lanes_sharded(cfg, dims, sp, lanes)
    keys = ["packed_pod", "final_requested", "final_nonzero", "final_pod_count", "final_spread_counts",
            "final_ip_sel", "final_start"]
    _same(got, want, keys)
    _same(got, TB.scan_lanes_plain_sharded(cfg, dims, sp, lanes), keys)


@pytest.mark.gpu
def test_sharded_victim_search_matches_unsharded_on_the_card():
    dev = _card()
    from kube_scheduler_simulator_tpu_torch.preemption import kernel as PK
    from kube_scheduler_simulator_tpu_torch.preemption.encode import PreemptionProblem

    rng = np.random.default_rng(3)
    N, V, R, U = 37, 4, 2, 5
    pr = PreemptionProblem([f"n{i}" for i in range(N)], ["cpu", "memory"])
    pr.alloc = rng.integers(8, 16, (N, R)).astype(np.int64)
    pr.base_req = rng.integers(0, 8, (N, R)).astype(np.int64)
    pr.base_cnt = rng.integers(0, 3, N).astype(np.int64)
    pr.max_pods = np.full(N, 10, dtype=np.int64)
    pr.vreq = rng.integers(1, 4, (N, V, R)).astype(np.int64)
    pr.vprio = rng.integers(0, 3, (N, V)).astype(np.int64)
    pr.vstart = np.zeros((N, V), dtype=np.int64)
    pr.vvalid = rng.random((N, V)) < 0.8
    pr.vmatch = rng.random((N, V, 1)) < 0.5
    pr.allowed = np.array([1], dtype=np.int32)
    pr.victim_pods = [[None] * V for _ in range(N)]
    pr.res_idx, pr.V, pr.PDB = {"cpu": 0, "memory": 1}, V, 1
    ucand = rng.random((U, N)) < 0.7
    ureq = rng.integers(2, 9, (U, R))
    uprio = np.full(U, 5, dtype=np.int64)
    snode = np.array([3, 20, 36], dtype=np.int32)
    sreq = rng.integers(1, 3, (3, R))
    smask = rng.random((U, 3)) < 0.6
    want = PK.run_search(pr, ucand, ureq, uprio, smask, sreq, snode, device=dev)
    for n in (2, 4):
        got = PK.run_search(pr, ucand, ureq, uprio, smask, sreq, snode, device=dev, mesh=NodeMesh((dev,) * n))
        for k in ("cand", "victims", "viol"):
            assert np.array_equal(got[k], want[k]), (n, k)


@pytest.mark.gpu
def test_shards_that_cannot_be_resident_are_refused_on_the_card():
    """More (shard, lane) blocks than the card holds at once: refused before
    the launch with KernelArgumentError, never a hang."""
    dev = _card()
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    pr, dp, dims = _problem(4, 8, 2, torch.float32, dev)
    cfg = TB.BatchConfig(filters=SEVEN[:5], scores=(("NodeResourcesFit", 1),), trace=False, tie_break="first")
    sp = TB.shard_device_problem(dp, NodeMesh((dev,) * 2))
    G = 5000
    lanes = [torch.ones((G, dims["N"] // 2), dtype=torch.bool, device=dev) for _ in range(2)]
    with pytest.raises(K.KernelArgumentError, match="resident"):
        K.scan_lanes_sharded(cfg, dims, sp, lanes)


@pytest.mark.gpu
def test_more_shard_clusters_than_the_card_holds_are_refused_on_the_card():
    """The cluster mode's refusal (cudaOccupancyMaxActiveClusters): more
    one-block shard clusters than the card's SMs can hold at once (2 048
    threads an SM) raise KernelArgumentError before any launch."""
    dev = _card()
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    n = 2048 // K.SCAN_THREADS * torch.cuda.get_device_properties(dev).multi_processor_count + 1
    pr, dp, dims = _problem(4, 8, n, torch.float32, dev)
    cfg = TB.BatchConfig(filters=SEVEN[:5], scores=(("NodeResourcesFit", 1),), trace=False, tie_break="first")
    sp = TB.shard_device_problem(dp, NodeMesh((dev,) * n))
    before = dict(K.LAUNCHES)
    with pytest.raises(K.KernelArgumentError, match="resident"):
        K.scan_sharded(cfg, dims, sp)
    assert K.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [False, True])
def test_a_shard_that_never_answers_raises_at_the_cap_on_the_card(monkeypatch, lanes):
    """Shard 1 of 3 left out of the launch: the other two reach the wait's
    cap on its flags, run to the launch's end, and the wrapper raises
    KernelLaunchError naming it; the next launch on the card is right."""
    dev = _card()
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    pr, dp, dims = _problem(5, 12, 3, torch.float32, dev)
    sp = TB.shard_device_problem(dp, NodeMesh((dev,) * 3))
    Ns = dims["N"] // 3
    cfg = TB.BatchConfig(filters=SEVEN, scores=(("NodeResourcesFit", 1),), trace=not lanes, tie_break="first")
    masks = [torch.ones((4, Ns), dtype=torch.bool, device=dev) for _ in range(3)]
    run = (lambda: K.scan_lanes_sharded(cfg, dims, sp, masks)) if lanes else (lambda: K.scan_sharded(cfg, dims, sp))
    monkeypatch.setattr(K, "SHARD_SPIN_CAP", 2000)
    monkeypatch.setattr(K, "SILENT_SHARD", 1)
    with pytest.raises(K.KernelLaunchError, match=r"shards \[1\]"):
        run()
    monkeypatch.undo()
    got = run()
    if lanes:
        want = K.scan_lanes(cfg, dims, dp, torch.ones((4, dims["N"]), dtype=torch.bool, device=dev))
        _same(got, want, ["packed_pod", "final_requested", "final_pod_count"])
    else:
        _same(got, K.scan(cfg, dims, dp))


@pytest.mark.gpu
def test_a_mesh_of_two_cards_matches_one_card():
    """The peer-mapped mailbox across two cards (skips below two)."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the mailbox across cards maps the first card's memory as a peer")
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    pr, dp, dims = _problem(23, 1300, 2, torch.float32, d0)
    cfg = TB.BatchConfig(filters=SEVEN, scores=TOPO_SCORES, trace=True, tie_break="first", seed=7)
    got = K.scan_sharded(cfg, dims, TB.shard_device_problem(dp, NodeMesh((d0, d1))))
    _same(got, K.scan(cfg, dims, dp))
