"""The CUDA kernels' binding, and the kernels against their plain versions.

No JAX here, so the tests marked ``gpu`` run on a machine with a card and
no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py tests/test_torch_isolation.py

On a machine without a card they skip; the binding checks run anywhere.
"""

from __future__ import annotations

import ctypes
import itertools
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import encode as TE  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import kernels as TK  # noqa: E402

SCORES = (
    ("NodeResourcesFit", 1),
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("TaintToleration", 3),
    ("NodeAffinity", 2),
)
TOPO_SCORES = SCORES + (("PodTopologySpread", 2), ("InterPodAffinity", 2))
SEVEN_FILTERS = (
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodeResourcesFit",
    "PodTopologySpread", "InterPodAffinity",
)
# upstream's default profile: the registry's filter order, its scores and weights
REGISTRY_FILTERS = (
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
    "VolumeRestrictions", "EBSLimits", "GCEPDLimits", "NodeVolumeLimits", "AzureDiskLimits",
    "VolumeBinding", "VolumeZone", "PodTopologySpread", "InterPodAffinity",
)
DEFAULT_SCORES = (
    ("TaintToleration", 3), ("NodeAffinity", 2), ("NodeResourcesFit", 1), ("PodTopologySpread", 2),
    ("InterPodAffinity", 2), ("NodeResourcesBalancedAllocation", 1), ("ImageLocality", 1),
)


def _struct_fields(src: str, name: str) -> "list[str]":
    """Field names of a C struct in declaration order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            _type, names = re.match(r"((?:const )?\w+\*?)\s+(.*)", decl).groups()
            fields += [re.sub(r"[\s*]|\[.*\]", "", n) for n in names.split(",")]
    return fields


@pytest.mark.parametrize(
    "src,struct",
    [("scan.cu", "ScanArgs"), ("compact.cu", "CompactArgs"), ("preempt.cu", "PreemptArgs"),
     ("gang.cu", "GangVerdictArgs"), ("gang.cu", "GangFeasArgs"), ("tune.cu", "ObjArgs"),
     ("tune.cu", "ContractArgs")],
)
def test_ctypes_mirror_matches_the_cuda_struct(src, struct):
    """The argument structs are read by field order: the ctypes mirror and
    the CUDA declaration list the same fields in the same order, each 8
    bytes wide, so neither side has padding."""
    text = (TK.CSRC / src).read_text()
    mirror = getattr(TK, struct)
    assert _struct_fields(text, struct) == [f for f, _t in mirror._fields_]
    for f, t in mirror._fields_:
        base = t._type_ if issubclass(t, ctypes.Array) else t
        assert base in (TK._i64, TK._f64, TK._ptr), f


def _search_args(U, N, V, R, PDB, S, dt, device, seed=0):
    """Seeded arguments of the victim search (kernels.preempt, preempt_plain):
    integer-valued requests, slots a prefix of each node's row, mixed
    priorities with ties, budgets of 0-2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_valid = rng.integers(0, V + 1, N)
    vvalid = np.arange(V)[None, :] < n_valid[:, None]
    vreq = rng.integers(0, 5, (N, V, R)) * vvalid[..., None]
    base_req = vreq.sum(axis=1) + rng.integers(0, 3, (N, R))
    base_cnt = n_valid + rng.integers(0, 3, N)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)  # noqa: E731
    t = lambda a, d: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=d)  # noqa: E731
    return (
        t(rng.random((U, N)) < 0.8, torch.bool), f(rng.integers(0, 6, (U, R))), t(rng.integers(1, 6, U), torch.int64),
        t(rng.random((U, S)) < 0.6, torch.bool), f(rng.integers(0, 3, (S, R))), t(rng.integers(0, N, S), torch.int32),
        f(base_req + rng.integers(-2, 6, (N, R))), f(base_req), f(rng.integers(0, 2, (N, R))), f(base_cnt),
        f(rng.integers(0, 2, N)), f(base_cnt + rng.integers(0, 4, N)), f(vreq),
        t(np.where(vvalid, -np.sort(-rng.integers(0, 6, (N, V)), axis=1), 0), torch.int64), t(vvalid, torch.bool),
        t((rng.random((N, V, PDB)) < 0.45) & vvalid[..., None], torch.bool), t(rng.integers(0, 3, PDB), torch.int32),
    )


@pytest.mark.parametrize("N,lanes,C", [
    (160, 3, 1),      # cfg6-autoscale's first estimate: one tile, one block a lane
    (1024, 16, 1),    # the autoscale burst: two tiles, one block a lane
    (1280, 16, 3),    # cfg10-tune-10k's population
    (1280, 1, 3),     # the grad tuner's one-lane evaluation and grad forward
    (4096, 16, 8),    # 3 585 nodes padded: eight tiles, at most 8 blocks a cluster
    (5120, 16, 5),    # ten tiles over at most 8 blocks: two a block, so 5
    (40960, 1, 16),   # one lane: at most 16 blocks (a non-portable size)
    (12288, 1, 12),
    (4096, 40, 3),    # 132 SMs shared by 40 lanes
    (1536, 50, 2),
    (1280, 100, 1),
    # the one-lane scan at every path shape (nodes padded by encode._bucket)
    (512, 1, 1),      # cfg2: 500 nodes
    (5120, 1, 10),    # north, cfg4, cfg5-vol, the churn window: 5 000 nodes
    (2048, 1, 4),     # cfg3: 2 000 nodes
    (224, 1, 1),      # cfg8-gang: 220 nodes
    (1024, 1, 1),     # two tiles
    (1536, 1, 3),
])
def test_cluster_width_is_a_function_of_the_shape(N, lanes, C):
    """C = min(16 for one lane or 8, ceil(N / 512), max(1, 132 // lanes)),
    lowered to the fewest blocks at the same tiles a block, and 1 where a
    lane has at most two rank tiles, at the lane paths' and the one-lane
    scan's shapes."""
    assert TK.cluster_width(N, lanes) == C


@pytest.mark.parametrize("widest,tile", [
    (0, 64), (1, 64), (48, 64),     # cfg6-autoscale's estimates: at most 48 rows a lane
    (64, 64),                       # the autoscale burst: 64 copies a group
    (65, 256), (128, 256), (129, 256), (256, 256), (257, 512), (512, 512),
    (3585, 512),                    # wider lanes walk several tiles of 512
])
def test_lane_tile_is_a_function_of_the_widest_lane(widest, tile):
    """K8's block width: the narrowest of 64, 256 and 512 threads that
    holds the widest lane's active rows in one tile, 512 past it."""
    assert TK.lane_tile(widest) == tile


def test_build_flags_keep_ieee_arithmetic():
    flags = " ".join(TK.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "--fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags


def _problem(
    dtype, device, extended=False, sampling=True, n_pods=48, n_nodes=130, topo=False, zone_of=None, storage=False,
):
    """48 pending pods over 130 nodes, 40 bound; ``extended`` adds a third
    checked resource (an extended resource on every 3rd node and pod);
    ``topo`` adds spread constraints on every 3rd pod and inter-pod terms on
    every pod, and takes node 13's zone label away; ``zone_of(i)`` relabels
    node i's zone; ``storage`` adds host ports and volumes
    (``workloads.add_host_ports``, ``add_volumes``)."""
    topo_kw = dict(spread=lambda i: i % 3 == 0, interpod=lambda i: True) if topo else {}
    nodes, all_pods, pending = workloads.cluster(n_pods, n_nodes, seed=5, n_bound=40, **topo_kw)
    vols = {}
    if storage:
        workloads.add_host_ports(all_pods)
        vols = workloads.add_volumes(nodes, all_pods, 40)
    if topo:
        del nodes[13]["metadata"]["labels"]["topology.kubernetes.io/zone"]
    if zone_of is not None:
        for i, n in enumerate(nodes):
            if "topology.kubernetes.io/zone" in n["metadata"]["labels"]:
                n["metadata"]["labels"]["topology.kubernetes.io/zone"] = zone_of(i)
    if extended:
        for i, n in enumerate(nodes):
            if i % 3 == 0:
                n["status"]["allocatable"]["example.com/accel"] = "2"
        for i, p in enumerate(pending):
            if i % 3 == 0:
                p["spec"]["containers"][0]["resources"]["requests"]["example.com/accel"] = "1"
    pr = TE.pad_problem(TE.encode(nodes, all_pods, pending, volumes=vols))
    dp, dims = TB.lower(pr, dtype=dtype, device=device)
    if sampling:
        dp = dp._replace(sample_k=100, start0=37, tb_base=4294967290)
    return pr, dp, dims


def assert_outputs_equal(k_out: dict, p_out: dict, tag=None) -> None:
    """Every output of the kernel equals the plain version's, bitwise; the
    final carry (a dict of the carried tensors) field by field."""
    assert set(k_out) == set(p_out)
    for key in p_out:
        if key == "final_carry":
            for f in TB.CARRY0_FIELDS:
                assert torch.equal(k_out[key][f].reshape(-1), p_out[key][f].reshape(-1)), (tag, f)
        else:
            assert torch.equal(k_out[key], p_out[key]), (tag, key)


def test_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; CPU tensors reach the plain
    versions through build_batch_fn, never through a wrapper."""
    pr, dp, dims = _problem(torch.float64, "cpu")
    cfg = TB.BatchConfig(filters=SEVEN_FILTERS, scores=SCORES, trace=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.scan(cfg, dims, dp)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.scan_lanes(cfg._replace(trace=False), dims, dp, torch.ones(2, dims["N"], dtype=torch.bool))
    out = TB.build_batch_fn(cfg, dims)(dp)
    _fn, man = TB.build_compact_fn(cfg, dims, 64, 64, ("int8",) * 5, 15)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.compact(cfg, dims, 64, 64, man, out, pr.N_true)
    buf = torch.zeros(8, 3, dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.scatter_rows(buf, torch.tensor([1], dtype=torch.int32), buf[:1].clone())
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.preempt(*_search_args(3, 5, 2, 2, 1, 2, torch.float64, "cpu"))
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.gang_verdict(i32(4), i32(4), i32(2, 3), i32(2), i32(2), 3)
    f64 = lambda *shape: torch.zeros(shape, dtype=torch.float64)  # noqa: E731
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.gang_feasibility(f64(2, 3, 1), torch.ones(2, 3, dtype=torch.bool), f64(4, 1), f64(4), i32(2, 4), 2)
    lanes_cfg = cfg._replace(trace=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.scan_population(lanes_cfg, dims, dp, f64(3, len(SCORES)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.scan_grad(lanes_cfg, dims, dp, f64(len(SCORES)), f64(dims["N"], 2), 50.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.scan_grad_forward(lanes_cfg, dims, dp, f64(len(SCORES)), 50.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.grad_contract(f64(2, len(SCORES), dims["N"]), f64(dims["N"], 2), 50.0)
    N, P = dims["N"], dims["P"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.objective("utilization", f64(2, N, 2), i32(2, P), f64(N, 2), torch.ones(N, dtype=torch.bool),
                     torch.ones(P, dtype=torch.bool), f64(P))
    assert TK.LAUNCHES == {
        k: 0 for k in ("scan", "scan_lanes", "compact", "scatter", "preempt", "gang_verdict", "gang_feasibility",
                       "scan_population", "objective", "scan_grad", "grad_contract")
    }


RTCR_SHAPE = ((0, 20), (40, 100), (100, 10))
SPREAD_ONLY = (("NodeResourcesFit", "PodTopologySpread"), (("NodeResourcesFit", 1), ("PodTopologySpread", 2)))
INTERPOD_ONLY = (("NodeResourcesFit", "InterPodAffinity"), (("NodeResourcesFit", 1), ("InterPodAffinity", 2)))
# (filters, scores, fit_strategy, tie_break, sampling, trace, extended, topo)
GPU_CASES = [
    (SEVEN_FILTERS, SCORES, "LeastAllocated", "first", True, True, False, False),
    (SEVEN_FILTERS, SCORES, "MostAllocated", "reservoir", True, True, True, False),
    (SEVEN_FILTERS, SCORES, "RequestedToCapacityRatio", "reservoir", False, True, False, False),
    (SEVEN_FILTERS, SCORES, "LeastAllocated", "reservoir", True, False, True, False),
    (("NodeResourcesFit",), SCORES[:2], "RequestedToCapacityRatio", "first", True, True, True, False),
    (("NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity"), SCORES[2:], "LeastAllocated", "first", False, True, False, False),
    ((), SCORES, "MostAllocated", "reservoir", True, True, False, False),
    (SEVEN_FILTERS, (), "LeastAllocated", "first", True, True, False, False),
    (SEVEN_FILTERS, TOPO_SCORES, "LeastAllocated", "first", True, True, False, True),
    (SEVEN_FILTERS, TOPO_SCORES, "MostAllocated", "reservoir", False, False, True, True),
    (*SPREAD_ONLY, "LeastAllocated", "reservoir", True, True, False, True),
    (*INTERPOD_ONLY, "MostAllocated", "first", False, True, False, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("filters,scores,strategy,tie_break,sampling,trace,extended,topo", GPU_CASES)
def test_kernels_match_plain_versions_on_the_card(filters, scores, strategy, tie_break, sampling, trace, extended, topo):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for dt in (torch.float32, torch.float64):
        pr, dp, dims = _problem(dt, "cuda", extended=extended, sampling=sampling, topo=topo)
        cfg = TB.BatchConfig(
            filters=tuple(filters), scores=tuple(scores), fit_strategy=strategy,
            fit_shape=RTCR_SHAPE if strategy == "RequestedToCapacityRatio" else (),
            trace=trace, tie_break=tie_break, seed=7,
        )
        k_out = TK.scan(cfg, dims, dp)
        p_out = TB.scan_plain(cfg, dims, dp)
        assert_outputs_equal(k_out, p_out, dt)
        if not trace:
            continue
        packed = p_out["packed_pod"].cpu().numpy()
        W = min(dims["N"], TE._bucket(int(packed[3].max())))
        WS = min(dims["N"], TE._bucket(int(packed[1].max())))
        mm = p_out["trace_meta"].cpu().numpy()
        rd = tuple(TB.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1])) for k in range(len(scores)))
        _fn, man = TB.build_compact_fn(cfg, dims, W, WS, rd, int(mm[-1, 1]))
        blob = TK.compact(cfg, dims, W, WS, man, p_out, pr.N_true)
        assert torch.equal(blob, TB.compact_plain(cfg, dims, W, WS, man, p_out, pr.N_true))


@pytest.mark.gpu
def test_scan_kernel_over_several_node_tiles():
    """1300 nodes pad to 1536: three tiles of the block, the rotation
    wrapping inside a tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _pr, dp, dims = _problem(torch.float32, "cuda", n_pods=300, n_nodes=1300)
    dp = dp._replace(sample_k=200, start0=1111, tb_base=99)
    cfg = TB.BatchConfig(filters=SEVEN_FILTERS, scores=SCORES, trace=True, tie_break="reservoir", seed=1)
    k_out, p_out = TK.scan(cfg, dims, dp), TB.scan_plain(cfg, dims, dp)
    assert_outputs_equal(k_out, p_out)


@pytest.mark.gpu
def test_scan_kernel_with_domain_sums_in_global_memory():
    """650 zones of two nodes each: PodTopologySpread's per-domain sums
    outgrow the scan's shared memory in both dtypes and live in per-block
    global scratch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = TB.BatchConfig(filters=SEVEN_FILTERS, scores=TOPO_SCORES, trace=True, tie_break="reservoir", seed=4)
    for dt in (torch.float32, torch.float64):
        _pr, dp, dims = _problem(dt, "cuda", n_pods=200, n_nodes=1300, topo=True, zone_of=lambda i: f"zone-{i // 2}")
        cap, in_smem = TK.domain_layout(dims, dt)
        assert cap >= 600 and not in_smem
        k_out, p_out = TK.scan(cfg, dims, dp), TB.scan_plain(cfg, dims, dp)
        assert_outputs_equal(k_out, p_out, dt)


# (filters, tie_break, ws0): the default profile in both orders, with the
# score planes at [P,N] and compacted in the step (100 of 130 nodes
# sampled: ws0 = bucket(100) = 112 < N = 160)
STORAGE_CASES = [
    (REGISTRY_FILTERS, "first", None),
    (REGISTRY_FILTERS, "reservoir", 112),
    (TB.FILTER_KERNELS, "reservoir", None),
    (TB.FILTER_KERNELS, "first", 112),
]


@pytest.mark.gpu
@pytest.mark.parametrize("filters,tie_break,ws0", STORAGE_CASES)
def test_volume_filters_and_in_step_compaction_on_the_card(filters, tie_break, ws0):
    """Host ports, the volume filters and their carries, and the in-step
    score compaction (K2d, K2f): the kernels against their plain versions,
    bitwise, in both dtypes, and the compacted planes against the same
    kernel's full planes gathered at the ascending sampled ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for dt in (torch.float32, torch.float64):
        pr, dp, dims = _problem(dt, "cuda", topo=True, storage=True)
        cfg = TB.BatchConfig(filters=tuple(filters), scores=DEFAULT_SCORES, trace=True, tie_break=tie_break, seed=7)
        k_out = TK.scan(cfg, dims, dp, ws0=ws0)
        p_out = TB.scan_plain(cfg, dims, dp, ws0=ws0)
        assert_outputs_equal(k_out, p_out, dt)
        assert k_out["final_csi_att"].any() and k_out["final_ports_used"].any()
        packed = p_out["packed_pod"].cpu().numpy()
        W = min(dims["N"], TE._bucket(int(packed[3].max())))
        WS = min(dims["N"], TE._bucket(int(packed[1].max())), ws0 or dims["N"])
        mm = p_out["trace_meta"].cpu().numpy()
        rd = tuple(TB.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1])) for k in range(len(DEFAULT_SCORES)))
        _fn, man = TB.build_compact_fn(cfg, dims, W, WS, rd, int(mm[-1, 1]), in_step_ws0=ws0)
        blob = TK.compact(cfg, dims, W, WS, man, p_out, pr.N_true, ws0)
        assert torch.equal(blob, TB.compact_plain(cfg, dims, W, WS, man, p_out, pr.N_true, ws0))
        if ws0 is None:
            continue
        full = TK.scan(cfg, dims, dp)
        for i in range(dims["P"]):
            cols = torch.nonzero(full["feasible"][i]).flatten()
            for s, _w in DEFAULT_SCORES:
                for kind in ("raw", "norm"):
                    row = k_out[f"{kind}:{s}"][i]
                    assert torch.equal(row[: len(cols)], full[f"{kind}:{s}"][i][cols]), (dt, i, s, kind)
                    assert not row[len(cols):].any()


# ------------------------------------------ the victim search (K5)

@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_preempt_kernel_matches_plain_version_on_the_card(dt):
    """K5 against preemption/kernel.preempt_plain on the same tensors on the
    card, bitwise: cand, victims and viol, with and without PDBs and
    same-window successes, V from 1 to 16, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_scheduler_simulator_tpu_torch.preemption.kernel import preempt_plain

    for k, shape in enumerate(((1, 1, 1, 1, 0, 0), (5, 16, 4, 2, 3, 0), (7, 23, 9, 3, 2, 5), (16, 640, 16, 2, 16, 150))):
        args = _search_args(*shape, dt, "cuda", seed=k)
        TK.reset_counts()
        got = TK.preempt(*args)
        assert TK.LAUNCHES["preempt"] == 1
        for name, a, b in zip(("cand", "victims", "viol"), got, preempt_plain(*args)):
            assert torch.equal(a, b), (shape, name)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("U,N,V,R,PDB,S,bunch", [
    (13, 77, 4, 2, 3, 40, "one_node"),    # U x N not a multiple of the block (8 rows x 32 nodes)
    (13, 77, 4, 2, 3, 40, "two_nodes"),
    (13, 77, 4, 2, 3, 0, "none"),         # S 0
    (64, 500, 4, 2, 16, 144, "spread"),   # cfg7's widths, successes over every node
    (9, 70, 5, 3, 2, 30, "one_node"),     # V not a multiple of 4: the masks written a byte at a time
    (6, 50, 200, 8, 40, 25, "spread"),    # V > 32 (bits in local memory), a tile of fewer than 32
                                          # nodes, PDB matches read in place
    (5, 40, 4, 2, 3, 60_000, "spread"),   # S past what a block's shared memory could list
    (5, 40, 4, 2, 3, 60_000, "one_node"),
])
def test_preempt_kernel_with_bucketed_successes_on_the_card(dt, U, N, V, R, PDB, S, bunch):
    """K5's redesign against preemption/kernel.preempt_plain, bitwise: the
    same-window successes bucketed by node (all on one node, on two, none,
    spread, more than a block's shared memory could hold), ragged tiles, V
    past one word of bits, tables too wide for 32 nodes a block; the three
    masks are views of one buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_scheduler_simulator_tpu_torch.preemption.kernel import mask_layout, preempt_plain

    args = list(_search_args(U, N, V, R, PDB, S, dt, "cuda", seed=U + V + S))
    if bunch in ("one_node", "two_nodes"):
        full = int(torch.argmax(args[14].sum(dim=1)))
        other = 5 if bunch == "two_nodes" else full
        args[5] = torch.tensor([full if s % 2 == 0 else other for s in range(S)], dtype=torch.int32, device="cuda")
    if S > 10_000:
        # each pod preceded by a few of the S successes, so that nodes keep
        # room and candidates: every lane still walks its node's whole list
        args[3] = torch.rand((U, S), generator=torch.Generator("cuda").manual_seed(S), device="cuda") < 5e-4
    TK.reset_counts()
    got = TK.preempt(*args)
    assert TK.LAUNCHES["preempt"] == 1
    base = got[0].data_ptr()
    _n, offs = mask_layout(U, N, V)
    assert [g.data_ptr() - base for g in got] == list(offs)
    want = preempt_plain(*args)
    for name, a, b in zip(("cand", "victims", "viol"), got, want):
        assert torch.equal(a, b), (bunch, name)
    assert want[0].any()


# ------------------------------------------ row scatter and windows (K4, K2w)

@pytest.mark.gpu
def test_scatter_kernel_matches_plain_version_on_the_card():
    """K4 against its plain version, bitwise: every plane dtype, ranks 1-3,
    K from 1 to a quarter of the rows, repeated indices carrying the first
    index's row, odd row widths (byte words) and aligned ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator().manual_seed(5)
    for dt in (torch.bool, torch.int8, torch.int16, torch.int32, torch.float32, torch.float64):
        for shape in ((400,), (400, 3), (400, 2, 5)):
            base = torch.randint(0, 2 if dt == torch.bool else 100, shape, generator=gen).to(dt)
            for k in (1, 7, 100):
                idx = torch.randperm(shape[0], generator=gen)[:k].to(torch.int32)
                idx = torch.cat([idx, idx[:1].repeat(3)])
                rows = torch.randint(0, 2 if dt == torch.bool else 100, (k + 3,) + shape[1:], generator=gen).to(dt)
                rows[k:] = rows[0]
                want = TB.scatter_rows_plain(base.clone(), idx, rows)
                got = TK.scatter_rows(base.cuda(), idx.cuda(), rows.cuda())
                assert torch.equal(got.cpu(), want), (dt, shape, k)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_windowed_scan_matches_one_launch_on_the_card(dt):
    """K2w: the kernel run in windows chained on the card (the carry and the
    rotation start never leave it) equals the one-launch kernel bitwise in
    every output and the whole final carry, and each window equals the
    windowed plain version; reservoir draws across the uint32 wrap, spread
    constraints, inter-pod terms, host ports and volumes, the score planes
    compacted in the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _pr, dp, dims = _problem(dt, "cuda", topo=True, storage=True)
    cfg = TB.BatchConfig(filters=REGISTRY_FILTERS, scores=DEFAULT_SCORES, trace=True, tie_break="reservoir", seed=7)
    ws0, Wp = 112, 16
    one = TK.scan(cfg, dims, dp, ws0=ws0)
    carry, outs = None, []
    for off in range(0, dims["P"], Wp):
        out = TK.scan(cfg, dims, dp, ws0=ws0, carry0=carry, offset=off, window=Wp)
        assert_outputs_equal(out, TB.scan_plain(cfg, dims, dp, ws0=ws0, carry0=carry, offset=off, window=Wp), off)
        carry = out["final_carry"]
        outs.append(out)
    for key in ("fail_plug", "fail_code", *(f"{k}:{s}" for s, _w in DEFAULT_SCORES for k in ("raw", "norm"))):
        assert torch.equal(torch.cat([o[key] for o in outs]), one[key]), key
    assert torch.equal(torch.cat([o["packed_pod"][:4] for o in outs], 1), one["packed_pod"][:4])
    for f in TB.CARRY0_FIELDS:
        assert torch.equal(carry[f].reshape(-1), one["final_carry"][f].reshape(-1)), f


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_windows_of_256_in_a_cluster_chain_to_one_launch_on_the_card(dt):
    """K2w at the service's window of 256 pods over three rank tiles (a
    cluster of 3 blocks): the windows chained on the card, each handing on
    one carry copy and its rotation start, equal the one-launch kernel
    bitwise in the packed rows, every trace plane (compacted in the step)
    and the whole final carry; spread constraints, inter-pod terms, host
    ports, volumes, reservoir draws across the uint32 wrap."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    pr, dp, dims = _problem(dt, "cuda", n_pods=700, n_nodes=1300, topo=True, storage=True)
    dp = dp._replace(sample_k=500, start0=401, tb_base=4294967000)
    assert TK.cluster_width(dims["N"], 1) == 3 and dims["P"] == 768
    cfg = TB.BatchConfig(filters=REGISTRY_FILTERS, scores=DEFAULT_SCORES, trace=True, tie_break="reservoir", seed=7)
    ws0 = TB.pick_ws0(cfg, dims, 500, pr.N_true)
    one = TK.scan(cfg, dims, dp, ws0=ws0)
    carry, outs = None, []
    for off in range(0, dims["P"], 256):
        out = TK.scan(cfg, dims, dp, ws0=ws0, carry0=carry, offset=off, window=256)
        carry = out["final_carry"]
        outs.append(out)
    for key in ("fail_plug", "fail_code", *(f"{k}:{s}" for s, _w in DEFAULT_SCORES for k in ("raw", "norm"))):
        assert torch.equal(torch.cat([o[key] for o in outs]), one[key]), key
    assert torch.equal(torch.cat([o["packed_pod"][:4] for o in outs], 1), one["packed_pod"][:4])
    for f in TB.CARRY0_FIELDS:
        assert torch.equal(carry[f].reshape(-1), one["final_carry"][f].reshape(-1)), f


# (cluster width, nodes, tie-break, storage, in-step compaction, topology):
# the one-lane scan with the trace on as a cluster of C blocks (an explicit
# width; 12 a non-portable size), the rotation start a third of the way in;
# 1 250 nodes pad to 1 280, a partial last rank tile
ONE_LANE_CASES = [
    (1, 300, "first", False, True, True),
    (2, 900, "reservoir", True, True, True),
    (2, 900, "first", False, False, False),
    (3, 1250, "reservoir", False, True, True),
    (3, 1300, "first", True, False, True),
    (8, 3585, "first", True, True, True),
    (8, 3585, "reservoir", False, False, True),
    (12, 6000, "reservoir", True, True, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("C,n_nodes,tie_break,storage,compact,topo", ONE_LANE_CASES)
def test_one_lane_scan_in_a_cluster_matches_plain_version_on_the_card(C, n_nodes, tie_break, storage, compact, topo):
    """The one-lane scan (K2a-f) as one thread-block cluster of C blocks
    with the trace on: every output bitwise its plain version's in both
    dtypes (packed rows, trace planes, compacted score rows with ws0 > 0,
    trace meta, the whole final carry), and bitwise the redundant chains'
    (``blocks=``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for dt in (torch.float32, torch.float64):
        pr, dp, dims = _problem(dt, "cuda", n_pods=24, n_nodes=n_nodes, topo=topo, storage=storage)
        sample_k = 2 * n_nodes // 3
        dp = dp._replace(sample_k=sample_k, start0=n_nodes // 3 + 1, tb_base=4294967290)
        filters, scores = (REGISTRY_FILTERS, DEFAULT_SCORES) if storage or topo else (SEVEN_FILTERS, SCORES)
        cfg = TB.BatchConfig(filters=filters, scores=scores, trace=True, tie_break=tie_break, seed=7)
        ws0 = TB.pick_ws0(cfg, dims, sample_k, pr.N_true) if compact else None
        assert (ws0 is not None) == compact
        k_out = TK.scan(cfg, dims, dp, ws0=ws0, cluster=C)
        assert_outputs_equal(k_out, TB.scan_plain(cfg, dims, dp, ws0=ws0), (C, dt))
        assert_outputs_equal(TK.scan(cfg, dims, dp, ws0=ws0, blocks=7), k_out, ("blocks", C, dt))


@pytest.mark.gpu
def test_service_churn_on_the_card_matches_the_cpu():
    """A small churn through the port's SchedulerService on the card (float64,
    windowed rounds, a rolling cordon through the scatter kernel) leaves
    every pod with the CPU service's annotations, node and status."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    states = []
    for device in ("cuda", "cpu"):
        store = ClusterStore(clock=lambda: 0.0)
        svc = None
        TK.reset_counts()
        for _w in workloads.churn(store, 1400, 200, 2, cordon=5):
            if svc is None:
                svc = SchedulerService(store, tie_break="first", use_batch="auto", device=device, dtype=torch.float64)
                svc.start_scheduler(None)
            svc.schedule_pending(max_rounds=1)
        if device == "cuda":
            assert TK.LAUNCHES["scan"] == TK.LAUNCHES["compact"] == 4 and TK.LAUNCHES["scatter"] >= 1, TK.LAUNCHES
        assert not svc.stats["batch_fallbacks"] and svc.stats["sequential_pods"] == 0
        states.append({
            p["metadata"]["name"]: (p["spec"].get("nodeName"), p["metadata"].get("annotations"), p.get("status"))
            for p in store.list("pods")
        })
    assert states[0] == states[1]


def _gang_args(G, M, N, R, D, dt, device, seed=0):
    """Seeded arguments of the window verdict (K6) and the feasibility scan
    (K7): padding and failed member slots, a hostname key when D == N; ties
    across nodes, invalid slots, overcommitted nodes, group 0 infeasible."""
    import numpy as np

    rng = np.random.default_rng(seed)
    K = 4 * G * M
    gid = np.where(rng.random(K) < 0.1, -1, rng.integers(0, G, K))
    node = np.where(rng.random(K) < 0.05, -1, rng.integers(0, N, K))
    dom = np.tile(np.arange(N) if D == N else np.arange(N) % D, (G, 1))
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)  # noqa: E731
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)  # noqa: E731
    verdict = (i32(gid), i32(node), i32(dom), i32(rng.integers(0, 3, G)), i32(rng.integers(1, 3 * M, G)), D)
    valid = (np.arange(M)[None, :] < rng.integers(1, M + 1, G)[:, None]) & (rng.random((G, M)) < 0.9)
    req = rng.integers(0, 3, (G, M, R))
    req[0, 0] = 100
    feas = (f(req), torch.from_numpy(valid).to(device), f(rng.integers(-1, 8, (N, R))), f(rng.integers(0, 4, N)),
            i32(dom), D)
    return verdict, feas


@pytest.mark.gpu
@pytest.mark.parametrize("G,M,N,R,D", [(12, 8, 40, 2, 4), (12, 8, 40, 2, 40), (1, 16, 30, 2, 3), (6, 6, 25, 3, 1)])
def test_gang_kernels_match_plain_versions_on_the_card(G, M, N, R, D):
    """K6 and K7 against gang/kernel.verdict_plain and feasibility_plain on
    the same tensors on the card, bitwise, K7 in both dtypes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_scheduler_simulator_tpu_torch.gang import kernel as GK

    for dt in (torch.float32, torch.float64):
        verdict, feas = _gang_args(G, M, N, R, D, dt, "cuda", seed=G + N)
        for a, b in zip(TK.gang_verdict(*verdict), GK.verdict_plain(*verdict)):
            assert torch.equal(a, b)
        for a, b in zip(TK.gang_feasibility(*feas), GK.feasibility_plain(*feas)):
            assert torch.equal(a, b)


# K7's edge shapes, name: (G, M, N, R, D).  N across each kernel shape's
# edge (kernels.FEAS_VARIANTS: a warp a group at 2-8 nodes a lane, N 64 to
# 256; a block of 256 or 512 threads at 8 or 16 nodes, N 2 048 to 8 192;
# past those the state in memory, at N 12 000 in float64 in global
# scratch), R 1, R 3 (four register columns) and R 5 (past them: the state
# in memory), D 1 and D = N, M 1.  Every problem (k7_problem) has an infeasible group 0, an
# all-pad group 1, pads in the middle of the other groups, negative free
# capacity, ties everywhere and fitting nodes spread over the whole axis.
K7_EDGES = {
    "N 1": (3, 4, 1, 2, 1), "N 31": (4, 6, 31, 2, 4), "N 32, D = N": (4, 6, 32, 2, 32), "N 33": (4, 6, 33, 2, 5),
    "N 64": (3, 8, 64, 2, 8), "N 65": (3, 8, 65, 2, 8), "N 128": (3, 8, 128, 2, 3), "N 129": (3, 8, 129, 2, 8),
    "N 256": (3, 12, 256, 2, 8), "N 257, R 1": (3, 12, 257, 1, 8), "N 512, D 1": (3, 8, 512, 2, 1),
    "N 513": (3, 8, 513, 2, 16), "N 1024": (3, 8, 1024, 2, 8), "N 1025, R 3": (3, 8, 1025, 3, 8),
    "N 2048, D = N": (3, 8, 2048, 2, 2048), "N 2049": (3, 8, 2049, 2, 8), "N 4096": (3, 6, 4096, 2, 8),
    "N 4097": (3, 6, 4097, 2, 8), "N 8192": (3, 6, 8192, 2, 8), "N 8193": (3, 6, 8193, 2, 8),
    "R 5": (4, 8, 300, 5, 8), "M 1": (5, 1, 40, 2, 4), "N 12000, D = N": (3, 4, 12000, 2, 12000),
}


def k7_problem(G, M, N, R, D, seed):
    """A seeded GangFeasibilityProblem stand-in (numpy; the fields
    ``run_feasibility`` reads) with K7_EDGES' features."""
    import numpy as np
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    valid = (np.arange(M)[None, :] < rng.integers(1, M + 1, G)[:, None]) & (rng.random((G, M)) < 0.85)
    valid[0, 0] = True
    if G > 1:
        valid[1] = False
    req = rng.integers(0, 3, (G, M, R)).astype(np.int64)
    req[0, 0] = 100
    free = rng.integers(-1, 7, (N, R)).astype(np.int64)
    cnt = rng.integers(0, 4, N).astype(np.int64)
    cnt[rng.random(N) > max(16 / N, 0.02)] = 0
    dom = (np.tile(np.arange(N), (G, 1)) if D == N else rng.integers(0, D, (G, N))).astype(np.int32)
    return SimpleNamespace(req=req, valid=valid, free=free, cnt_free=cnt, dom=dom, D=D)


def k7_args(pr, dt, device):
    """K7's arguments from a k7_problem in ``dt`` on ``device``."""
    import numpy as np

    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)  # noqa: E731
    return (f(pr.req), torch.from_numpy(pr.valid).to(device), f(pr.free), f(pr.cnt_free),
            torch.from_numpy(pr.dom).to(device), pr.D)


@pytest.mark.parametrize("N,R", [(1, 2), (64, 2), (65, 1), (220, 2), (512, 4), (513, 2), (5000, 2), (8192, 3),
                                 (8193, 2), (300, 5), (12000, 2)])
def test_feasibility_scan_picks_a_kernel_shape_that_holds_the_problem(N, R):
    """kernels.feas_variant: a register variant where N fits its threads x
    nodes and R its columns, in the order of FEAS_TABLE for the dtype and
    R's columns (2 or 4), else the memory variant; feas_memory: the staged slots (a register variant's rows in 2
    or 4 columns, four groups a block in a one-warp variant), the nodes'
    state in shared memory where it fits GANG_SMEM_BYTES, else global
    scratch a group."""
    for dt, size in ((torch.float32, 4), (torch.float64, 8)):
        v = TK.feas_variant(N, R, dt)
        tg, npt = TK.FEAS_VARIANTS[v]
        table = TK.FEAS_TABLE[dt, 2 if R <= 2 else TK.FEAS_RC] if R <= TK.FEAS_RC else ()
        fits = [nmax for nmax, _v in table if N <= nmax]
        if fits:
            assert npt and N <= tg * npt and (min(fits), v) in table
        else:
            assert v == TK.FEAS_MEM and npt == 0
        for G, M in ((1, 1), (64, 64), (5, 300)):
            mc, smem, scratch = TK.feas_memory(G, M, N, R, dt, v)
            assert mc == min(M, TK.FEAS_SLOTS)
            if npt:
                assert smem == (TK.FEAS_GPB if tg == 32 else 1) * mc * ((2 if R <= 2 else 4) * size + 1)
                assert scratch == 0
            else:
                state = -(-(R + 1) * N * size // 16) * 16 + -(-4 * N // 16) * 16
                stage = -(-(mc * R * size + mc) // 16) * 16
                assert (smem, scratch) == ((stage + state, 0) if stage + state <= TK.GANG_SMEM_BYTES
                                           else (stage, G * state))
    assert TK.feas_memory(32, 16, 12000, 2, torch.float64, TK.FEAS_MEM)[2] > 0  # chip_smoke's global case


def test_feasibility_staging_and_views_round_trip():
    """run_feasibility's buffers (gang.kernel.Staging, feasibility_views):
    the inputs packed at 16-byte offsets of one buffer come back as views
    of their dtypes and shapes, bitwise; the outputs written into the
    views of the output buffer after them come back through ``get`` (on
    the CPU the same bytes); the CPU dispatch, with its split, equals
    feasibility_plain."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.gang import kernel as GK

    rng = np.random.default_rng(5)
    G, M, N, R = 3, 5, 7, 2
    arrays = [rng.random((G, M, R)).astype(np.float32), rng.random((G, M)) < 0.5, rng.random((N, R)),
              rng.integers(-3, 9, N).astype(np.float64), rng.integers(0, 4, (G, N)).astype(np.int32)]
    st = GK.Staging("cpu")
    views, out = st.put(arrays, GK.feasibility_layout(G, M))
    offs, n_in = GK.stage_layout(arrays)
    base = views[0].data_ptr()
    for a, v, o in zip(arrays, views, offs):
        assert o % 16 == 0 and v.data_ptr() == base + o and v.dtype == getattr(torch, a.dtype.name)
        assert tuple(v.shape) == a.shape and v.numpy().tobytes() == a.tobytes()
    assert n_in == sum(-(-a.nbytes // 16) * 16 for a in arrays)
    assert out.dtype == torch.uint8 and out.shape == (4 * G * M + 5 * G,) and out.data_ptr() == base + n_in
    feasible, distinct, assignment = GK.feasibility_views(out, G, M)
    assert (feasible.dtype, distinct.dtype, assignment.dtype) == (torch.bool, torch.int32, torch.int32)
    assert feasible.shape == distinct.shape == (G,) and assignment.shape == (G, M)
    assert assignment.data_ptr() == out.data_ptr() and distinct.data_ptr() == out.data_ptr() + 4 * G * M
    assert feasible.data_ptr() == out.data_ptr() + 4 * G * M + 4 * G
    want = (torch.tensor([True, False, True]), torch.tensor([2, 0, 7], dtype=torch.int32),
            torch.from_numpy(rng.integers(-1, N, (G, M)).astype(np.int32)))
    for v, w in zip((feasible, distinct, assignment), want):
        v.copy_(w)
    res = st.get()
    assert res.data_ptr() == out.data_ptr() and res.numel() == out.numel()
    for v, w in zip(GK.feasibility_views(res, G, M), want):
        assert torch.equal(v, w)
    pr = k7_problem(4, 6, 33, 2, 5, seed=1)
    got = GK.run_feasibility(pr, device="cpu")
    split: dict = {}
    again = GK.run_feasibility(pr, device="cpu", split=split)
    assert set(split) == {"stage_s", "launch_s", "wait_s", "views_s"}
    for k, w in zip(("feasible", "distinct_domains", "assignment"),
                    GK.feasibility_plain(*k7_args(pr, torch.float64, "cpu"))):
        assert np.array_equal(got[k], w.numpy()) and np.array_equal(again[k], w.numpy()), k


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K7_EDGES))
def test_feasibility_scan_kernel_shapes_match_plain_version_on_the_card(case):
    """K7 at every kernel shape of kernels.FEAS_VARIANTS that holds the
    problem, bitwise against gang/kernel.feasibility_plain on the same
    tensors on the card, in both dtypes; run_feasibility on the card (one
    launch) equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.gang import kernel as GK

    pr = k7_problem(*K7_EDGES[case], seed=len(case))
    N, R = pr.free.shape
    for dt in (torch.float32, torch.float64):
        args = k7_args(pr, dt, "cuda")
        want = GK.feasibility_plain(*args)
        for v, (tg, npt) in enumerate(TK.FEAS_VARIANTS):
            if npt and (R > TK.FEAS_RC or N > tg * npt):
                continue
            for a, b in zip(TK.gang_feasibility(*args, variant=v), want):
                assert torch.equal(a, b), (case, v, dt)
        n0 = TK.LAUNCHES["gang_feasibility"]
        got = GK.run_feasibility(pr, device="cuda", dtype=dt)
        assert TK.LAUNCHES["gang_feasibility"] == n0 + 1
        cpu = GK.run_feasibility(pr, device="cpu", dtype=dt)
        for k in cpu:
            assert np.array_equal(got[k], cpu[k]), (case, k, dt)


# K3's seeded shapes (P, N, n_true, W, WS, ws0): padded node columns and a
# fail plane of odd bytes (so the planes after it sit at odd offsets, where
# only byte stores apply), W below the kept count; a row over several
# partition tiles; in-step planes at aligned and at odd offsets; north's
# widths (16-byte stores)
K3_SHAPES = [
    (7, 40, 37, 33, 9, None), (5, 1100, 1050, 1030, 1025, None), (6, 64, 64, 64, 16, 32), (3, 50, 45, 17, 7, 13),
    (16, 5120, 5000, 5120, 512, 512),
]


def _compact_out(P, N, nt, ws0, code_max, rdt, dt, device, seed=0):
    """Seeded trace planes for the compaction: row 0 starts at 0 and
    visits nothing, row 1 visits more than n_true, row 2 wraps (start
    n_true - 2, 10 visited), the rest random; first failures in -1..4 with
    codes up to ``code_max``; score planes [P, ws0 or N] in ``dt``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    start, proc = rng.integers(0, nt, P), rng.integers(0, nt + 5, P)
    start[0], proc[0] = 0, 0
    proc[1] = nt + 3
    start[2], proc[2] = nt - 2, 10
    hi = {"int8": 100, "int16": 30000, "int32": 1 << 22}[rdt]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    out = {
        "sample_start": t(start.astype(np.int32)), "sample_processed": t(proc.astype(np.int32)),
        "fail_plug": t(rng.integers(-1, 5, (P, N)).astype(np.int8)),
        "fail_code": t(rng.integers(0, code_max + 1, (P, N)).astype(np.int32)),
        "feasible": t(rng.random((P, N)) < 0.5),
        "feasible_count": t(rng.integers(0, (ws0 or 1) + 2, P).astype(np.int32)),
    }
    for s, _w in SCORES:
        out[f"raw:{s}"] = t(rng.integers(-hi, hi + 1, (P, ws0 or N))).to(dt)
        out[f"norm:{s}"] = t(rng.integers(0, 101, (P, ws0 or N))).to(dt)
    return out


@pytest.mark.parametrize("P,N,nt,W,WS,ws0", K3_SHAPES)
def test_compaction_plan_stores_as_wide_as_the_offsets_allow(P, N, nt, W, WS, ws0):
    """The compaction's fixed fields (kernels._compact_plan): each mapped
    plane (the fail planes; the score planes where the step compacted them)
    stores words of the widest of 16, 8, 4, 2 and 1 bytes dividing its
    offset and its row's bytes, and its warp tiles cover every row; full
    score planes take a partition block a row; the blob's bytes are the
    manifest's."""
    import numpy as np

    dims = {"P": P, "N": N}
    for filters in (SEVEN_FILTERS[:5], ()):
        if ws0 is not None and not filters:
            continue
        cfg = TB.BatchConfig(filters=filters, scores=SCORES, trace=True)
        for code_max, rdt in itertools.product((9, 200, 30000, 70000), ("int8", "int16", "int32")):
            _fn, man = TB.build_compact_fn(cfg, dims, W, WS, (rdt,) * len(SCORES), code_max, in_step_ws0=ws0)
            key = ("test", tuple(man), N, W, WS, ws0, filters)
            tmpl, nbytes, src_keys, _ptrs = TK._compact_plan(key, cfg, dims, W, WS, man, ws0)
            TK._COMPACT_PLANS.pop(key)
            a = TK.CompactArgs.from_buffer_copy(tmpl)
            offs, sizes, total = {}, {}, 0
            for name, dt, shape in man:
                offs[name], sizes[name] = total, np.dtype(dt).itemsize
                total += int(np.prod(shape)) * np.dtype(dt).itemsize
            assert nbytes == total and len(src_keys) == sum(n.startswith(("raw:", "norm:")) for n in offs)
            mapped = [n for n in offs if n.startswith("fail") or (ws0 is not None and ":" in n)]
            assert a.n_mp == len(mapped) and a.rows == (0 if ws0 is not None or (filters and not src_keys) else P)
            first = 0
            for k, name in enumerate(mapped):
                width, nb = (W if name.startswith("fail") else WS), sizes[name]
                m = offs[name] | (width * nb)
                vec = min(16, m & -m) if m else 16
                assert (a.mp_off[k], a.mp_nb[k], a.mp_width[k], a.mp_vec[k]) == (offs[name], nb, width, vec), name
                assert a.mp_first[k] == first and a.mp_tiles[k] * 32 * max(1, vec // nb) >= width
                first += P * a.mp_tiles[k]
                if offs[name] % 2:
                    assert vec == 1
            assert a.map_tiles == first


def test_verdict_buffer_views_and_the_cpu_dispatch():
    """K6's one output buffer (gang.kernel.verdict_layout / verdict_views:
    distinct, placed int32, then feasible bytes) and run_window_verdict on
    the CPU against verdict_plain."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.gang import kernel as GK

    G = 5
    buf = torch.arange(GK.verdict_layout(G), dtype=torch.uint8)
    feasible, distinct, placed = GK.verdict_views(buf, G)
    assert (feasible.dtype, distinct.dtype, placed.dtype) == (torch.bool, torch.int32, torch.int32)
    assert feasible.shape == distinct.shape == placed.shape == (G,)
    assert distinct.data_ptr() == buf.data_ptr() and placed.data_ptr() == buf.data_ptr() + 4 * G
    assert feasible.data_ptr() == buf.data_ptr() + 8 * G
    rng = np.random.default_rng(3)
    gid = np.where(rng.random(40) < 0.1, -1, rng.integers(0, G, 40))
    node = np.where(rng.random(40) < 0.1, -1, rng.integers(0, 12, 40))
    dom, prior, minm = rng.integers(0, 4, (G, 12)), rng.integers(0, 3, G), rng.integers(1, 8, G)
    got = GK.run_window_verdict(gid, node, dom, prior, minm, 4, device="cpu")
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    want = GK.verdict_plain(i32(gid), i32(node), i32(dom), i32(prior), i32(minm), 4)
    for k, w in zip(("feasible", "distinct_domains", "placed"), want):
        assert np.array_equal(got[k], w.numpy()), k


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,N,nt,W,WS,ws0", K3_SHAPES)
def test_compaction_matches_plain_version_on_the_card(P, N, nt, W, WS, ws0, dt):
    """K3 bitwise against ops/batch.compact_plain on the same planes on the
    card: every fail-pack mode (code ranges 9, 200, 30 000, 70 000) with
    each raw dtype, the sids plane without filters, in-step and full score
    planes, rows that wrap, start at 0, visit nothing or more than n_true."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dims = {"P": P, "N": N}
    for filters in (SEVEN_FILTERS[:5], ()):
        if ws0 is not None and not filters:
            continue
        cfg = TB.BatchConfig(filters=filters, scores=SCORES, trace=True)
        for c, (code_max, rdt) in enumerate(itertools.product((9, 200, 30000, 70000), ("int8", "int16", "int32"))):
            out = _compact_out(P, N, nt, ws0, code_max, rdt, dt, "cuda", seed=c)
            _fn, man = TB.build_compact_fn(cfg, dims, W, WS, (rdt,) * len(SCORES), code_max, in_step_ws0=ws0)
            got = TK.compact(cfg, dims, W, WS, man, out, nt, ws0)
            want = TB.compact_plain(cfg, dims, W, WS, man, out, nt, ws0)
            assert torch.equal(got, want), (filters, code_max, rdt)


# K6's seeded cases (K, G, N, D, what): no member slot; every slot a pad;
# every member failed; D >= 5 000 (a hostname key); G x ceil(D/32) past one
# block's shared memory, so several blocks run
K6_CASES = [
    (0, 5, 20, 4, "mixed"), (64, 6, 30, 30, "pads"), (64, 6, 30, 3, "failed"), (512, 8, 6000, 6000, "mixed"),
    (4096, 512, 5000, 5000, "mixed"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("K,G,N,D,what", K6_CASES)
def test_window_verdict_matches_plain_version_on_the_card(K, G, N, D, what):
    """K6 bitwise against gang/kernel.verdict_plain on the same tensors on
    the card, and its dispatch (one upload, one launch, one fetch) equal to
    the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.gang import kernel as GK

    rng = np.random.default_rng(K + G + D)
    gid = np.where(rng.random(K) < 0.1, -1, rng.integers(0, G, K))
    node = np.where(rng.random(K) < 0.05, -1, rng.integers(0, N, K))
    if what == "pads":
        gid[:] = -1
    if what == "failed":
        node[:] = -1
    dom = np.tile(np.arange(N), (G, 1)) if D == N else rng.integers(0, D, (G, N))
    prior, minm = rng.integers(0, 3, G), rng.integers(1, max(2, 2 * K // G), G)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to("cuda")  # noqa: E731
    args = (i32(gid), i32(node), i32(dom), i32(prior), i32(minm), D)
    W = (D + 31) // 32
    assert (G > TK.VERDICT_SMEM_BYTES // ((2 + W) * 4)) == (G == 512)
    for a, b in zip(TK.gang_verdict(*args), GK.verdict_plain(*args)):
        assert torch.equal(a, b), what
    n0 = TK.LAUNCHES["gang_verdict"]
    got = GK.run_window_verdict(gid, node, i32(dom), prior, minm, D, device="cuda")
    want = GK.run_window_verdict(gid, node, dom, prior, minm, D, device="cpu")
    assert TK.LAUNCHES["gang_verdict"] == n0 + 1
    for k in want:
        assert np.array_equal(got[k], want[k]), (what, k)


@pytest.mark.gpu
def test_float32_round_past_the_exact_bound_runs_in_float64_on_the_card():
    """One node of 33554438 bytes of memory, one pod asking 33554439: in
    float32 on the card the round runs in float64 (counted) and equals the
    float64 round: nothing placed, "Insufficient memory"."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine

    node = {"metadata": {"name": "n0", "labels": {}},
            "status": {"allocatable": {"cpu": "4", "memory": "33554438", "pods": "110"}}}
    pod = {"metadata": {"name": "p0", "namespace": "default"},
           "spec": {"containers": [{"name": "c", "resources": {"requests": {"memory": "33554439"}}}]}}
    out = {}
    for dt in (torch.float32, torch.float64):
        eng = BatchEngine(filters=["NodeResourcesFit"], scores=[("NodeResourcesFit", 1)], trace=True, dtype=dt)
        res = eng.schedule([node], [pod], [pod])
        out[dt] = (res.selected_nodes[0], res.filter_annotation_json(0), res.score_annotations_json(0))
        assert eng.round_dtype == torch.float64
        assert eng.last_timings["promoted_f64"] == float(dt == torch.float32)
    assert out[torch.float32] == out[torch.float64]
    assert out[torch.float32][0] is None and "Insufficient memory" in out[torch.float32][1]


@pytest.mark.gpu
@pytest.mark.parametrize("topo", [False, True])
def test_lane_scan_matches_plain_version_and_one_lane_scans_on_the_card(topo):
    """K8 against its plain version in both dtypes on seeded lane masks
    (overlapping blocks of nodes, one lane of every node, one of none), and
    each lane against the one-lane scan (K2) launched on that lane's
    mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import numpy as np

    filters, scores = (SEVEN_FILTERS, (("NodeResourcesFit", 1),))
    cfg = TB.BatchConfig(filters=filters, scores=scores, fit_strategy="MostAllocated", tie_break="first")
    for dt in (torch.float32, torch.float64):
        _pr, dp, dims = _problem(dt, "cuda", sampling=False, topo=topo)
        rng = np.random.default_rng(9)
        N = dims["N"]
        masks = np.zeros((5, N), dtype=bool)
        for g in range(3):
            lo = int(rng.integers(0, 100))
            masks[g, lo : lo + int(rng.integers(5, 40))] = True
        masks[3, :130] = True
        lane = torch.from_numpy(masks).to("cuda")
        k_out = TK.scan_lanes(cfg, dims, dp, lane)
        p_out = TB.scan_lanes_plain(cfg, dims, dp, lane)
        assert_outputs_equal(k_out, p_out, (dt, topo))
        for g in range(masks.shape[0]):
            one = TK.scan(cfg, dims, dp._replace(node_active=lane[g].contiguous()), blocks=1)
            for key in ("packed_pod", "final_requested", "final_nonzero", "final_pod_count", "final_spread_counts",
                        "final_ip_sel", "final_ip_own", "final_ip_anti"):
                assert torch.equal(k_out[key][g], one[key]), (dt, topo, g, key)
        assert (k_out["selected"][4] < 0).all() and (k_out["selected"][3] >= 0).any()


def _hostname_problem(dtype, device="cuda", n_nodes: int = 300, n_pods: int = 40):
    """``n_nodes`` template copies of one node group (each its own hostname)
    and ``n_pods`` pods of one app under a hostname DoNotSchedule
    constraint of maxSkew 1: a lane's minimum over the hostname domains
    counts the included rows outside the lane."""
    from kube_scheduler_simulator_tpu_torch.autoscaler import nodegroups as NG

    group = workloads.node_group("pool", "8", "32Gi", {"disk": "ssd"}, n_nodes)
    nodes = [NG.synthetic_node(group, i) for i in range(n_nodes)]
    pods = [{
        "metadata": {"name": f"web-{i}", "namespace": "default", "labels": {"app": "web"}},
        "spec": {
            "containers": [{"name": "c", "resources": {"requests": {"cpu": "100m", "memory": "128Mi"}}}],
            "topologySpreadConstraints": [{
                "maxSkew": 1, "topologyKey": "kubernetes.io/hostname", "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": "web"}},
            }],
        },
    } for i in range(n_pods)]
    pr = TE.pad_problem(TE.encode(nodes, [], pods))
    dp, dims = TB.lower(pr, dtype=dtype, device=device)
    return pr, dp, dims


@pytest.mark.gpu
@pytest.mark.parametrize("masks", ["noncontiguous", "empty", "hostname"])
@pytest.mark.parametrize("tile", TK.LANE_TILES)
def test_masked_lane_scan_matches_plain_version_on_the_card(tile, masks):
    """K8's masked mode (one block of ``tile`` threads a lane over the
    lane's own rows) against scan_lanes_plain, bitwise, in both dtypes: lanes
    of rows drawn at random (wider than the tile below 512: several tiles),
    an empty lane, and lanes of a hostname-spread problem whose minimum
    comes from included rows outside the lane; a rotated start and
    sampling, both tie-breaks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import numpy as np

    rng = np.random.default_rng(tile)
    for tie, dt in itertools.product(("first", "reservoir"), (torch.float32, torch.float64)):
        if masks == "hostname":
            pr, dp, dims = _hostname_problem(dt)
            cfg = TB.BatchConfig(filters=SEVEN_FILTERS, scores=TOPO_SCORES, tie_break=tie, seed=3)
            m = np.zeros((3, dims["N"]), dtype=bool)
            m[0, :270] = True
            m[1, 270:273] = True
            m[2, : pr.N_true] = rng.random(pr.N_true) < 0.3
        else:
            pr, dp, dims = _problem(dt, "cuda", n_pods=40, n_nodes=700, topo=True)
            cfg = TB.BatchConfig(filters=SEVEN_FILTERS, scores=TOPO_SCORES, tie_break=tie, seed=3)
            m = rng.random((4, dims["N"])) < 0.5
            m[:, pr.N_true:] = False
            if masks == "empty":
                m[1] = False
        lane = torch.from_numpy(m).to("cuda")
        TK.reset_counts()
        k_out = TK.scan_lanes(cfg, dims, dp, lane, widest=tile)
        assert TK.LAUNCHES["scan_lanes"] == 1
        assert_outputs_equal(k_out, TB.scan_lanes_plain(cfg, dims, dp, lane), (tile, masks, dt))
        assert int(lane.sum(dim=1).max()) > tile or tile == 512
        if masks == "hostname":
            placed = (k_out["selected"][:, : pr.P_true] >= 0).sum(dim=1).tolist()
            assert placed[:2] == [40, 3], placed  # one pod a row of lane 1: its minimum stays 0
        if masks == "empty":
            assert (k_out["selected"][1] < 0).all()


# (cluster width, nodes, lanes, pods, sample_k, start0, zones, topology): the
# lane scan in clusters of 1 (one or two rank tiles), 2 (132 SMs over 50
# lanes), 3 and 8 blocks, the rotation start past the first tiles; with
# spread constraints and inter-pod terms (a barrier after each commit), or
# without them (the next pod's owner commits); the last in 650 zones, so
# PodTopologySpread's domain sums live in the lane's global scratch instead
# of rank 0's shared memory
CLUSTER_CASES = [
    (1, 300, 4, 24, 120, 211, None, True),
    (1, 900, 4, 24, 400, 777, None, True),
    (3, 1300, 5, 24, 700, 1111, None, True),
    (8, 3585, 16, 12, 2500, 3001, None, True),
    (2, 1300, 50, 6, 700, 1111, None, True),
    (1, 900, 4, 24, 400, 777, None, False),
    (3, 1300, 5, 24, 700, 1111, None, False),
    (8, 3585, 16, 12, 2500, 3001, None, False),
    (3, 1300, 3, 16, 900, 5, lambda i: f"zone-{i // 2}", True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("C,n_nodes,lanes,n_pods,sample_k,start0,zones,topo", CLUSTER_CASES)
def test_lane_scans_in_clusters_match_plain_versions_on_the_card(
    C, n_nodes, lanes, n_pods, sample_k, start0, zones, topo,
):
    """K9 (weight lanes, first tie) launched as one thread-block cluster of
    C blocks a lane, and K8 (node-mask lanes in its masked mode, reservoir
    with the topology plugins, first tie without) on the same problem,
    against their plain versions, bitwise, in
    both dtypes; with ``topo``, spread constraints on every 3rd pod and
    inter-pod terms on every pod (pods matching one and two term groups); a
    rotated start."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import numpy as np

    rng = np.random.default_rng(C + n_nodes)
    for dt in (torch.float32, torch.float64):
        pr, dp, dims = _problem(dt, "cuda", n_pods=n_pods, n_nodes=n_nodes, topo=topo, zone_of=zones)
        dp = dp._replace(sample_k=sample_k, start0=start0, tb_base=4294967290)
        assert TK.cluster_width(dims["N"], lanes) == C
        assert int((dp.ip_match_g >= 0).sum(dim=1).max()) >= (2 if topo else 0)
        if zones is not None:
            assert not TK.domain_layout(dims, dt)[1]
        cfg = TB.BatchConfig(filters=SEVEN_FILTERS, scores=TOPO_SCORES if topo else SCORES, tie_break="first")
        W = torch.as_tensor(rng.uniform(0.0, 3.0, size=(lanes, len(cfg.scores)))).to(device="cuda", dtype=dt)
        TK.reset_counts()
        assert_outputs_equal(TK.scan_population(cfg, dims, dp, W),
                             TB.scan_lanes_plain(cfg, dims, dp, weights=W), ("K9", C, dt))
        masks = rng.random((lanes, dims["N"])) < 0.7
        masks[0] = True
        masks[:, pr.N_true:] = False  # the shape padding
        lane = torch.from_numpy(masks).to("cuda")
        rcfg = cfg._replace(tie_break="reservoir" if topo else "first", seed=7)
        assert_outputs_equal(TK.scan_lanes(rcfg, dims, dp, lane),
                             TB.scan_lanes_plain(rcfg, dims, dp, lane), ("K8", C, dt))
        assert TK.LAUNCHES["scan_population"] == TK.LAUNCHES["scan_lanes"] == 1


@pytest.mark.gpu
def test_scatter_kernel_on_unaligned_rows_on_the_card():
    """K4's word follows the row width and both base addresses: row views
    starting one element in (odd addresses for 1- and 2-byte planes), rows
    of 3 and 5 bytes, repeated indices; bitwise the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator().manual_seed(9)
    for dt in (torch.int8, torch.int16, torch.float32, torch.float64):
        for shape in ((64,), (64, 3), (64, 5)):
            base = torch.randint(0, 100, shape, generator=gen).to(dt)
            idx = torch.tensor([7, 0, 63, 7, 7], dtype=torch.int32)
            pool = torch.randint(0, 100, (6,) + shape[1:], generator=gen).to(dt)
            pool[4:] = pool[1]
            rows = pool[1:]  # a view one row in: not 8-byte aligned unless a row is
            want = TB.scatter_rows_plain(base.clone(), idx, rows.clone())
            dev_pool = pool.cuda()
            got = TK.scatter_rows(base.cuda(), idx.cuda(), dev_pool[1:])
            assert torch.equal(got.cpu(), want), (dt, shape)
    # rows or indices that do not fit the plane are refused before a launch
    plane = torch.zeros(64, 3, device="cuda")
    for idx, rows in ((torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4)),
                      (torch.zeros(3, dtype=torch.int32), torch.zeros(2, 3)),
                      (torch.zeros(2, 1, dtype=torch.int32), torch.zeros(2, 3)),
                      (torch.zeros(2, dtype=torch.int32), torch.zeros(2, 3, 1))):
        with pytest.raises(ValueError, match="do not fit"):
            TK.scatter_rows(plane, idx.cuda(), rows.cuda())


def _tune_session(family: str, dt, device, n_nodes=40, n_pods=240):
    """A tuner session on a scenario family (the default profile's scores
    and filters), in ``dt`` on ``device``."""
    from kube_scheduler_simulator_tpu_torch.tuning import tuner as TT

    nodes, pods, obj = workloads.tune(family, n_nodes=n_nodes, n_pods=n_pods, seed=11)
    filters = [f for f in REGISTRY_FILTERS]
    return TT.TuningSession(nodes, pods, list(DEFAULT_SCORES), filters=filters, objective=obj, dtype=dt, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["imbalance", "consolidate"])
def test_population_and_objective_kernels_match_plain_versions_on_the_card(family):
    """K9: the population launch against its plain version and each lane
    against the one-lane scan (K2, the redundant chains' design) under that
    lane's weights, bitwise, in both dtypes; the objective kernel (values
    and cotangents) against its plain version, bitwise, for every
    objective."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.tuning import objective as TO

    for dt in (torch.float32, torch.float64):
        s = _tune_session(family, dt, "cuda")
        S = len(s.scores)
        W = np.random.default_rng(3).uniform(0.0, 3.0, size=(6, S))
        W[0] = [w for _s, w in s.scores]
        Wt = torch.as_tensor(W).to(device="cuda", dtype=dt)
        k_out = TK.scan_population(s.cfg, s.dims, s.dp, Wt)
        assert_outputs_equal(k_out, TB.scan_lanes_plain(s.cfg, s.dims, s.dp, weights=Wt), (family, dt))
        for g in range(W.shape[0]):
            one = TK.scan(s.cfg, s.dims, s.dp, weights=Wt[g].contiguous(), blocks=1)
            for key in ("packed_pod", "final_requested", "final_nonzero", "final_pod_count", "final_ip_sel", "final_ip_own"):
                assert torch.equal(k_out[key][g], one[key]), (family, dt, g, key)
        for name in TO.OBJECTIVES:
            ys = {"final_nonzero": k_out["final_nonzero"], "selected": k_out["selected"]}
            assert torch.equal(TO.objective_value(name, ys, s.dp, s.age_w), TO.objective_plain(name, ys, s.dp, s.age_w))
            for g in range(W.shape[0]):
                one = {k: v[g] for k, v in ys.items()}
                assert torch.equal(TO.objective_grad(name, one, s.dp, s.age_w),
                                   TO.objective_grad_plain(name, one, s.dp, s.age_w)), (name, g)


# K2g against grad_plain: the grad forward folds M in the cluster's order
# and over pods before F, the plain version sums each pod's terms with F
GRAD_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("family,objective,nodes", [("imbalance", "fragmentation", 40), ("consolidate", "utilization", 40),
                                                    ("imbalance", "pending_age", 40), ("imbalance", "utilization", 1300)])
def test_grad_kernel_matches_grad_plain_on_the_card(family, objective, nodes):
    """K2g (the grad forward, then the contraction): d objective / d
    weights within GRAD_TOL of ||g|| from grad_plain, the forward's
    residual within GRAD_TOL of grad_residual_plain's, the contraction
    bitwise its plain version on the same M and F, the launch's final carry
    bitwise the hard rollout's; pending_age's exactly 0.  At 1 300 nodes
    the forward is a cluster of 3 blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_scheduler_simulator_tpu_torch.tuning import objective as TO

    for dt in (torch.float32, torch.float64):
        s = _tune_session(family, dt, "cuda", n_nodes=nodes)
        w = torch.tensor([1.0, 2.0, 1.5, 0.5, 2.0, 1.0, 1.0], dtype=dt, device="cuda")
        hard = TK.scan_population(s.cfg, s.dims, s.dp, w[None].contiguous())
        ys = {"final_nonzero": hard["final_nonzero"][0], "selected": hard["selected"][0]}
        F = TO.objective_grad(objective, ys, s.dp, s.age_w)
        TK.reset_counts()
        dw, out = TK.scan_grad(s.cfg, s.dims, s.dp, w, F, 50.0)
        assert TK.LAUNCHES["scan_grad"] == TK.LAUNCHES["grad_contract"] == 1
        dw_p, out_p = TB.grad_plain(s.cfg, s.dims, s.dp, w, F, 50.0)
        for key in ("packed_pod", "final_requested", "final_nonzero", "final_pod_count"):
            assert torch.equal(out[key], hard[key][0]) and torch.equal(out[key], out_p[key]), (dt, key)
        M, _out = TK.scan_grad_forward(s.cfg, s.dims, s.dp, w, 50.0)
        M_p, _out_p = TB.grad_residual_plain(s.cfg, s.dims, s.dp, w, 50.0)
        assert float((M - M_p).norm()) <= GRAD_TOL[dt] * float(M_p.norm()), dt
        assert torch.equal(TK.grad_contract(M, F, 50.0), TB.grad_contract_plain(M, F, 50.0))
        assert torch.equal(TK.grad_contract(M, F, 50.0), dw)
        if objective == "pending_age":
            assert not dw.any() and not dw_p.any()
        else:
            err = float((dw - dw_p).norm())
            assert dw_p.norm() > 0 and err <= GRAD_TOL[dt] * float(dw_p.norm()), (dt, err, dw, dw_p)


@pytest.mark.gpu
def test_tuner_and_override_on_the_card_match_the_cpu():
    """run_tuning on the card in float64 against the CPU: CEM bitwise,
    grad within 1e-9; a service round under float weights leaves the CPU
    service's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_scheduler_simulator_tpu_torch.ops import kernels
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.tuning import run_tuning

    for family, tuner in workloads.TUNE_ROWS:
        kw = dict(family=family, tuner=tuner, n_nodes=8, n_pods=48, steps=3, pop=6, seed=11, dtype=torch.float64)
        kernels.reset_counts()
        got = run_tuning(device="cuda", **kw)
        want = run_tuning(device="cpu", **kw)
        # an evaluate or population call launches K9, a value-and-grad call
        # the grad forward and the contraction
        assert got["kernelPlatform"] == "cuda"
        assert kernels.LAUNCHES["scan_population"] == got["dispatches"] - got["gradDispatches"]
        assert kernels.LAUNCHES["scan_grad"] == kernels.LAUNCHES["grad_contract"] == got["gradDispatches"]
        assert got["defaultObjective"] == want["defaultObjective"]
        if tuner == "cem":
            assert got["weights"] == want["weights"] and got["history"] == want["history"]
        else:
            import numpy as np

            assert np.allclose(got["weights"], want["weights"], rtol=1e-9, atol=0)
    states = []
    for dev in ("cuda", "cpu"):
        store = ClusterStore(clock=lambda: 0.0)
        for w in workloads.churn(store, 300, 40, 2):
            if w == 0:
                svc = SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0, device=dev,
                                       dtype=torch.float64, weights=[1.5, 2.25, 0.75, 2, 2, 1.1, 1])
                svc.start_scheduler(None)
            svc.schedule_pending(max_rounds=1)
        assert svc.stats["batch_pods"] > 0 and not svc.stats["batch_fallbacks"]
        states.append({p["metadata"]["name"]: ((p.get("spec") or {}).get("nodeName"), p["metadata"].get("annotations"))
                       for p in store.list("pods")})
    assert states[0] == states[1]
