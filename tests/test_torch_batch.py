"""The port's scan and trace compaction against the JAX package's kernels.

The JAX package lowers one seeded cluster; ``interop.from_jax_problem``
carries that very problem across, so both scans see identical inputs.  The
port runs its plain PyTorch versions on the CPU in float64, the reference
its jitted programs in float64; every output must be equal exactly (both
sides run the same float64 operations on integer-valued data).  The CUDA
kernels are held against the same plain versions on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.ops import batch as JB  # noqa: E402
from kube_scheduler_simulator_tpu.ops import encode as JE  # noqa: E402
from kube_scheduler_simulator_tpu.utils import hashing  # noqa: E402
from test_batch_parity import mk_node, mk_pod  # noqa: E402
from kube_scheduler_simulator_tpu_torch import interop, workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import encode as TE  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    """The reference runs in float64 here (the port's CPU dtype), scoped to
    each test so other test files keep the process default."""
    with jax.enable_x64(True):
        yield


ALL_SCORES = (
    ("NodeResourcesFit", 1),
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("TaintToleration", 3),
    ("NodeAffinity", 2),
)
# upstream's default weights for the two topology plugins
TOPO_SCORES = ALL_SCORES + (("PodTopologySpread", 2), ("InterPodAffinity", 2))
SEVEN_FILTERS = (
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodeResourcesFit",
    "PodTopologySpread", "InterPodAffinity",
)
FIVE_FILTERS = SEVEN_FILTERS[:5]
# profiles run on the cluster with spread constraints and inter-pod terms
TOPO_SUBSETS = {
    "seven": (SEVEN_FILTERS, TOPO_SCORES),
    "spread": (("NodeResourcesFit", "PodTopologySpread"), (("NodeResourcesFit", 1), ("PodTopologySpread", 2))),
    "interpod": (("NodeResourcesFit", "InterPodAffinity"), (("NodeResourcesFit", 1), ("InterPodAffinity", 2))),
}
SUBSETS = {
    **TOPO_SUBSETS,
    "full": (FIVE_FILTERS, ALL_SCORES),
    "fit": (("NodeResourcesFit",), (("NodeResourcesFit", 2), ("NodeResourcesBalancedAllocation", 1))),
    "taint-aff": (
        ("NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity"),
        (("TaintToleration", 3), ("NodeAffinity", 2), ("ImageLocality", 1)),
    ),
    "no-scores": (FIVE_FILTERS, ()),
    "no-filters": ((), ALL_SCORES),
}
RTCR_SHAPE = ((0, 20), (40, 100), (100, 10))  # a rising then falling ramp
# (subset, fit_strategy, tie_break, sampling, trace): every value of every
# axis, in pairs rather than the full product
CASES = [
    ("full", "LeastAllocated", "first", False, True),
    ("full", "MostAllocated", "reservoir", True, True),
    ("full", "RequestedToCapacityRatio", "reservoir", False, False),
    ("full", "LeastAllocated", "reservoir", True, False),
    ("full", "RequestedToCapacityRatio", "first", True, True),
    ("fit", "MostAllocated", "first", True, True),
    ("fit", "RequestedToCapacityRatio", "reservoir", False, True),
    ("taint-aff", "LeastAllocated", "reservoir", True, True),
    ("taint-aff", "MostAllocated", "first", False, False),
    ("no-scores", "LeastAllocated", "first", True, True),
    ("no-filters", "RequestedToCapacityRatio", "reservoir", True, True),
    ("seven", "LeastAllocated", "first", False, True),
    ("seven", "MostAllocated", "reservoir", True, True),
    ("seven", "LeastAllocated", "reservoir", True, False),
    ("spread", "LeastAllocated", "first", True, True),
    ("spread", "MostAllocated", "reservoir", False, False),
    ("interpod", "LeastAllocated", "reservoir", True, True),
    ("interpod", "MostAllocated", "first", False, True),
]
# first-failure codes each topology profile must show on its cluster:
# PodTopologySpread 1 = node without the zone label, 2 = skew; InterPodAffinity
# 1 = an existing pod's anti-affinity, 2 = required affinity unmet, 3 = own
# anti-affinity
TOPO_CODES = {
    "seven": {"PodTopologySpread": {1, 2}, "InterPodAffinity": {1, 3}},
    "spread": {"PodTopologySpread": {1, 2}},
    "interpod": {"InterPodAffinity": {1, 2, 3}},
}


@pytest.fixture(scope="module")
def problem():
    """48 pending pods over 130 nodes (padded to 160), 40 pods bound."""
    nodes, all_pods, pending = workloads.cluster(48, 130, seed=5, n_bound=40)
    with jax.enable_x64(True):
        pr = JE.pad_problem(JE.encode(nodes, all_pods, pending))
        dp, dims = JB.lower(pr)
    return pr, dp, dims


@pytest.fixture(scope="module")
def topo_problem():
    """The same shape with bench's spread constraints on every 3rd pod and
    the inter-pod terms on every pod, bound ones included (so the spread
    counts and the required anti-affinity carry start non-empty); node 13
    lacks its zone label."""
    nodes, all_pods, pending = workloads.cluster(
        48, 130, seed=5, n_bound=40, spread=lambda i: i % 3 == 0, interpod=lambda i: True,
    )
    del nodes[13]["metadata"]["labels"]["topology.kubernetes.io/zone"]
    with jax.enable_x64(True):
        pr = JE.pad_problem(JE.encode(nodes, all_pods, pending))
        dp, dims = JB.lower(pr)
    assert np.asarray(dp.ip_anti0).any() and np.asarray(dp.spread_counts0).any()
    return pr, dp, dims


def jax_fields(dp) -> dict:
    return {
        k: tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v)
        for k, v in dp._asdict().items()
    }


def run_both(problem, subset, strategy, tie, sampling, trace):
    pr, dp, dims = problem
    filters, scores = SUBSETS[subset]
    shape = RTCR_SHAPE if strategy == "RequestedToCapacityRatio" else ()
    common = dict(filters=tuple(filters), scores=tuple(scores), fit_strategy=strategy,
                  fit_shape=shape, trace=trace, tie_break=tie, seed=7)
    # sampling on: percentage 50 of 130 nodes → the 100-node floor, and a
    # rotated start; tb_base near the uint32 wrap
    jdp = dp._replace(
        sample_k=np.int32(100 if sampling else pr.N_true),
        start0=np.int32(37 if sampling else 0),
        tb_base=np.uint32(4294967290),
    )
    tdp, tdims = interop.from_jax_problem(jax_fields(jdp), dims, device="cpu")
    want = jax_scan(JB.BatchConfig(**common, sampling=sampling), dims, jdp)
    got = port_scan(TB.BatchConfig(**common), tdims, tdp)
    return want, got


def port_scan(cfg, dims, dp, ws0=None) -> dict:
    """The port's scan outputs with ``final_carry`` (the chaining view of
    the final carry fields, checked here) taken out."""
    got = dict(TB.build_batch_fn(cfg, dims, ws0=ws0)(dp))
    carry = got.pop("final_carry")
    assert carry["requested0"] is got["final_requested"] and carry["start0"] is got["final_start"]
    assert carry["ip_anti0"] is got["final_ip_anti"] and carry["csi_attached0"] is got["final_csi_att"]
    return got


# the JAX scan's carry tuple positions of the port's final carries
CARRY_OUTPUTS = {
    "final_ports_used": 3, "final_restr_used": 4, "final_cloud_used": 5, "final_csi_att": 6,
    "final_spread_counts": 7, "final_ip_sel": 8, "final_ip_own": 9, "final_ip_anti": 10,
}


def jax_scan(cfg, dims, jdp, ws0=None) -> dict:
    """The JAX scan's outputs as numpy, its carry donated so the final
    carry comes back: the volume carries join under the port's keys."""
    want = JB.build_batch_fn(cfg, dims, donate=True, ws0=ws0)(jdp)
    carry = want.pop("_final_carry")
    want = {key: np.asarray(v) for key, v in want.items()}
    want.update({key: np.asarray(carry[j]) for key, j in CARRY_OUTPUTS.items()})
    return want


@pytest.mark.parametrize("subset,strategy,tie,sampling,trace", CASES)
def test_scan_matches_reference(request, subset, strategy, tie, sampling, trace):
    problem = request.getfixturevalue("topo_problem" if subset in TOPO_SUBSETS else "problem")
    want, got = run_both(problem, subset, strategy, tie, sampling, trace)
    assert set(want) == set(got)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape, k
        assert np.array_equal(g, v), k
    assert (want["selected"][:48] >= 0).any()
    if trace and subset in TOPO_CODES:
        filters = SUBSETS[subset][0]
        for plugin, codes in TOPO_CODES[subset].items():
            hit = want["fail_plug"][:48] == filters.index(plugin)
            assert set(np.unique(want["fail_code"][:48][hit]).tolist()) == codes, plugin


def test_scan_outputs_cover_the_trace_interface(problem):
    _want, got = run_both(problem, "full", "LeastAllocated", "first", True, True)
    for k in ("packed_pod", "trace_meta", "fail_plug", "fail_code", "feasible",
              "final_requested", "final_nonzero", "final_pod_count", "final_start"):
        assert k in got
    for s, _w in ALL_SCORES:
        assert got[f"raw:{s}"].dtype == torch.float64 and got[f"norm:{s}"].shape == got["feasible"].shape


def test_mix32_matches_hashing():
    xs = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 12345, 987654321]
    for x in xs:
        assert TB._mix32(x) == hashing.mix32(x)
    t = TB._mix32(torch.tensor(xs, dtype=torch.int64))
    assert t.tolist() == [hashing.mix32(x) for x in xs]
    for seed, counter in ((0, 0), (7, 4294967295), (123, 5)):
        assert TB.tie_break_draw(seed, counter) == hashing.tie_break_draw(seed, counter)


def test_primitives_match_reference():
    rng = np.random.default_rng(3)
    a = rng.integers(-500, 5000, 400).astype(np.float64)
    b = rng.integers(0, 70, 400).astype(np.float64)
    feas = rng.random(400) < 0.6
    ta, tb, tf = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(feas)
    pairs = [
        (JB._floordiv(a, b), TB._floordiv(ta, tb)),
        (JB._truncdiv(a, b), TB._truncdiv(ta, tb)),
        (JB._floordiv(a, 3.0), TB._floordiv(ta, 3.0)),
        (JB._broken_linear(np.abs(a) % 120, RTCR_SHAPE), TB._broken_linear(ta.abs() % 120, RTCR_SHAPE)),
        (JB._default_normalize(np.abs(a), feas, True), TB._default_normalize(ta.abs(), tf, True)),
        (JB._default_normalize(np.abs(a), feas, False), TB._default_normalize(ta.abs(), tf, False)),
        (JB._default_normalize(np.zeros(400), feas, True), TB._default_normalize(torch.zeros(400, dtype=torch.float64), tf, True)),
        (JB._minmax_normalize(a, feas), TB._minmax_normalize(ta, tf)),
    ]
    for j, (want, got) in enumerate(pairs):
        assert np.array_equal(np.asarray(want), got.numpy()), j


def _synthetic_out(rng, P, N, nt, code_max, hi):
    out = {
        "sample_start": rng.integers(0, nt, P).astype(np.int32),
        "sample_processed": rng.integers(1, nt + 1, P).astype(np.int32),
        "fail_plug": rng.integers(-1, 5, (P, N)).astype(np.int8),
        "fail_code": rng.integers(0, code_max + 1, (P, N)).astype(np.int32),
        "feasible": rng.random((P, N)) < 0.5,
    }
    for s, _w in ALL_SCORES:
        out[f"raw:{s}"] = rng.integers(-hi, hi + 1, (P, N)).astype(np.float64)
        out[f"norm:{s}"] = rng.integers(0, 101, (P, N)).astype(np.float64)
    return out


@pytest.mark.parametrize("raw_dtype", ["int8", "int16", "int32"])
@pytest.mark.parametrize("code_max", [9, 200, 30000, 70000])  # fail_pack_mode 0..3
def test_compact_blob_matches_reference(code_max, raw_dtype):
    rng = np.random.default_rng(code_max + len(raw_dtype))
    P, N, nt, W, WS = 16, 40, 37, 24, 16
    hi = {"int8": 100, "int16": 30000, "int32": 10**6}[raw_dtype]
    out = _synthetic_out(rng, P, N, nt, code_max, hi)
    rd = (raw_dtype,) * len(ALL_SCORES)
    jfn, jman = JB.build_compact_fn(JB.BatchConfig(filters=SEVEN_FILTERS, scores=ALL_SCORES, trace=True), {"P": P, "N": N}, W, WS, rd, code_max)
    tfn, tman = TB.build_compact_fn(TB.BatchConfig(filters=SEVEN_FILTERS, scores=ALL_SCORES, trace=True), {"P": P, "N": N}, W, WS, rd, code_max)
    assert [tuple(m) for m in jman] == [tuple(m) for m in tman]
    assert TB.fail_pack_mode(code_max, 5) == [9, 200, 30000, 70000].index(code_max)
    want = np.asarray(jfn(out, np.int32(nt)))
    got = tfn({k: torch.from_numpy(v) for k, v in out.items()}, nt).numpy()
    assert got.dtype == np.uint8 and np.array_equal(want, got)


def test_compact_blob_without_filters_matches_reference():
    rng = np.random.default_rng(1)
    P, N, nt, W, WS = 16, 40, 40, 40, 24
    out = _synthetic_out(rng, P, N, nt, 0, 100)
    cfg_kw = dict(filters=(), scores=ALL_SCORES, trace=True)
    jfn, jman = JB.build_compact_fn(JB.BatchConfig(**cfg_kw), {"P": P, "N": N}, W, WS, ("int16",) * 5, 0)
    tfn, tman = TB.build_compact_fn(TB.BatchConfig(**cfg_kw), {"P": P, "N": N}, W, WS, ("int16",) * 5, 0)
    assert jman[0][0] == tman[0][0] == "sids"
    want = np.asarray(jfn(out, np.int32(nt)))
    got = tfn({k: torch.from_numpy(v) for k, v in out.items()}, nt).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("subset", ["full", "seven"])
def test_compact_of_a_real_scan_matches_reference(request, subset):
    """The round's own path: scan planes → widths and fetch dtypes from the
    packed outputs and trace meta → compaction → unpack → reconstruct
    (with the topology plugins: PodTopologySpread's raw and norm planes and
    InterPodAffinity's raw plane, normalized on the host)."""
    problem = request.getfixturevalue("topo_problem" if subset in TOPO_SUBSETS else "problem")
    want, got = run_both(problem, subset, "MostAllocated", "reservoir", True, True)
    pr, _dp, dims = problem
    filters, scores = SUBSETS[subset]
    packed = want["packed_pod"]
    W = min(dims["N"], JE._bucket(int(packed[3].max())))
    WS = min(dims["N"], JE._bucket(int(packed[1].max())))
    mm = want["trace_meta"]
    rd = tuple(JB.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1])) for k in range(len(scores)))
    jcfg = JB.BatchConfig(filters=filters, scores=scores, trace=True)
    tcfg = TB.BatchConfig(filters=filters, scores=scores, trace=True)
    jfn, jman = JB.build_compact_fn(jcfg, dims, W, WS, rd, int(mm[-1, 1]))
    tfn, tman = TB.build_compact_fn(tcfg, dims, W, WS, rd, int(mm[-1, 1]))
    jblob = np.asarray(jfn(want, np.int32(pr.N_true)))
    tblob = tfn(got, pr.N_true).numpy()
    assert np.array_equal(jblob, tblob)
    args = (want["sample_start"], want["sample_processed"], pr.N_true, want["feasible_count"], rd, 48, WS)
    jtr = JB.reconstruct_trace(jcfg, JB.unpack_compact_blob(jblob, jman), *args)
    ttr = TB.reconstruct_trace(tcfg, TB.unpack_compact_blob(tblob, tman), *args)
    assert set(jtr) == set(ttr)
    for k in jtr:
        assert np.array_equal(jtr[k], ttr[k]), k


def test_scan_matches_reference_with_an_extended_resource():
    """A third checked resource widens the Fit bitmask and the carry."""
    nodes, all_pods, pending = workloads.cluster(24, 40, seed=8, n_bound=10)
    for i, n in enumerate(nodes):
        if i % 3 == 0:
            n["status"]["allocatable"]["example.com/accel"] = "2"
    for i, p in enumerate(pending):
        if i % 2 == 0:
            p["spec"]["containers"][0]["resources"]["requests"]["example.com/accel"] = "1"
    pr = JE.pad_problem(JE.encode(nodes, all_pods, pending))
    dp, dims = JB.lower(pr)
    assert dims["R"] == 3
    common = dict(filters=SEVEN_FILTERS, scores=ALL_SCORES, trace=True, tie_break="reservoir", seed=2)
    tdp, tdims = interop.from_jax_problem(jax_fields(dp), dims, device="cpu")
    want = jax_scan(JB.BatchConfig(**common), dims, dp)
    got = port_scan(TB.BatchConfig(**common), tdims, tdp)
    assert set(want) == set(got)
    for k, v in want.items():
        assert np.array_equal(v, got[k].numpy()), k
    bit = 1 << (pr.resource_names.index("example.com/accel") + 1)
    assert (np.asarray(want["fail_code"]) & bit).any()  # an "Insufficient example.com/accel"


# ------------------------------------------- host ports and volumes (K2d)

# upstream's default filters in the registry's order, and its scores with
# their default weights
DEFAULT_FILTERS = (
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
    "VolumeRestrictions", "EBSLimits", "GCEPDLimits", "NodeVolumeLimits", "AzureDiskLimits",
    "VolumeBinding", "VolumeZone", "PodTopologySpread", "InterPodAffinity",
)
DEFAULT_SCORES = (
    ("TaintToleration", 3), ("NodeAffinity", 2), ("NodeResourcesFit", 1), ("PodTopologySpread", 2),
    ("InterPodAffinity", 2), ("NodeResourcesBalancedAllocation", 1), ("ImageLocality", 1),
)
def _nodes(n, **labels_of):
    return [
        mk_node(f"node-{i}", 8000, 16384, labels={k: f(i) for k, f in labels_of.items()}) for i in range(n)
    ]


def _bound(pod, node):
    pod["spec"]["nodeName"] = node
    return pod


def _host_port_case():
    """Two pending pods want hostPort 8080: the second cannot share the
    first one's node."""
    nodes = _nodes(3)
    port = [{"name": "c", "ports": [{"containerPort": 80, "hostPort": 8080}]}]
    pending = [mk_pod(f"p{i}", cpu_m=100) for i in range(2)]
    for p in pending:
        p["spec"]["containers"][0].update(port[0])
    return nodes, pending, pending, {}, ("NodePorts", 0, 1)


def _gce_pd_case():
    """A read-write GCE PD held by a bound pod on node-0 and wanted by two
    pending pods: the disk conflicts on node-0 and, for the second pod, on
    the first one's node."""
    nodes = _nodes(4)
    disk = lambda: [{"name": "d", "gcePersistentDisk": {"pdName": "disk-a"}}]
    bound = _bound(mk_pod("holder", cpu_m=100, volumes=disk()), "node-0")
    pending = [mk_pod(f"p{i}", cpu_m=100, volumes=disk()) for i in range(2)]
    return nodes, [bound] + pending, pending, {}, ("VolumeRestrictions", 0, 1)


def _ebs_case():
    """node-0 already holds EBSLimits' default 39 EBS volumes."""
    nodes = _nodes(3)
    held = [{"name": f"e{k}", "awsElasticBlockStore": {"volumeID": f"held-{k}"}} for k in range(39)]
    bound = _bound(mk_pod("holder", cpu_m=100, volumes=held), "node-0")
    pending = [
        mk_pod(f"p{i}", cpu_m=100, volumes=[{"name": "e", "awsElasticBlockStore": {"volumeID": f"vol-{i}"}}])
        for i in range(3)
    ]
    return nodes, [bound] + pending, pending, {}, None


def _csi_case():
    """CSI nodes allow two volumes of the driver; node-0 already attaches
    one no pending pod mounts.  p0 and p1 share a claim, which the node
    that holds it counts once: p1 fits beside p0, p2 (with a new one) does
    not."""
    nodes = _nodes(3)
    drv = workloads.CSI_DRIVER
    vols = {
        "persistentvolumes": [workloads.mk_pv(n, csi_driver=drv) for n in ("pv-s", "pv-x", "pv-y", "pv-b")],
        "persistentvolumeclaims": [
            workloads.mk_pvc("shared", volume_name="pv-s", access="ReadWriteMany"),
            workloads.mk_pvc("x", volume_name="pv-x"),
            workloads.mk_pvc("y", volume_name="pv-y"),
            workloads.mk_pvc("b", volume_name="pv-b"),
        ],
        "storageclasses": [],
        "csinodes": [workloads.mk_csinode(n["metadata"]["name"], drv, 2) for n in nodes],
    }
    claims = lambda *c: [workloads.pvc_volume(x, f"v{k}") for k, x in enumerate(c)]
    bound = _bound(mk_pod("holder", cpu_m=100, volumes=claims("b")), "node-0")
    pending = [
        mk_pod("p0", cpu_m=100, volumes=claims("shared", "x")),
        mk_pod("p1", cpu_m=100, volumes=claims("shared")),
        mk_pod("p2", cpu_m=100, volumes=claims("shared", "y")),
    ]
    return nodes, [bound] + pending, pending, vols, ("NodeVolumeLimits", 0, 2)


def _binding_case():
    """An unbound Immediate claim fails everywhere (code 1); a claim bound
    to a PV pinned to disk=ssd fails the hdd nodes (code 2)."""
    nodes = _nodes(4, disk=lambda i: "ssd" if i % 2 else "hdd")
    ssd = {"nodeSelectorTerms": [{"matchExpressions": [{"key": "disk", "operator": "In", "values": ["ssd"]}]}]}
    vols = {
        "persistentvolumes": [workloads.mk_pv("pv-pinned", node_affinity=ssd)],
        "persistentvolumeclaims": [
            workloads.mk_pvc("pinned", volume_name="pv-pinned"),
            workloads.mk_pvc("unbound", storage_class="imm"),
        ],
        "storageclasses": [workloads.mk_sc("imm")],
        "csinodes": [],
    }
    pending = [
        mk_pod("p0", cpu_m=100, volumes=[workloads.pvc_volume("unbound")]),
        mk_pod("p1", cpu_m=100, volumes=[workloads.pvc_volume("pinned")]),
    ]
    return nodes, pending, pending, vols, None


def _zone_case():
    """A PV labelled with zone z0: the z1 nodes fail VolumeZone."""
    nodes = _nodes(4, **{"topology.kubernetes.io/zone": lambda i: f"z{i % 2}"})
    vols = {
        "persistentvolumes": [workloads.mk_pv("pv-z", labels={"topology.kubernetes.io/zone": "z0"})],
        "persistentvolumeclaims": [workloads.mk_pvc("zoned", volume_name="pv-z")],
        "storageclasses": [],
        "csinodes": [],
    }
    pending = [mk_pod(f"p{i}", cpu_m=100, volumes=[workloads.pvc_volume("zoned")]) for i in range(2)]
    return nodes, pending, pending, vols, None


def _all_fifteen_case():
    """workloads.cluster with bench's topology, host ports and volumes, bound
    pods holding them too."""
    nodes, all_pods, pending = workloads.cluster(
        48, 130, seed=5, n_bound=40, spread=lambda i: i % 3 == 0, interpod=lambda i: True,
    )
    workloads.add_host_ports(all_pods)
    return nodes, all_pods, pending, workloads.add_volumes(nodes, all_pods, 40), None


# name: (builder, filters, first-failure codes the round must show)
VOLUME_CASES = {
    "host_port": (_host_port_case, DEFAULT_FILTERS, {"NodePorts": {1}}),
    "gce_pd_conflict": (_gce_pd_case, DEFAULT_FILTERS, {"VolumeRestrictions": {1}}),
    "ebs_limit": (_ebs_case, DEFAULT_FILTERS, {"EBSLimits": {1}}),
    "csi_limit_shared_claim": (_csi_case, DEFAULT_FILTERS, {"NodeVolumeLimits": {1}}),
    "volume_binding": (_binding_case, DEFAULT_FILTERS, {"VolumeBinding": {1, 2}}),
    "volume_zone": (_zone_case, DEFAULT_FILTERS, {"VolumeZone": {1}}),
    "all_fifteen": (
        _all_fifteen_case, DEFAULT_FILTERS,
        {"NodePorts": {1}, "NodeVolumeLimits": {1}, "VolumeBinding": {2}, "VolumeZone": {1}},
    ),
}


def run_both_encoders(objs, filters, scores, tie="first", sample_k=None, start0=0, ws0=None):
    """The same objects through both packages' encode + pad + lower, then
    the JAX scan (carry donated, so its final carry comes back) and the
    port's plain scan, in float64: every output equal, the final volume
    carries included.  Returns the JAX outputs."""
    nodes, all_pods, pending, vols = objs
    jpr = JE.pad_problem(JE.encode(nodes, all_pods, pending, volumes=vols))
    tpr = TE.pad_problem(TE.encode(nodes, all_pods, pending, volumes=vols))
    k = sample_k or jpr.N_true
    jdp, dims = JB.lower(jpr)
    jdp = jdp._replace(sample_k=np.int32(k), start0=np.int32(start0), tb_base=np.uint32(11))
    common = dict(filters=tuple(filters), scores=tuple(scores), trace=True, tie_break=tie, seed=7)
    want = jax_scan(JB.BatchConfig(**common), dims, jdp, ws0)
    tdp, tdims = TB.lower(tpr, dtype=torch.float64, device="cpu")
    tdp = tdp._replace(sample_k=k, start0=start0, tb_base=11)
    got = port_scan(TB.BatchConfig(**common), tdims, tdp, ws0)
    assert set(want) == set(got)
    for key, v in want.items():
        g = got[key].numpy()
        assert g.shape == v.shape and np.array_equal(g, v), key
    return want


@pytest.mark.parametrize("case", list(VOLUME_CASES))
def test_volume_and_port_filters_match_reference(case):
    build, filters, codes = VOLUME_CASES[case]
    nodes, all_pods, pending, vols, pair = build()
    want = run_both_encoders((nodes, all_pods, pending, vols), filters, DEFAULT_SCORES)
    P = len(pending)
    fp, fc = want["fail_plug"][:P], want["fail_code"][:P]
    for plugin, expect in codes.items():
        hit = fp == filters.index(plugin)
        assert set(np.unique(fc[hit]).tolist()) == expect, plugin
    if pair is not None:
        # pod `later` fails `plugin` on the node pod `first` took
        plugin, first, later = pair
        node = int(want["selected"][first])
        assert node >= 0 and fp[later, node] == filters.index(plugin) and fc[later, node] == 1
    if case == "csi_limit_shared_claim":
        node = int(want["selected"][0])
        assert fp[1, node] == -1  # the shared claim is already attached there
    if case == "all_fifteen":
        assert want["final_csi_att"].any() and want["final_ports_used"].any()


# ------------------------------------------------- in-step compaction (K2f)

def _in_step(problem, tie, ws0):
    """Both scans on the topology problem with 100 of 130 nodes sampled
    from a rotated start, the score planes compacted to ``ws0``."""
    pr, dp, dims = problem
    common = dict(filters=SEVEN_FILTERS, scores=TOPO_SCORES, trace=True, tie_break=tie, seed=7)
    jdp = dp._replace(sample_k=np.int32(100), start0=np.int32(37), tb_base=np.uint32(99))
    tdp, tdims = interop.from_jax_problem(jax_fields(jdp), dims, device="cpu")
    want = jax_scan(JB.BatchConfig(**common), dims, jdp, ws0)
    got = port_scan(TB.BatchConfig(**common), tdims, tdp, ws0)
    return want, got


WS0 = 112  # bucket(100) < N = 160


@pytest.mark.parametrize("tie", ["first", "reservoir"])
def test_in_step_compaction_matches_reference(topo_problem, tie):
    want, got = _in_step(topo_problem, tie, WS0)
    assert "feasible" not in want and set(want) == set(got)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape and np.array_equal(g, v), k
    assert want["raw:NodeResourcesFit"].shape == (topo_problem[2]["P"], WS0)


def _blob(cfg_mod, want, pr, dims, in_step):
    packed = want["packed_pod"]
    W = min(dims["N"], JE._bucket(int(packed[3].max())))
    WS = min(dims["N"], JE._bucket(int(packed[1].max())), WS0)
    mm = want["trace_meta"]
    rd = tuple(JB.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1])) for k in range(len(TOPO_SCORES)))
    cfg = cfg_mod.BatchConfig(filters=SEVEN_FILTERS, scores=TOPO_SCORES, trace=True)
    fn, _man = cfg_mod.build_compact_fn(cfg, dims, W, WS, rd, int(mm[-1, 1]), in_step_ws0=WS0 if in_step else None)
    return fn, W, WS


def test_in_step_compaction_blob_matches_reference(topo_problem):
    pr, _dp, dims = topo_problem
    want, got = _in_step(topo_problem, "reservoir", WS0)
    jfn, _W, _WS = _blob(JB, want, pr, dims, True)
    tfn, _W, _WS = _blob(TB, want, pr, dims, True)
    assert np.array_equal(np.asarray(jfn(want, np.int32(pr.N_true))), tfn(got, pr.N_true).numpy())


def test_in_step_compaction_blob_equals_the_full_plane_blob(topo_problem):
    """The compacted planes make the same blob as the [P,N] planes compacted
    after the scan, at the width a round picks."""
    pr, _dp, dims = topo_problem
    _want, step = _in_step(topo_problem, "first", WS0)
    _want, full = _in_step(topo_problem, "first", None)
    assert "feasible" in full and "feasible" not in step
    assert torch.equal(step["trace_meta"], full["trace_meta"])
    np_step = {k: v.numpy() for k, v in step.items()}
    fn_step, W, WS = _blob(TB, np_step, pr, dims, True)
    fn_full, W2, WS2 = _blob(TB, np_step, pr, dims, False)
    assert (W, WS) == (W2, WS2) and WS <= WS0
    # every row is a pod's here (48 pods pad to 48): no padding row, whose
    # sampled cells the full planes keep and the compacted ones mask
    assert pr.P_true == dims["P"]
    assert torch.equal(fn_step(step, pr.N_true), fn_full(full, pr.N_true))


# --------------------------------------------------- windowed scan (K2w)

def _window_problem(case):
    """(JAX dp, dims, port dp, cfg kwargs, ws0, Wp) of a windowed-scan case:

    - ``reservoir_wrap``: spread constraints and inter-pod terms, reservoir
      with a base counter 20 below 2**32, so tb_base + offset wraps inside
      the round, and a rotated start;
    - ``volumes_ws0``: upstream's default profile with host ports and
      volumes, 100 of 130 nodes sampled and the score planes compacted in
      the step (ws0 = 112);
    - ``padding_tail``: 57 pending pods padded to 64, windows of 4: the
      last window is all padding."""
    if case == "padding_tail":
        nodes, all_pods, pending = workloads.cluster(57, 60, seed=9, n_bound=10, spread=lambda i: i % 2 == 0)
        vols, filters, scores = {}, SEVEN_FILTERS, TOPO_SCORES
        knobs = dict(sample_k=60, start0=0, tb_base=5)
        tie, ws0, Wp = "first", None, 4
    elif case == "reservoir_wrap":
        nodes, all_pods, pending = workloads.cluster(
            48, 130, seed=5, n_bound=40, spread=lambda i: i % 3 == 0, interpod=lambda i: True,
        )
        vols, filters, scores = {}, SEVEN_FILTERS, TOPO_SCORES
        knobs = dict(sample_k=130, start0=37, tb_base=(1 << 32) - 20)
        tie, ws0, Wp = "reservoir", None, 16
    else:
        nodes, all_pods, pending = workloads.cluster(
            48, 130, seed=6, n_bound=40, spread=lambda i: i % 3 == 0, interpod=lambda i: i % 2 == 0,
        )
        workloads.add_host_ports(all_pods)
        vols = workloads.add_volumes(nodes, all_pods, 40)
        filters, scores = DEFAULT_FILTERS, DEFAULT_SCORES
        knobs = dict(sample_k=100, start0=71, tb_base=3)
        tie, ws0, Wp = "first", 112, 16
    jpr = JE.pad_problem(JE.encode(nodes, all_pods, pending, volumes=vols))
    jdp, dims = JB.lower(jpr)
    jdp = jdp._replace(
        sample_k=np.int32(knobs["sample_k"]), start0=np.int32(knobs["start0"]), tb_base=np.uint32(knobs["tb_base"]),
    )
    tdp, tdims = TB.lower(TE.pad_problem(TE.encode(nodes, all_pods, pending, volumes=vols)), dtype=torch.float64, device="cpu")
    tdp = tdp._replace(**knobs)
    common = dict(filters=tuple(filters), scores=tuple(scores), trace=True, tie_break=tie, seed=7)
    return jdp, dims, tdp, tdims, common, ws0, Wp


WINDOW_CASES = ("reservoir_wrap", "volumes_ws0", "padding_tail")


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windowed_plain_scan_equals_one_call_and_the_reference(case):
    """The plain scan chained over windows (each from the previous window's
    final carry) equals the one-call plain scan in every output and in the
    whole final carry, and equals the JAX ``build_batch_fn(window=Wp)``
    chained through ``_final_carry``, in float64."""
    jdp, dims, tdp, tdims, common, ws0, Wp = _window_problem(case)
    P = dims["P"]
    assert P % Wp == 0 and P // Wp >= 3
    cfg = TB.BatchConfig(**common)
    one = TB.scan_plain(cfg, tdims, tdp, ws0=ws0)
    fnw = TB.build_batch_fn(cfg, tdims, ws0=ws0, window=Wp)
    jfn = JB.build_batch_fn(JB.BatchConfig(**common), dims, ws0=ws0, window=Wp)
    jcarry = tuple(getattr(jdp, f) for f in JB.CARRY0_FIELDS)
    jslim = jdp._replace(**{f: np.int32(0) for f in JB.CARRY0_FIELDS})
    carry, outs, jouts = None, [], []
    for off in range(0, P, Wp):
        out = fnw(carry, tdp, off)
        carry = out["final_carry"]
        outs.append(out)
        ys = jfn(jcarry, jslim, np.int32(off))
        jcarry = ys.pop("_final_carry")
        jouts.append({k: np.asarray(v) for k, v in ys.items()})
    row_keys = [k for k in one if k.startswith(("raw:", "norm:", "fail_")) or k == "feasible"]
    for k in row_keys + ["selected", "feasible_count", "sample_start", "sample_processed"]:
        chained = torch.cat([o[k] for o in outs])
        assert torch.equal(chained, one[k]), k
        assert np.array_equal(np.concatenate([j[k] for j in jouts]), one[k].numpy()), k
    for w, (o, j) in enumerate(zip(outs, jouts)):
        assert np.array_equal(o["packed_pod"].numpy(), j["packed_pod"]), w
        assert np.array_equal(o["trace_meta"].numpy(), j["trace_meta"]), w
    for pos, f in enumerate(TB.CARRY0_FIELDS):
        assert torch.equal(carry[f].reshape(-1), one["final_carry"][f].reshape(-1)), f
        assert np.array_equal(np.asarray(jcarry[pos]).reshape(-1), carry[f].numpy().reshape(-1)), f
    assert (one["selected"] >= 0).any()
    if case == "padding_tail":
        assert not tdp.pod_active[P - Wp :].any() and (outs[-1]["selected"] == -1).all()
    if case == "reservoir_wrap":
        assert one["final_carry"]["ip_anti0"].any() and one["final_carry"]["spread_counts0"].any()


def test_windowed_scan_keeps_the_reservoir_counter_of_the_whole_round():
    """A window's draws are keyed by each pod's position in the whole round:
    slice_pod_window shifts tb_base by the offset, modulo 2**32."""
    _jdp, _dims, tdp, _tdims, _common, _ws0, Wp = _window_problem("reservoir_wrap")
    w = TB.slice_pod_window(tdp, 32, Wp)
    assert w.tb_base == (tdp.tb_base + 32) % (1 << 32) == 12
    assert torch.equal(w.pod_req, tdp.pod_req[32:48]) and torch.equal(w.term_match, tdp.term_match[:, 32:48])


# --------------------------------------------------- row scatter (K4)

SCATTER_DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.float32, np.float64]


@pytest.mark.parametrize("dtype", SCATTER_DTYPES, ids=lambda d: np.dtype(d).name)
def test_scatter_rows_plain_equals_the_reference(dtype):
    """``scatter_rows_plain`` equals the JAX ``_scatter_rows`` on every plane
    dtype, on rank-1 and rank-2 planes, with repeated indices carrying
    identical rows (the placer's padding)."""
    rng = np.random.default_rng(3)
    for shape in ((40,), (40, 3)):
        buf = (rng.integers(0, 90, shape) % (2 if dtype is np.bool_ else 90)).astype(dtype)
        idx = np.array([5, 0, 39, 17, 5, 5], dtype=np.int32)
        rows = (rng.integers(0, 90, (6,) + shape[1:]) % (2 if dtype is np.bool_ else 90)).astype(dtype)
        rows[4:] = rows[0]  # repeats carry the first index's row
        want = np.asarray(JB._scatter_rows(jax.numpy.asarray(buf), idx, rows))
        got = TB.scatter_rows(torch.from_numpy(buf.copy()), torch.from_numpy(idx), torch.from_numpy(rows))
        assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want), shape


# ------------------------------- per-pod term-group lists (InterPodAffinity)

def test_term_lists_hold_each_pods_groups_ascending():
    """``ip_match_g`` row i: the groups g with term_match[g, i] != 0 in
    ascending g, -1 padded to the most any pod matches (at least 1): pods
    that match no group, one, and several set out of column order."""
    tm = np.zeros((6, 5))
    tm[3, 1] = 1.0
    tm[[5, 0, 2], 2] = 1.0
    tm[[4, 1], 4] = 1.0
    lists = TB.term_lists(tm)["ip_match_g"]
    assert lists.dtype == np.int32
    assert lists.tolist() == [[-1, -1, -1], [3, -1, -1], [0, 2, 5], [-1, -1, -1], [1, 4, -1]]
    assert TB.term_lists(np.zeros((1, 4), dtype=bool))["ip_match_g"].tolist() == [[-1]] * 4


def test_ip_match_g_is_term_match_pattern_of_the_reference_problem(topo_problem):
    """On the seeded inter-pod cluster lowered by the JAX package, the port's
    list (carried across and lowered by the port itself) is term_match's
    nonzero pattern, pod by pod, with pods of 0, 1 and 2 groups."""
    pr, jdp, dims = topo_problem
    tm = np.asarray(jdp.term_match)
    tdp, _ = interop.from_jax_problem(jax_fields(jdp), dims, device="cpu")
    own, _ = TB.lower(pr, dtype=torch.float64, device="cpu")
    for dp in (tdp, own):
        lists = dp.ip_match_g.numpy()
        assert lists.shape == (tm.shape[1], max(int((tm != 0).sum(axis=0).max()), 1))
        for i in range(tm.shape[1]):
            assert lists[i][lists[i] >= 0].tolist() == np.nonzero(tm[:, i])[0].tolist(), i
            assert (lists[i][(lists[i] >= 0).sum():] == -1).all(), i
    counts = set((tm != 0).sum(axis=0).tolist())
    assert {0, 1, 2} <= counts, counts


def test_ip_match_g_under_a_window_offset_is_the_full_problems_rows(topo_problem):
    """A window's view hands the list in at row ``offset``, as every other
    pod-row plane."""
    pr, _jdp, _dims = topo_problem
    tdp, _ = TB.lower(pr, dtype=torch.float64, device="cpu")
    for off, wp in ((0, 16), (16, 16), (40, 8)):
        w = TB.slice_pod_window(tdp, off, wp)
        assert torch.equal(w.ip_match_g, tdp.ip_match_g[off : off + wp])
        assert torch.equal((w.term_match != 0).sum(dim=0), (w.ip_match_g >= 0).sum(dim=1))


def test_device_placer_reuses_and_scatters_ip_match_g(topo_problem):
    """The DevicePlacer routes the list like any pod-row plane: reused when
    no pod's groups changed, row-updated when a few did, and the placed
    rows equal the host's."""
    pr, _jdp, dims = topo_problem
    placer = TB.DevicePlacer()
    cpu = torch.device("cpu")
    key = tuple(sorted(dims.items()))
    host, _ = TB.lower_host(pr, torch.float64)
    placer.place(host, key, cpu)
    assert placer.decisions[("ip_match_g", None)][0] == "full"
    placer.place(TB.lower_host(pr, torch.float64)[0], key, cpu)
    assert placer.decisions[("ip_match_g", None)] == ("reuse", 0)
    host3, _ = TB.lower_host(pr, torch.float64)
    tm = host3["term_match"].copy()
    tm[:, 3] = 0.0
    tm[[0, 2], 3] = 1.0
    host3["term_match"] = tm
    host3.update(TB.term_lists(tm))
    d3 = placer.place(host3, key, cpu)
    assert placer.decisions[("ip_match_g", None)][0] == "scatter" and "ip_match_g" in placer.last_scattered
    assert torch.equal(d3.ip_match_g, torch.from_numpy(host3["ip_match_g"]))
    assert d3.ip_match_g[3].tolist()[:2] == [0, 2]


# ------------------------------------------- K2g's residual and contraction


@pytest.mark.parametrize("fixture,subset,tie", [
    ("problem", "full", "first"), ("topo_problem", "seven", "first"), ("topo_problem", "seven", "reservoir"),
])
@pytest.mark.parametrize("fseed", [1, 2])
def test_residual_and_contraction_equal_grad_plain(request, fixture, subset, tie, fseed):
    """K2g's pair of plain versions: the residual M folded over the plain
    step, then contracted with a seeded F, equals grad_plain's per-pod
    closed form to 1e-12 of its norm in float64, for any F (the identity is
    linear in F and rests only on each softmax summing to 1); the pair's
    rollout is the hard one, bitwise."""
    pr, _jdp, _dims = request.getfixturevalue(fixture)
    dp, dims = TB.lower(pr, dtype=torch.float64, device="cpu")
    dp = dp._replace(sample_k=100, start0=37, tb_base=4294967290)
    filters, scores = SUBSETS[subset]
    cfg = TB.BatchConfig(filters=tuple(filters), scores=tuple(scores), tie_break=tie, seed=7)
    rng = np.random.default_rng(fseed)
    w = torch.as_tensor(rng.uniform(0.2, 3.0, len(scores)))
    F = torch.as_tensor(rng.normal(size=(dims["N"], 2)))
    M, out = TB.grad_residual_plain(cfg, dims, dp, w, 50.0)
    assert M.shape == (2, len(scores), dims["N"]) and M.dtype == torch.float64
    got = TB.grad_contract_plain(M, F, 50.0)
    want, hard = TB.grad_plain(cfg, dims, dp, w, F, 50.0)
    assert float(want.norm()) > 0
    assert float((got - want).norm()) <= 1e-12 * float(want.norm()), (got, want)
    for k in ("packed_pod", "final_requested", "final_nonzero", "final_pod_count", "final_ip_sel"):
        assert torch.equal(out[k], hard[k]), k

