"""Whole rounds: the port's BatchEngine against the JAX package's.

The same cluster objects go through ``BatchEngine.schedule`` of both
packages (the port on the CPU in float64, through its plain versions; the
reference in float64 with ``incremental=False``), for two rounds with
nonzero attempt counters and start indexes.  Every pod's selected node and
every annotation document (filter, score, finalScore) must be equal byte
for byte, which also proves the port's Python render paths against the
reference's native ones.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.scheduler.batch_engine import BatchEngine as JaxEngine  # noqa: E402
from test_batch_parity import mk_node, mk_pod  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    """The reference runs in float64 here (the port's CPU dtype), scoped to
    each test so other test files keep the process default."""
    with jax.enable_x64(True):
        yield


SCORES = [
    ("NodeResourcesFit", 1),
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("TaintToleration", 3),
    ("NodeAffinity", 2),
]
RTCR_SHAPE = ((0, 20), (40, 100), (100, 10))
# the seven-plugin profile: upstream's default scores with their default
# weights, and its filters without NodePorts and the volume filters
TOPO_SCORES = SCORES + [("PodTopologySpread", 2), ("InterPodAffinity", 2)]
SEVEN_FILTERS = [
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodeResourcesFit",
    "PodTopologySpread", "InterPodAffinity",
]
# upstream's default profile as the service's default configuration hands
# it to the engine: every filter in the registry's order, the scores in
# that order with their default weights
REGISTRY_FILTERS = [
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
    "VolumeRestrictions", "EBSLimits", "GCEPDLimits", "NodeVolumeLimits", "AzureDiskLimits",
    "VolumeBinding", "VolumeZone", "PodTopologySpread", "InterPodAffinity",
]
DEFAULT_SCORES = [
    ("TaintToleration", 3), ("NodeAffinity", 2), ("NodeResourcesFit", 1), ("PodTopologySpread", 2),
    ("InterPodAffinity", 2), ("NodeResourcesBalancedAllocation", 1), ("ImageLocality", 1),
]


@pytest.fixture(scope="module")
def cluster():
    return workloads.cluster(48, 130, seed=9, n_bound=40)


@pytest.fixture(scope="module")
def topo_cluster():
    """Spread constraints on every 3rd pod, inter-pod terms on every pod
    (bound pods included)."""
    return workloads.cluster(48, 130, seed=9, n_bound=40, spread=lambda i: i % 3 == 0, interpod=lambda i: True)


def assert_rounds_match(ref, port, nodes, all_pods, pending, rounds=((0, 0), (1000, 17)), volumes=None):
    """Both engines schedule the same snapshot; selections and every
    annotation document must be equal byte for byte."""
    assert port.supported(pending, nodes, volumes) == (True, "")
    for base_counter, start_index in rounds:
        kw = dict(base_counter=base_counter, start_index=start_index, volumes=volumes)
        want = ref.schedule(nodes, all_pods, pending, **kw)
        got = port.schedule(nodes, all_pods, pending, **kw)
        assert got.selected_nodes == want.selected_nodes
        assert got.final_start == want.final_start
        assert any(s is not None for s in got.selected_nodes)
        for i in range(len(pending)):
            assert got.filter_annotation_json(i) == want.filter_annotation_json(i), i
            assert got.score_annotations_json(i) == want.score_annotations_json(i), i


@pytest.mark.parametrize(
    "tie_break,percentage,strategy,profile,hard_weight",
    [
        ("first", 100, "LeastAllocated", "five", 1),
        ("reservoir", 50, "MostAllocated", "five", 1),
        ("reservoir", 0, "RequestedToCapacityRatio", "five", 1),
        ("first", 100, "LeastAllocated", "seven", 1),
        ("reservoir", 50, "MostAllocated", "seven", 0),
        ("reservoir", 0, "LeastAllocated", "seven", 5),
    ],
)
def test_rounds_match_reference_byte_for_byte(request, tie_break, percentage, strategy, profile, hard_weight):
    nodes, all_pods, pending = request.getfixturevalue("cluster" if profile == "five" else "topo_cluster")
    kw = dict(
        filters=SEVEN_FILTERS, scores=SCORES if profile == "five" else TOPO_SCORES,
        fit_strategy=strategy, fit_shape=RTCR_SHAPE if strategy == "RequestedToCapacityRatio" else None,
        percentage_of_nodes_to_score=percentage, trace=True, tie_break=tie_break, seed=3,
        hard_pod_affinity_weight=hard_weight,
    )
    assert_rounds_match(JaxEngine(**kw, incremental=False), BatchEngine(**kw, device="cpu"), nodes, all_pods, pending)


def _spread_nodes_and_pods():
    zones = ["z1", "z2", "z3"]
    nodes = [
        mk_node(f"node-{i}", cpu_m=8000, mem_mi=16384,
                labels={"topology.kubernetes.io/zone": zones[i % 3], "kubernetes.io/hostname": f"node-{i}"})
        for i in range(9)
    ]
    constraint = [
        {"maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone", "whenUnsatisfiable": "DoNotSchedule",
         "labelSelector": {"matchLabels": {"app": "web"}}},
        {"maxSkew": 2, "topologyKey": "kubernetes.io/hostname", "whenUnsatisfiable": "ScheduleAnyway",
         "labelSelector": {"matchLabels": {"app": "web"}}},
    ]
    pods = [mk_pod(f"web-{i}", cpu_m=100, mem_mi=128, labels={"app": "web"}, topologySpreadConstraints=constraint)
            for i in range(18)]
    return nodes, pods + [mk_pod(f"other-{i}", cpu_m=100, labels={"app": "db"}) for i in range(6)]


def _spread_missing_label_nodes_and_pods():
    nodes = [
        mk_node("node-a", 4000, 8192, labels={"zone": "z1"}),
        mk_node("node-b", 4000, 8192, labels={"zone": "z2"}),
        mk_node("node-c", 4000, 8192, labels={}),
    ]
    c = [{"maxSkew": 1, "topologyKey": "zone", "whenUnsatisfiable": "DoNotSchedule",
          "labelSelector": {"matchLabels": {"app": "x"}}}]
    return nodes, [mk_pod(f"x-{i}", cpu_m=100, labels={"app": "x"}, topologySpreadConstraints=c) for i in range(6)]


def _interpod_nodes_and_pods():
    nodes = [
        mk_node(f"node-{i}", cpu_m=8000, mem_mi=16384,
                labels={"zone": ["z1", "z2", "z3"][i % 3], "kubernetes.io/hostname": f"node-{i}"})
        for i in range(9)
    ]
    db = {"matchLabels": {"app": "db"}}
    anti = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"labelSelector": db, "topologyKey": "kubernetes.io/hostname"}]}}
    aff = {"podAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{"labelSelector": db, "topologyKey": "zone"}],
        "preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 50, "podAffinityTerm": {"labelSelector": db, "topologyKey": "zone"}}],
    }}
    pods = [mk_pod(f"db-{i}", cpu_m=500, mem_mi=512, labels={"app": "db"}, affinity=anti) for i in range(4)]
    return nodes, pods + [mk_pod(f"web-{i}", cpu_m=100, mem_mi=128, labels={"app": "web"}, affinity=aff) for i in range(8)]


def _interpod_existing_nodes_and_pods():
    nodes = [
        mk_node(f"node-{i}", 8000, 16384, labels={"zone": ["z1", "z2"][i % 2], "kubernetes.io/hostname": f"node-{i}"})
        for i in range(6)
    ]
    existing = mk_pod("guard", cpu_m=100, labels={"app": "guard"}, affinity={"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"app": "web"}}, "topologyKey": "zone"}]}})
    existing["spec"]["nodeName"] = "node-0"
    return nodes, [existing] + [mk_pod(f"web-{i}", cpu_m=100, labels={"app": "web"}) for i in range(4)]


# the small spread and inter-pod workloads of tests/test_batch_parity.py
# (test_topology_spread, test_topology_spread_missing_label,
# test_interpod_affinity_antiaffinity, test_interpod_with_existing_pods)
REFERENCE_WORKLOADS = {
    "topology_spread": (_spread_nodes_and_pods, "PodTopologySpread"),
    "topology_spread_missing_label": (_spread_missing_label_nodes_and_pods, "PodTopologySpread"),
    "interpod_affinity_antiaffinity": (_interpod_nodes_and_pods, "InterPodAffinity"),
    "interpod_with_existing_pods": (_interpod_existing_nodes_and_pods, "InterPodAffinity"),
}


@pytest.mark.parametrize("name", list(REFERENCE_WORKLOADS))
def test_reference_topology_workloads_match_byte_for_byte(name):
    build, plugin = REFERENCE_WORKLOADS[name]
    nodes, pods = build()
    pending = [p for p in pods if not p["spec"].get("nodeName")]
    kw = dict(filters=["NodeResourcesFit", plugin], scores=[("NodeResourcesFit", 1), (plugin, 2)], trace=True)
    assert_rounds_match(JaxEngine(**kw, incremental=False), BatchEngine(**kw, device="cpu"), nodes, pods, pending,
                        rounds=((0, 0),))


def test_round_reports_timings_and_profile(cluster):
    nodes, all_pods, pending = cluster
    eng = BatchEngine(scores=SCORES, trace=True, device="cpu")
    eng.schedule(nodes, all_pods, pending)
    assert set(eng.last_timings) == {"encode_s", "lower_s", "device_s", "total_s", "promoted_f64"}
    assert eng.last_timings["promoted_f64"] == 0.0 and eng.last_promotion is None
    assert eng.dtype == eng.round_dtype == torch.float64
    snap = eng.profiler.snapshot()
    assert snap["waves"] == 1


def test_supported_rejects_what_the_port_has_no_kernel_for(cluster):
    nodes, _all_pods, pending = cluster
    # the whole default profile is ported, in either order
    for filters in (REGISTRY_FILTERS, None):
        assert BatchEngine(filters=filters, scores=DEFAULT_SCORES, device="cpu").supported(pending, nodes) == (True, "")
    ok, why = BatchEngine(filters=REGISTRY_FILTERS + ["Coscheduling"], device="cpu").supported(pending, nodes)
    assert not ok and why == "filter plugin Coscheduling has no batch kernel"
    ok, why = BatchEngine(scores=SCORES + [("NodeResourcesFitPlus", 1)], device="cpu").supported(pending, nodes)
    assert not ok and why == "score plugin NodeResourcesFitPlus has no batch kernel"
    # the encoder's caps: 128 distinct host ports, 128 conflict volumes
    many = [dict(p, spec=dict(p["spec"])) for p in pending[:1] * 129]
    for k, p in enumerate(many):
        p["spec"]["containers"] = [dict(p["spec"]["containers"][0], ports=[{"containerPort": 80, "hostPort": 9000 + k}])]
    ok, why = BatchEngine(device="cpu").supported(many, nodes)
    assert not ok and why == "129 distinct host ports exceed the batch kernel cap"
    assert BatchEngine(device="cpu").supported(many[:128], nodes) == (True, "")
    for k, p in enumerate(many):
        p["spec"]["containers"] = pending[0]["spec"]["containers"]
        p["spec"]["volumes"] = [{"name": "d", "gcePersistentDisk": {"pdName": f"disk-{k}"}}]
    ok, why = BatchEngine(device="cpu").supported(many, nodes)
    assert not ok and why == "129 distinct conflict volumes exceed the batch kernel cap"
    # a claim that does not exist is VolumeBinding's PreFilter reject
    claimed = [dict(pending[0], spec=dict(pending[0]["spec"], volumes=[workloads.pvc_volume("gone")]))]
    ok, why = BatchEngine(device="cpu").supported(claimed, nodes, {"persistentvolumeclaims": []})
    assert not ok and "missing PersistentVolumeClaim" in why
    present = {"persistentvolumeclaims": [workloads.mk_pvc("gone")]}
    assert BatchEngine(device="cpu").supported(claimed, nodes, present) == (True, "")
    ok, why = BatchEngine(scores=SCORES, device="cpu").supported(pending, [])
    assert not ok and why == "no nodes in cluster"
    nominated = dict(pending[0], status={"nominatedNodeName": "node-1"})
    ok, why = BatchEngine(scores=SCORES, device="cpu").supported([nominated], nodes)
    assert not ok and "nominated" in why


def test_default_filters_equal_the_reference_engines():
    assert BatchEngine(device="cpu").filters == JaxEngine(incremental=False).filters == list(TB.FILTER_KERNELS)


@pytest.fixture(scope="module")
def storage_cluster():
    """The topology cluster with DaemonSet host ports and volumes (own and
    shared claims, WaitForFirstConsumer claims, cloud disks, CSI nodes),
    bound pods holding them too."""
    nodes, all_pods, pending = workloads.cluster(
        48, 130, seed=9, n_bound=40, spread=lambda i: i % 3 == 0, interpod=lambda i: True,
    )
    workloads.add_host_ports(all_pods)
    return nodes, all_pods, pending, workloads.add_volumes(nodes, all_pods, 40)


@pytest.mark.parametrize(
    "order,tie_break,percentage",
    [
        ("registry", "first", 100),
        ("registry", "reservoir", 30),  # 100 of 130 nodes sampled: in-step compaction
        ("kernels", "reservoir", 100),
        ("kernels", "first", 30),
    ],
)
def test_default_profile_rounds_match_reference_byte_for_byte(storage_cluster, order, tie_break, percentage):
    nodes, all_pods, pending, vols = storage_cluster
    kw = dict(
        filters=REGISTRY_FILTERS if order == "registry" else None, scores=DEFAULT_SCORES,
        percentage_of_nodes_to_score=percentage, trace=True, tie_break=tie_break, seed=3,
    )
    port = BatchEngine(**kw, device="cpu")
    assert_rounds_match(JaxEngine(**kw, incremental=False), port, nodes, all_pods, pending, volumes=vols)
    res = port.schedule(nodes, all_pods, pending, volumes=vols)
    failed = {port.cfg.filters[k] for k in np.unique(res.out["trace"]["fail_plug"]) if k >= 0}
    assert {"NodePorts", "NodeVolumeLimits", "VolumeBinding", "VolumeZone"} <= failed


def _mixed_everything(seed):
    """tests/test_batch_volumes.py's cross-feature workload (bound and
    WaitForFirstConsumer claims, GCE PD conflicts, CSI limits, host ports,
    images, taints, node and inter-pod affinity, spread) as objects."""
    import random

    rng = random.Random(seed)
    ssd = {"nodeSelectorTerms": [{"matchExpressions": [{"key": "disk", "operator": "In", "values": ["ssd"]}]}]}
    vols = {
        "storageclasses": [workloads.mk_sc("wfc", binding_mode="WaitForFirstConsumer")],
        "persistentvolumes": [
            workloads.mk_pv("pv-pinned", labels={"topology.kubernetes.io/zone": "z0"}, node_affinity=ssd)
        ],
        "persistentvolumeclaims": [workloads.mk_pvc("claim-pinned", volume_name="pv-pinned")]
        + [workloads.mk_pvc(f"claim-wfc-{c}", storage_class="wfc") for c in range(4)],
        "csinodes": [],
    }
    nodes = []
    for i in range(12):
        node = mk_node(
            f"node-{i}", 8000, 16384,
            labels={"topology.kubernetes.io/zone": f"z{i % 3}", "kubernetes.io/hostname": f"node-{i}",
                    "disk": "ssd" if i % 2 else "hdd"},
            taints=[{"key": "spot", "value": "t", "effect": "PreferNoSchedule"}] if i % 5 == 0 else None,
        )
        node["status"]["images"] = (
            [{"names": [f"img-{i % 2}:v1"], "sizeBytes": 400 * 1024 * 1024}] if i % 3 == 0 else []
        )
        nodes.append(node)
        vols["csinodes"].append(workloads.mk_csinode(f"node-{i}", workloads.CSI_DRIVER, 2))
    pods = []
    for i in range(36):
        p = mk_pod(f"pod-{i}", cpu_m=rng.choice([100, 250, 500]), mem_mi=rng.choice([128, 256]),
                   labels={"app": f"app-{i % 4}"})
        spec = p["spec"]
        spec["containers"][0]["image"] = f"img-{i % 2}:v1"
        if i % 6 == 0:
            spec["volumes"] = [workloads.pvc_volume("claim-pinned")]
        elif i % 6 == 1:
            spec["volumes"] = [workloads.pvc_volume(f"claim-wfc-{i % 4}")]
        elif i % 6 == 2:
            spec["volumes"] = [{"name": "d", "gcePersistentDisk": {"pdName": f"disk-{i % 3}", "readOnly": i % 2 == 0}}]
        if i % 7 == 0:
            spec["containers"][0]["ports"] = [{"containerPort": 80, "hostPort": 8000 + (i % 3)}]
        if i % 4 == 0:
            spec["nodeSelector"] = {"disk": "ssd"}
        if i % 3 == 0:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 3, "topologyKey": "topology.kubernetes.io/zone", "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": f"app-{i % 4}"}},
            }]
        if i % 5 == 1:
            spec["affinity"] = {"podAntiAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [{
                "weight": 7, "podAffinityTerm": {
                    "labelSelector": {"matchLabels": {"app": f"app-{i % 4}"}},
                    "topologyKey": "kubernetes.io/hostname"},
            }]}}
        pods.append(p)
    return nodes, pods, vols


def test_mixed_everything_default_profile_matches_byte_for_byte():
    nodes, pods, vols = _mixed_everything(4242)
    kw = dict(filters=REGISTRY_FILTERS, scores=DEFAULT_SCORES, trace=True)
    assert_rounds_match(
        JaxEngine(**kw, incremental=False), BatchEngine(**kw, device="cpu"), nodes, pods, pods,
        rounds=((0, 0),), volumes=vols,
    )
