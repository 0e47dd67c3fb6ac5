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
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.scheduler.batch_engine import BatchEngine as JaxEngine  # noqa: E402
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


@pytest.fixture(scope="module")
def cluster():
    return workloads.cluster(48, 130, seed=9, n_bound=40)


@pytest.mark.parametrize(
    "tie_break,percentage,strategy",
    [
        ("first", 100, "LeastAllocated"),
        ("reservoir", 50, "MostAllocated"),
        ("reservoir", 0, "RequestedToCapacityRatio"),
    ],
)
def test_rounds_match_reference_byte_for_byte(cluster, tie_break, percentage, strategy):
    nodes, all_pods, pending = cluster
    kw = dict(
        filters=list(TB.SLICE_FILTERS), scores=SCORES, fit_strategy=strategy,
        fit_shape=RTCR_SHAPE if strategy == "RequestedToCapacityRatio" else None,
        percentage_of_nodes_to_score=percentage, trace=True, tie_break=tie_break, seed=3,
    )
    ref = JaxEngine(**kw, incremental=False)
    port = BatchEngine(**kw, device="cpu")
    assert port.supported(pending, nodes) == (True, "")
    for base_counter, start_index in ((0, 0), (1000, 17)):
        want = ref.schedule(nodes, all_pods, pending, base_counter=base_counter, start_index=start_index)
        got = port.schedule(nodes, all_pods, pending, base_counter=base_counter, start_index=start_index)
        assert got.selected_nodes == want.selected_nodes
        assert got.final_start == want.final_start
        assert any(s is not None for s in got.selected_nodes)
        for i in range(len(pending)):
            assert got.filter_annotation_json(i) == want.filter_annotation_json(i), i
            assert got.score_annotations_json(i) == want.score_annotations_json(i), i


def test_round_reports_timings_and_profile(cluster):
    nodes, all_pods, pending = cluster
    eng = BatchEngine(scores=SCORES, trace=True, device="cpu")
    eng.schedule(nodes, all_pods, pending)
    assert set(eng.last_timings) == {"encode_s", "lower_s", "device_s", "total_s"}
    assert eng.dtype == torch.float64
    snap = eng.profiler.snapshot()
    assert snap["waves"] == 1


def test_supported_rejects_what_the_port_has_no_kernel_for(cluster):
    nodes, _all_pods, pending = cluster
    spread_pod = workloads.mk_pod(0, __import__("random").Random(0), spread=True)
    eng = BatchEngine(filters=list(TB.SLICE_FILTERS) + ["PodTopologySpread"], scores=SCORES, device="cpu")
    ok, why = eng.supported(pending + [spread_pod], nodes)
    assert not ok and "PodTopologySpread" in why
    eng = BatchEngine(scores=SCORES + [("InterPodAffinity", 2)], device="cpu")
    ok, why = eng.supported(pending, nodes)
    assert not ok and "InterPodAffinity" in why
    ok, why = BatchEngine(filters=["Coscheduling"], device="cpu").supported(pending, nodes)
    assert not ok and why == "filter plugin Coscheduling has no batch kernel"
    ok, why = BatchEngine(scores=SCORES, device="cpu").supported(pending, [])
    assert not ok and why == "no nodes in cluster"
    nominated = dict(pending[0], status={"nominatedNodeName": "node-1"})
    ok, why = BatchEngine(scores=SCORES, device="cpu").supported([nominated], nodes)
    assert not ok and "nominated" in why
