"""NodeResourcesFit + NodeResourcesBalancedAllocation (upstream v1.26).

The headline Filter+Score plugin pair.  Semantics mirrored:

- effective pod request = max(init, sum(containers)) + overhead
  (models.podresources), with upstream's non-zero defaults
  (100m CPU / 200Mi memory) applied per container for scoring
- Filter reasons: "Too many pods" / "Insufficient <resource>"
  (upstream noderesources/fit.go InsufficientResource)
- LeastAllocated score: int64 math
  sum_r weight_r * (alloc_r - requested_r) * 100 / alloc_r / sum weights
- BalancedAllocation: 1 - std of requested fractions, float64 then
  truncated to int64

The vectorized twin of this file is ops/fit.py; the batch engine uses that,
this class is the parity oracle and the sequential-path implementation.
"""

from __future__ import annotations

import math
from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import MAX_NODE_SCORE, CycleState, Status
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo
from kube_scheduler_simulator_tpu_torch.models.podresources import (
    CPU,
    EPHEMERAL_STORAGE,
    MEMORY,
    PODS,
    is_fit_resource,
    pod_resource_request,
)
from kube_scheduler_simulator_tpu_torch.utils.quantity import milli_value, value

Obj = dict[str, Any]

# util.GetNonzeroRequests defaults (upstream pkg/scheduler/util).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

# RequestedToCapacityRatio scoring (upstream noderesources/
# requested_to_capacity_ratio.go): user shape scores are 0..10
# (config.MaxCustomPriorityScore) and scale to the 0..100 node-score range.
MAX_CUSTOM_PRIORITY_SCORE = 10


def go_div(a: int, b: int) -> int:
    """Go integer division (truncation toward zero — Python's ``//``
    floors, which differs for negative numerators, and the broken-linear
    shape interpolation has negative score deltas on descending ramps)."""
    if b == 0:
        return 0
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def broken_linear(p: int, shape: "tuple[tuple[int, int], ...]") -> int:
    """helper.BuildBrokenLinearFunction: piecewise-linear interpolation
    over (utilization, score) points with Go integer arithmetic; clamps
    to the first/last point outside the shape's utilization range."""
    for i, (u, s) in enumerate(shape):
        if p <= u:
            if i == 0:
                return s
            u0, s0 = shape[i - 1]
            return s0 + go_div((s - s0) * (p - u0), u - u0)
    return shape[-1][1]


def pod_non_zero_request(pod: Obj) -> dict[str, int]:
    """cpu/memory request with per-container non-zero defaults (used by the
    scoring path, upstream NodeInfo.NonZeroRequested)."""
    spec = pod.get("spec") or {}
    cpu = 0
    mem = 0
    for c in spec.get("containers") or []:
        reqs = (c.get("resources") or {}).get("requests") or {}
        cpu += milli_value(reqs[CPU]) if CPU in reqs else DEFAULT_MILLI_CPU_REQUEST
        mem += value(reqs[MEMORY]) if MEMORY in reqs else DEFAULT_MEMORY_REQUEST
    init_cpu = 0
    init_mem = 0
    for c in spec.get("initContainers") or []:
        reqs = (c.get("resources") or {}).get("requests") or {}
        init_cpu = max(init_cpu, milli_value(reqs[CPU]) if CPU in reqs else DEFAULT_MILLI_CPU_REQUEST)
        init_mem = max(init_mem, value(reqs[MEMORY]) if MEMORY in reqs else DEFAULT_MEMORY_REQUEST)
    cpu = max(cpu, init_cpu)
    mem = max(mem, init_mem)
    overhead = spec.get("overhead") or {}
    if CPU in overhead:
        cpu += milli_value(overhead[CPU])
    if MEMORY in overhead:
        mem += value(overhead[MEMORY])
    return {CPU: cpu, MEMORY: mem}


def node_non_zero_requested(node_info: NodeInfo) -> dict[str, int]:
    cpu = 0
    mem = 0
    for p in node_info.pods:
        r = pod_non_zero_request(p)
        cpu += r[CPU]
        mem += r[MEMORY]
    return {CPU: cpu, MEMORY: mem}


class NodeResourcesFit:
    name = "NodeResourcesFit"

    PRE_FILTER_KEY = "PreFilterNodeResourcesFit"

    def __init__(self, args: "Obj | None" = None):
        args = args or {}
        strategy = (args.get("scoringStrategy") or {})
        self.strategy_type = strategy.get("type") or "LeastAllocated"
        resources = strategy.get("resources") or [
            {"name": CPU, "weight": 1},
            {"name": MEMORY, "weight": 1},
        ]
        self.score_resources = [(r["name"], int(r.get("weight") or 1)) for r in resources]
        # RequestedToCapacityRatio shape: (utilization, score*10) points,
        # utilization ascending (upstream scales config scores 0..10 up to
        # the 0..100 node-score range at build time).  The default ramp is
        # the canonical bin-packing shape (score rises with utilization).
        shape = (strategy.get("requestedToCapacityRatio") or {}).get("shape") or [
            {"utilization": 0, "score": 0},
            {"utilization": 100, "score": MAX_CUSTOM_PRIORITY_SCORE},
        ]
        self.rtcr_shape = tuple(
            sorted(
                (int(pt.get("utilization") or 0), int(pt.get("score") or 0) * (MAX_NODE_SCORE // MAX_CUSTOM_PRIORITY_SCORE))
                for pt in shape
            )
        )

    # -- PreFilter: compute the effective request once per pod
    def pre_filter(self, state: CycleState, pod: Obj):
        state.write(self.PRE_FILTER_KEY, pod_resource_request(pod))
        return None, None

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        req = state.read(self.PRE_FILTER_KEY)
        if req is None:
            req = pod_resource_request(pod)
        reasons: list[str] = []
        if len(node_info.pods) + 1 > node_info.allowed_pod_number():
            reasons.append("Too many pods")
        for r, want in req.items():
            if want == 0 or not is_fit_resource(r):
                continue
            have = node_info.allocatable.get(r, 0) - node_info.requested.get(r, 0)
            if want > have:
                reasons.append(f"Insufficient {r}")
        if reasons:
            return Status.unschedulable(*reasons)
        return None

    # -- Score (LeastAllocated / MostAllocated / RequestedToCapacityRatio)
    def score(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "tuple[int, Status | None]":
        pod_req = pod_non_zero_request(pod)
        node_req = node_non_zero_requested(node_info)
        node_score = 0
        weight_sum = 0
        for r, weight in self.score_resources:
            alloc = node_info.allocatable.get(r, 0)
            if r in (CPU, MEMORY):
                requested = node_req.get(r, 0) + pod_req.get(r, 0)
            else:
                requested = node_info.requested.get(r, 0) + pod_resource_request(pod).get(r, 0)
            node_score += self._score_one(requested, alloc) * weight
            weight_sum += weight
        if weight_sum == 0:
            return 0, None
        return node_score // weight_sum, None

    def _score_one(self, requested: int, alloc: int) -> int:
        if self.strategy_type == "RequestedToCapacityRatio":
            # upstream resourceScoringFunction: over-capacity (or zero
            # capacity) evaluates the shape at maxUtilization, NOT 0
            if alloc == 0 or requested > alloc:
                return broken_linear(100, self.rtcr_shape)
            return broken_linear(requested * 100 // alloc, self.rtcr_shape)
        if alloc == 0:
            return 0
        if self.strategy_type == "MostAllocated":
            if requested > alloc:
                return 0
            return requested * MAX_NODE_SCORE // alloc
        # LeastAllocated (default)
        if requested > alloc:
            return 0
        return (alloc - requested) * MAX_NODE_SCORE // alloc


class NodeResourcesBalancedAllocation:
    name = "NodeResourcesBalancedAllocation"

    def __init__(self, args: "Obj | None" = None):
        args = args or {}
        resources = args.get("resources") or [{"name": CPU, "weight": 1}, {"name": MEMORY, "weight": 1}]
        self.resources = [r["name"] for r in resources]

    def score(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "tuple[int, Status | None]":
        pod_req = pod_non_zero_request(pod)
        node_req = node_non_zero_requested(node_info)
        fractions: list[float] = []
        for r in self.resources:
            alloc = node_info.allocatable.get(r, 0)
            if alloc == 0:
                fractions.append(1.0)
                continue
            if r in (CPU, MEMORY):
                requested = node_req.get(r, 0) + pod_req.get(r, 0)
            else:
                requested = node_info.requested.get(r, 0) + pod_resource_request(pod).get(r, 0)
            frac = requested / alloc
            fractions.append(min(frac, 1.0))
        if len(fractions) == 2:
            std = abs(fractions[0] - fractions[1]) / 2
        elif len(fractions) > 2:
            mean = sum(fractions) / len(fractions)
            std = math.sqrt(sum((f - mean) ** 2 for f in fractions) / len(fractions))
        else:
            std = 0.0
        return int((1 - std) * MAX_NODE_SCORE), None
