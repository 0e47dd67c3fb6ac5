"""Pod effective resource-request computation.

Upstream semantics (k8s resource helpers used by NodeResourcesFit's
computePodResourceRequest, which the reference traces through its wrapped
plugins): effective request = max(max(initContainers), sum(containers))
per resource, plus pod overhead.

Canonical internal units (shared with the feature encoder):
- cpu            -> milli-cores (MilliValue)
- memory         -> bytes (Value)
- ephemeral-storage -> bytes
- everything else (hugepages, extended resources) -> Value
"""

from __future__ import annotations

from typing import Any, Mapping

from kube_scheduler_simulator_tpu_torch.utils.quantity import milli_value, value

Obj = Mapping[str, Any]

CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"


def is_fit_resource(r: str) -> bool:
    """Whether NodeResourcesFit checks resource ``r`` (upstream
    InsufficientResource: cpu/memory/ephemeral-storage, hugepages-*,
    attachable-volumes-*, extended "<domain>/<name>" resources).  The
    single source of truth for BOTH the sequential Fit plugin
    (plugins/intree/noderesources.py) and the batch encoder
    (ops/encode.py) — they must never diverge."""
    return (
        r in (CPU, MEMORY, EPHEMERAL_STORAGE)
        or "/" in r
        or r.startswith("hugepages-")
        or r.startswith("attachable-volumes-")
    )


def _to_internal(resource: str, q: Any) -> int:
    if resource == CPU:
        return milli_value(q)
    return value(q)


def _requests_of(container: Obj) -> dict[str, int]:
    reqs = (container.get("resources") or {}).get("requests") or {}
    return {r: _to_internal(r, q) for r, q in reqs.items()}


def pod_resource_request(pod: Obj) -> dict[str, int]:
    """Effective resource request of a pod in canonical internal units."""
    spec = pod.get("spec") or {}
    total: dict[str, int] = {}
    for c in spec.get("containers") or []:
        for r, v in _requests_of(c).items():
            total[r] = total.get(r, 0) + v
    for c in spec.get("initContainers") or []:
        for r, v in _requests_of(c).items():
            if v > total.get(r, 0):
                total[r] = v
    for r, q in (spec.get("overhead") or {}).items():
        total[r] = total.get(r, 0) + _to_internal(r, q)
    return total


def node_allocatable(node: Obj) -> dict[str, int]:
    """Node allocatable in canonical internal units (falls back to capacity)."""
    status = node.get("status") or {}
    alloc = status.get("allocatable") or status.get("capacity") or {}
    return {r: _to_internal(r, q) for r, q in alloc.items()}
