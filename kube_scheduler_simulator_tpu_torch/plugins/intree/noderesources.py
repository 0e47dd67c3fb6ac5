"""NodeResourcesFit / BalancedAllocation constants and the non-zero request
helper the encoder reads (upstream v1.26 util.GetNonzeroRequests)."""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.podresources import CPU, MEMORY
from kube_scheduler_simulator_tpu_torch.utils.quantity import milli_value, value

Obj = dict[str, Any]

# util.GetNonzeroRequests defaults (upstream pkg/scheduler/util).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


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
