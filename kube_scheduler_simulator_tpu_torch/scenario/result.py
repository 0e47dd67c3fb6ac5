"""Scenario result calculation (KEP-140 result packages).

The KEP defines post-run analysis helpers — "the rate of scheduled Pods /
all Pods" and "resource utilization of each Node"
(keps/140-scenario-based-simulation/README.md:553-565).
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.nodeinfo import build_node_infos
from kube_scheduler_simulator_tpu_torch.models.podresources import CPU, MEMORY, PODS

Obj = dict[str, Any]


def allocation_rate(store: Any) -> float:
    """Scheduled pods / all pods (1.0 for an empty cluster)."""
    pods = store.list("pods")
    if not pods:
        return 1.0
    scheduled = sum(1 for p in pods if (p.get("spec") or {}).get("nodeName"))
    return scheduled / len(pods)


def node_utilization(store: Any) -> dict[str, dict[str, float]]:
    """Per-node requested/allocatable fraction for cpu, memory, pods."""
    infos = build_node_infos(store.list("nodes"), store.list("pods"))
    out: dict[str, dict[str, float]] = {}
    for ni in infos:
        util: dict[str, float] = {}
        for r in (CPU, MEMORY, PODS):
            alloc = ni.allocatable.get(r, 0)
            used = len(ni.pods) if r == PODS else ni.requested.get(r, 0)
            util[r] = (used / alloc) if alloc else 0.0
        out[ni.name] = util
    return out
