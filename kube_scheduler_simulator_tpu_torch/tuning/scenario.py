"""Deterministic scenario families for the weight tuner.

The port's own copy of the JAX package's ``tuning/scenario.py``.

Each family generates a (nodes, pods) workload whose OPTIMAL plugin
weighting differs from the default profile's — the tuner has something
real to find — and names the objective that exposes the gap:

- ``imbalance``: a shape-split cluster — cpu-rich nodes are soft-tainted
  spot capacity, mem-rich nodes clean — fed alternating cpu-heavy and
  mem-heavy pods.  The default profile's dominant TaintToleration weight
  dodges the tainted half, crowding both pod shapes onto the mem-rich
  nodes and stranding resources; lowering it (paying the soft-taint
  preference) shape-matches and recovers the objective.  Objective:
  ``fragmentation``.
- ``consolidate``: pods carry preferred pod-affinity to their own app
  label on the hostname topology.  LeastAllocated spreads them thin; a
  heavier InterPodAffinity weight packs apps onto shared nodes.
  Objective: ``utilization`` (concentration-weighted packing).
- ``tail``: the consolidate shape with a tail of large pods at the back
  of the queue — spreading the small pods early leaves no node with room
  for the tail, packing does.  Objective: ``pending_age``.

Everything is seeded and pure (no store, no wall clock): the same
(family, sizes, seed) always yields byte-identical workloads, which is
what lets BENCH_tune.json rows and the tier-1 smoke replay exactly.
"""

from __future__ import annotations

import random
from typing import Any

Obj = dict[str, Any]

# deterministic creationTimestamps: PrioritySort tie-breaks on them, and
# the tuner's rollouts must replay identically across runs
_T0 = "2024-01-01T00:{:02d}:{:02d}Z"


def _stamp(i: int) -> str:
    return _T0.format((i // 60) % 60, i % 60)


def _node(
    i: int,
    cpu_m: int = 16000,
    mem_mi: int = 32768,
    pods: int = 64,
    taints: "list | None" = None,
) -> Obj:
    n: Obj = {
        "metadata": {
            "name": f"tune-node-{i}",
            "labels": {
                "kubernetes.io/hostname": f"tune-node-{i}",
                "topology.kubernetes.io/zone": f"z{i % 3}",
            },
            "creationTimestamp": _stamp(0),
        },
        "status": {
            "allocatable": {
                "cpu": f"{cpu_m}m",
                "memory": f"{mem_mi}Mi",
                "pods": str(pods),
            }
        },
    }
    if taints:
        n["spec"] = {"taints": taints}
    return n


def _pod(i: int, cpu_m: int, mem_mi: int, labels: "dict | None" = None) -> Obj:
    return {
        "metadata": {
            "name": f"tune-pod-{i:04d}",
            "namespace": "default",
            "labels": labels or {},
            "creationTimestamp": _stamp(i),
        },
        "spec": {
            "containers": [
                {
                    "name": "c",
                    "resources": {
                        "requests": {"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"}
                    },
                }
            ]
        },
    }


def _self_affinity(app: str, weight: int = 50) -> Obj:
    return {
        "podAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {
                    "weight": weight,
                    "podAffinityTerm": {
                        "labelSelector": {"matchLabels": {"app": app}},
                        "topologyKey": "kubernetes.io/hostname",
                    },
                }
            ]
        }
    }


def _gen_imbalance(n_nodes: int, n_pods: int, rng: random.Random):
    # shape-split cluster: cpu-rich/mem-poor nodes (soft-tainted spot
    # capacity) and mem-rich/cpu-poor on-demand nodes, fed alternating
    # cpu-heavy and mem-heavy pods.  The fragmentation-optimal policy
    # shape-matches (cpu-heavy → cpu-rich), but the default profile's
    # TaintToleration weight (3, the largest) makes every pod dodge the
    # soft-tainted half, crowding both shapes onto the mem-rich nodes
    # and stranding capacity — the tuner's job is learning that paying
    # the soft-taint preference is worth it here (e.g. lowering the
    # TaintToleration weight toward 0 recovers ~0.33 of objective).
    spot = [{"key": "spot", "value": "true", "effect": "PreferNoSchedule"}]
    nodes = [
        _node(i, cpu_m=32000, mem_mi=8192, taints=spot)
        if i % 2 == 0
        else _node(i, cpu_m=4000, mem_mi=65536)
        for i in range(n_nodes)
    ]
    pods = []
    for i in range(n_pods):
        if i % 2 == 0:  # cpu-heavy, memory-light
            pods.append(_pod(i, rng.choice([1800, 2000, 2200]), rng.choice([256, 512])))
        else:  # memory-heavy, cpu-light
            pods.append(_pod(i, rng.choice([150, 200, 250]), rng.choice([3072, 4096])))
    return nodes, pods


def _gen_consolidate(n_nodes: int, n_pods: int, rng: random.Random):
    nodes = [_node(i) for i in range(n_nodes)]
    pods = []
    n_apps = max(n_nodes // 2, 2)
    for i in range(n_pods):
        app = f"app-{i % n_apps}"
        p = _pod(i, rng.choice([400, 500, 600]), rng.choice([768, 1024]), labels={"app": app})
        p["spec"]["affinity"] = _self_affinity(app)
        pods.append(p)
    return nodes, pods


def _gen_tail(n_nodes: int, n_pods: int, rng: random.Random):
    nodes, pods = _gen_consolidate(n_nodes, max(n_pods - n_pods // 5, 1), rng)
    base = len(pods)
    for j in range(n_pods // 5):
        # the tail: pods that only fit a mostly-empty node
        pods.append(_pod(base + j, 11000, 20480, labels={"app": "tail"}))
    return nodes, pods


FAMILIES: "dict[str, dict]" = {
    "imbalance": {"gen": _gen_imbalance, "objective": "fragmentation"},
    "consolidate": {"gen": _gen_consolidate, "objective": "utilization"},
    "tail": {"gen": _gen_tail, "objective": "pending_age"},
}


def build_family(
    family: str, n_nodes: int = 12, n_pods: int = 96, seed: int = 0
) -> "tuple[list[Obj], list[Obj], str]":
    """(nodes, pods, default objective name) for a named family."""
    spec = FAMILIES.get(family)
    if spec is None:
        raise ValueError(f"unknown scenario family {family!r}; choose from {sorted(FAMILIES)}")
    rng = random.Random(seed)
    nodes, pods = spec["gen"](int(n_nodes), int(n_pods), rng)
    return nodes, pods, spec["objective"]
