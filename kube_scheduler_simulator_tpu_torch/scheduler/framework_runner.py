"""Upstream's feasible-node sampling cap (sched.numFeasibleNodesToFind), the
one piece of the sequential framework runner the batch engine reads."""

from __future__ import annotations

MIN_FEASIBLE_NODES_TO_FIND = 100
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5


def num_feasible_nodes_to_find(num_all_nodes: int, percentage: int) -> int:
    """Upstream sched.numFeasibleNodesToFind."""
    if num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND or percentage >= 100:
        return num_all_nodes
    adaptive = percentage
    if adaptive <= 0:
        adaptive = 50 - num_all_nodes // 125
        if adaptive < MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND:
            adaptive = MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND
    num_nodes = num_all_nodes * adaptive // 100
    if num_nodes < MIN_FEASIBLE_NODES_TO_FIND:
        return MIN_FEASIBLE_NODES_TO_FIND
    return num_nodes
