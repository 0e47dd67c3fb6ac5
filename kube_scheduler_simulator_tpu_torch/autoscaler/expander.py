"""Expanders: pick which node group a scale-up goes to.

Port of the JAX package's ``autoscaler/expander.py``, copied whole.

The upstream cluster-autoscaler ships several expander strategies; the
simulator implements the three deterministic ones (``random`` is
deliberately absent — scenario replay forbids nondeterminism, KEP-140
determinism rules):

- ``least-waste``: the group whose used template copies leave the least
  unused allocatable fraction (upstream's resource-waste score);
- ``most-pods``: the group that schedules the most pending pods;
- ``priority``: the helping group with the highest ``spec.priority``
  (upstream's priority expander, ConfigMap replaced by the spec field).

Ties break on (metric, group name) so identical estimates always pick
the same group.
"""

from __future__ import annotations

from typing import Iterable

from kube_scheduler_simulator_tpu_torch.autoscaler.estimator import GroupEstimate

EXPANDERS = ("least-waste", "most-pods", "priority")


def pick(expander: str, estimates: Iterable[GroupEstimate]) -> "GroupEstimate | None":
    """The winning estimate, or None when no group helps any pod."""
    helping = [e for e in estimates if e.pods_fit > 0 and e.nodes_needed > 0]
    if not helping:
        return None
    if expander == "most-pods":
        return min(helping, key=lambda e: (-e.pods_fit, e.waste, e.group))
    if expander == "priority":
        return min(helping, key=lambda e: (-e.priority, e.waste, e.group))
    # least-waste (default): prefer less waste; more pods breaks ties
    return min(helping, key=lambda e: (e.waste, -e.pods_fit, e.group))
