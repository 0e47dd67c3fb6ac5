"""Capacity engine: a simulated cluster-autoscaler over the batch scan.

Port of the JAX package's ``autoscaler/``.  Public surface:

- :class:`ClusterAutoscaler` — the scale-up / scale-down passes
- :class:`ScaleUpEstimator` — P pods x G templates in one launch of the
  lane scan (K8, csrc/scan.cu on the card)
- :data:`NODE_GROUP_LABEL` — the ownership label on autoscaled nodes
- :func:`validate_node_group` — NodeGroup admission
"""

from kube_scheduler_simulator_tpu_torch.autoscaler.engine import ClusterAutoscaler
from kube_scheduler_simulator_tpu_torch.autoscaler.estimator import GroupEstimate, ScaleUpEstimator
from kube_scheduler_simulator_tpu_torch.autoscaler.expander import EXPANDERS, pick
from kube_scheduler_simulator_tpu_torch.autoscaler.nodegroups import (
    NODE_GROUP_LABEL,
    group_nodes,
    synthetic_node,
    validate_node_group,
)

__all__ = [
    "ClusterAutoscaler",
    "ScaleUpEstimator",
    "GroupEstimate",
    "EXPANDERS",
    "pick",
    "NODE_GROUP_LABEL",
    "group_nodes",
    "synthetic_node",
    "validate_node_group",
]
