"""In-tree plugin registry + default profile ordering (upstream v1.26).

The MultiPoint order and score weights are pinned by the reference's config
tests (reference simulator/scheduler/config/plugin_test.go:150-167 lists the
wrapped default plugin set; weights TaintToleration=3, NodeAffinity=2,
PodTopologySpread=2, InterPodAffinity=2, NodeResourcesFit=1,
NodeResourcesBalancedAllocation=1, ImageLocality=1).

A plugin participates in every extension point whose method it implements —
exactly how upstream expands MultiPoint registrations.
"""

from __future__ import annotations

from typing import Any, Callable

from kube_scheduler_simulator_tpu_torch.plugins.intree.imagelocality import ImageLocality
from kube_scheduler_simulator_tpu_torch.plugins.intree.interpodaffinity import InterPodAffinity
from kube_scheduler_simulator_tpu_torch.plugins.intree.node_basic import (
    NodeName,
    NodePorts,
    NodeUnschedulable,
)
from kube_scheduler_simulator_tpu_torch.plugins.intree.nodeaffinity import NodeAffinity
from kube_scheduler_simulator_tpu_torch.plugins.intree.noderesources import (
    NodeResourcesBalancedAllocation,
    NodeResourcesFit,
)
from kube_scheduler_simulator_tpu_torch.plugins.intree.podtopologyspread import PodTopologySpread
from kube_scheduler_simulator_tpu_torch.plugins.intree.queue_bind import (
    DefaultBinder,
    DefaultPreemption,
    PrioritySort,
)
from kube_scheduler_simulator_tpu_torch.plugins.intree.tainttoleration import TaintToleration
from kube_scheduler_simulator_tpu_torch.plugins.intree.volumes import (
    AzureDiskLimits,
    EBSLimits,
    GCEPDLimits,
    NodeVolumeLimits,
    VolumeBinding,
    VolumeRestrictions,
    VolumeZone,
)

# The gang oracle (gang/plugin.py) registers like the sigs
# scheduler-plugins build registers coscheduling: available by name for
# profiles that enable it, NOT part of the default MultiPoint set.
from kube_scheduler_simulator_tpu_torch.gang.plugin import Coscheduling

Obj = dict[str, Any]
PluginFactory = Callable[["Obj | None", Any], Any]

# Default MultiPoint enablement order (v1.26 default_plugins.go, as pinned by
# the reference's tests).
DEFAULT_PLUGIN_ORDER: tuple[str, ...] = (
    "PrioritySort",
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodePorts",
    "NodeResourcesFit",
    "VolumeRestrictions",
    "EBSLimits",
    "GCEPDLimits",
    "NodeVolumeLimits",
    "AzureDiskLimits",
    "VolumeBinding",
    "VolumeZone",
    "PodTopologySpread",
    "InterPodAffinity",
    "DefaultPreemption",
    "NodeResourcesBalancedAllocation",
    "ImageLocality",
    "DefaultBinder",
)

DEFAULT_SCORE_WEIGHTS: dict[str, int] = {
    "TaintToleration": 3,
    "NodeAffinity": 2,
    "NodeResourcesFit": 1,
    "PodTopologySpread": 2,
    "InterPodAffinity": 2,
    "NodeResourcesBalancedAllocation": 1,
    "ImageLocality": 1,
}


def _no_handle(cls: type) -> PluginFactory:
    return lambda args, handle: cls()


def _args_only(cls: type) -> PluginFactory:
    return lambda args, handle: cls(args)


def _args_handle(cls: type) -> PluginFactory:
    return lambda args, handle: cls(args, handle)


_REGISTRY: dict[str, PluginFactory] = {
    "PrioritySort": _no_handle(PrioritySort),
    "NodeUnschedulable": _no_handle(NodeUnschedulable),
    "NodeName": _no_handle(NodeName),
    "TaintToleration": _no_handle(TaintToleration),
    "NodeAffinity": _args_only(NodeAffinity),
    "NodePorts": _no_handle(NodePorts),
    "NodeResourcesFit": _args_only(NodeResourcesFit),
    "VolumeRestrictions": _args_handle(VolumeRestrictions),
    "EBSLimits": _args_handle(EBSLimits),
    "GCEPDLimits": _args_handle(GCEPDLimits),
    "NodeVolumeLimits": _args_handle(NodeVolumeLimits),
    "AzureDiskLimits": _args_handle(AzureDiskLimits),
    "VolumeBinding": _args_handle(VolumeBinding),
    "VolumeZone": _args_handle(VolumeZone),
    "PodTopologySpread": _args_handle(PodTopologySpread),
    "InterPodAffinity": _args_handle(InterPodAffinity),
    "DefaultPreemption": _args_handle(DefaultPreemption),
    "NodeResourcesBalancedAllocation": _args_only(NodeResourcesBalancedAllocation),
    "ImageLocality": _args_handle(ImageLocality),
    "DefaultBinder": _args_handle(DefaultBinder),
    "Coscheduling": _args_handle(Coscheduling),
}


def in_tree_registry() -> dict[str, PluginFactory]:
    return dict(_REGISTRY)
