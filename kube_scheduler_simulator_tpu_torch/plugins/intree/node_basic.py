"""NodeName, NodeUnschedulable, NodePorts plugins (upstream v1.26).

Filter-only plugins of the default profile.  Cited behavior: upstream
pkg/scheduler/framework/plugins/{nodename,nodeunschedulable,nodeports};
the reference wraps these unchanged (reference
simulator/scheduler/plugin/plugins.go:38-84).
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import CycleState, Status
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo
from kube_scheduler_simulator_tpu_torch.utils.labels import tolerations_tolerate_taint

Obj = dict[str, Any]

NODE_NAME_ERR = "node(s) didn't match the requested node name"
NODE_UNSCHEDULABLE_ERR = "node(s) were unschedulable"
NODE_UNKNOWN_CONDITION_ERR = "node(s) had unknown conditions"
NODE_PORTS_ERR = "node(s) didn't have free ports for the requested pod ports"

TAINT_NODE_UNSCHEDULABLE = {"key": "node.kubernetes.io/unschedulable", "effect": "NoSchedule"}


class NodeName:
    name = "NodeName"

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        want = (pod.get("spec") or {}).get("nodeName")
        if want and want != node_info.name:
            return Status.unresolvable(NODE_NAME_ERR)
        return None


class NodeUnschedulable:
    name = "NodeUnschedulable"

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        node = node_info.node
        if node is None:
            return Status.unresolvable(NODE_UNKNOWN_CONDITION_ERR)
        if not (node.get("spec") or {}).get("unschedulable"):
            return None
        tolerations = (pod.get("spec") or {}).get("tolerations") or []
        if tolerations_tolerate_taint(tolerations, TAINT_NODE_UNSCHEDULABLE):
            return None
        return Status.unresolvable(NODE_UNSCHEDULABLE_ERR)


def _host_ports(pod: Obj) -> list[tuple[str, str, int]]:
    """(protocol, hostIP, hostPort) triples a pod wants on the host."""
    out = []
    for c in (pod.get("spec") or {}).get("containers") or []:
        for p in c.get("ports") or []:
            hp = p.get("hostPort")
            if hp:
                out.append((p.get("protocol") or "TCP", p.get("hostIP") or "0.0.0.0", int(hp)))
    return out


def _ports_conflict(want: tuple[str, str, int], used: tuple[str, str, int]) -> bool:
    """Upstream schedutil.HostPortInfo conflict: same port+protocol and
    overlapping IP (0.0.0.0 overlaps everything)."""
    wproto, wip, wport = want
    uproto, uip, uport = used
    if wport != uport or wproto != uproto:
        return False
    return wip == uip or wip == "0.0.0.0" or uip == "0.0.0.0"


class NodePorts:
    name = "NodePorts"

    PRE_FILTER_KEY = "PreFilterNodePorts"

    def pre_filter(self, state: CycleState, pod: Obj):
        state.write(self.PRE_FILTER_KEY, _host_ports(pod))
        return None, None

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        want = state.read(self.PRE_FILTER_KEY)
        if want is None:
            want = _host_ports(pod)
        if not want:
            return None
        used = [hp for p in node_info.pods for hp in _host_ports(p)]
        for w in want:
            for u in used:
                if _ports_conflict(w, u):
                    return Status.unschedulable(NODE_PORTS_ERR)
        return None
