"""NodeInfo: a node plus its scheduled pods and aggregated resource usage.

Analog of the upstream framework.NodeInfo snapshot entries that the
reference's hot Filter/Score loop iterates (SURVEY.md section 3.2 hot loop;
reference scheduler/scheduler.go:174-267 mirrors the loop nest).
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.podresources import (
    PODS,
    node_allocatable,
    pod_resource_request,
)

Obj = dict[str, Any]


class NodeInfo:
    __slots__ = ("node", "pods", "requested", "allocatable")

    def __init__(self, node: Obj):
        self.node = node
        self.pods: list[Obj] = []
        self.requested: dict[str, int] = {}
        self.allocatable: dict[str, int] = node_allocatable(node)

    @property
    def name(self) -> str:
        return self.node["metadata"]["name"]

    def add_pod(self, pod: Obj) -> None:
        self.pods.append(pod)
        for r, v in pod_resource_request(pod).items():
            self.requested[r] = self.requested.get(r, 0) + v

    def remove_pod(self, pod: Obj) -> None:
        uid = pod["metadata"].get("uid")
        name = pod["metadata"].get("name")
        for i, p in enumerate(self.pods):
            if (uid and p["metadata"].get("uid") == uid) or (not uid and p["metadata"].get("name") == name):
                self.pods.pop(i)
                for r, v in pod_resource_request(pod).items():
                    self.requested[r] = self.requested.get(r, 0) - v
                return

    def allowed_pod_number(self) -> int:
        return self.allocatable.get(PODS, 0)


def build_node_infos(nodes: list[Obj], pods: list[Obj]) -> list[NodeInfo]:
    """Build the scheduler-cache snapshot: NodeInfo per node, with every
    already-assigned pod accounted on its node."""
    infos = [NodeInfo(n) for n in nodes]
    by_name = {ni.name: ni for ni in infos}
    for p in pods:
        node_name = (p.get("spec") or {}).get("nodeName")
        if node_name and node_name in by_name:
            by_name[node_name].add_pod(p)
    return infos
