"""Scheduler-cache snapshot: the per-cycle view of nodes + assigned pods.

Analog of the upstream shared lister snapshot the reference's hot loop
iterates (SURVEY.md section 3.2).  Plugins that need cluster-wide context
(PodTopologySpread, InterPodAffinity) read it through the framework handle.
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo, build_node_infos

Obj = dict[str, Any]


def has_pending_nomination(pod: Obj) -> bool:
    """Unbound pod carrying a preemption nomination — the single
    definition shared by Snapshot (sequential reservation) and the batch
    engine's supported() gate, so the two paths can't drift."""
    return bool((pod.get("status") or {}).get("nominatedNodeName")) and not (
        (pod.get("spec") or {}).get("nodeName")
    )


def _pod_has_affinity(pod: Obj) -> bool:
    aff = (pod.get("spec") or {}).get("affinity") or {}
    pa = aff.get("podAffinity") or {}
    paa = aff.get("podAntiAffinity") or {}
    return bool(
        pa.get("requiredDuringSchedulingIgnoredDuringExecution")
        or pa.get("preferredDuringSchedulingIgnoredDuringExecution")
        or paa.get("requiredDuringSchedulingIgnoredDuringExecution")
        or paa.get("preferredDuringSchedulingIgnoredDuringExecution")
    )


def _pod_has_required_anti_affinity(pod: Obj) -> bool:
    aff = (pod.get("spec") or {}).get("affinity") or {}
    paa = aff.get("podAntiAffinity") or {}
    return bool(paa.get("requiredDuringSchedulingIgnoredDuringExecution"))


class Snapshot:
    """NodeInfos plus the two filtered node lists upstream maintains."""

    def __init__(self, nodes: list[Obj], pods: list[Obj], namespaces: "list[Obj] | None" = None):
        self.node_infos: list[NodeInfo] = build_node_infos(nodes, pods)
        self._by_name = {ni.name: ni for ni in self.node_infos}
        self.namespace_labels: dict[str, dict[str, str]] = {
            ns["metadata"]["name"]: ns["metadata"].get("labels") or {} for ns in namespaces or []
        }
        # UNBOUND pods nominated onto a node by preemption (upstream's
        # nominator): other pods' filter runs must account for them
        self.nominated: dict[str, list[Obj]] = {}
        for p in pods:
            if has_pending_nomination(p):
                self.nominated.setdefault(p["status"]["nominatedNodeName"], []).append(p)

    def get(self, name: str) -> "NodeInfo | None":
        return self._by_name.get(name)

    def nominated_pods(self, node_name: str) -> list[Obj]:
        return self.nominated.get(node_name, [])

    def have_pods_with_affinity(self) -> list[NodeInfo]:
        return [ni for ni in self.node_infos if any(_pod_has_affinity(p) for p in ni.pods)]

    def have_pods_with_required_anti_affinity(self) -> list[NodeInfo]:
        return [ni for ni in self.node_infos if any(_pod_has_required_anti_affinity(p) for p in ni.pods)]

    def assume(self, pod: Obj, node_name: str) -> None:
        """Account a pod onto a node (the cache 'assume' after Reserve)."""
        ni = self._by_name.get(node_name)
        if ni is not None:
            pod = dict(pod)
            spec = dict(pod.get("spec") or {})
            spec["nodeName"] = node_name
            pod["spec"] = spec
            ni.add_pod(pod)
        # an assumed pod is no longer a pending nomination — leaving it in
        # self.nominated would double-count its resources for later pods
        me = pod["metadata"]
        key = (me.get("namespace", "default"), me["name"])
        for nn, lst in list(self.nominated.items()):
            kept = [
                q
                for q in lst
                if (q["metadata"].get("namespace", "default"), q["metadata"]["name"]) != key
            ]
            if kept:
                self.nominated[nn] = kept
            elif nn in self.nominated:
                del self.nominated[nn]

    def forget(self, pod: Obj, node_name: str) -> None:
        ni = self._by_name.get(node_name)
        if ni is not None:
            ni.remove_pod(pod)
        # an assumed-then-forgotten pod (Permit reject, bind failure) gets
        # its nomination reservation back — assume() had dropped it
        if has_pending_nomination(pod):
            nn = pod["status"]["nominatedNodeName"]
            lst = self.nominated.setdefault(nn, [])
            me = (pod["metadata"].get("namespace", "default"), pod["metadata"]["name"])
            if all(
                (q["metadata"].get("namespace", "default"), q["metadata"]["name"]) != me
                for q in lst
            ):
                lst.append(pod)
