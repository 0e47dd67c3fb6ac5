"""NodeAffinity plugin (upstream v1.26).

Filter: pod.spec.nodeSelector (all labels must match) AND
requiredDuringSchedulingIgnoredDuringExecution (OR over terms).
PreFilter: narrows to explicit node names when every term pins
metadata.name via matchFields In.
Score: sum of matched preferredDuringScheduling term weights,
default-normalized.  Vectorized twin: ops/affinity.py.
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import CycleState, PreFilterResult, Status
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo
from kube_scheduler_simulator_tpu_torch.plugins.intree.helpers import default_normalize_score
from kube_scheduler_simulator_tpu_torch.utils.labels import (
    match_node_selector,
    match_node_selector_term,
)

Obj = dict[str, Any]

ERR_REASON_POD = "node(s) didn't match Pod's node affinity/selector"
ERR_REASON_ENFORCED = "node(s) didn't match scheduler-enforced node affinity"


def _affinity(pod: Obj) -> Obj:
    return ((pod.get("spec") or {}).get("affinity") or {}).get("nodeAffinity") or {}


def _required(pod: Obj) -> "Obj | None":
    return _affinity(pod).get("requiredDuringSchedulingIgnoredDuringExecution")


def _preferred(pod: Obj) -> list[Obj]:
    return _affinity(pod).get("preferredDuringSchedulingIgnoredDuringExecution") or []


class NodeAffinity:
    name = "NodeAffinity"

    PRE_SCORE_KEY = "PreScoreNodeAffinity"

    def __init__(self, args: "Obj | None" = None):
        args = args or {}
        self.added_affinity = (args.get("addedAffinity") or {}).get(
            "requiredDuringSchedulingIgnoredDuringExecution"
        )

    def pre_filter(self, state: CycleState, pod: Obj):
        required = _required(pod)
        if not required:
            return None, None
        node_names: set[str] = set()
        for term in required.get("nodeSelectorTerms") or []:
            term_names: "set[str] | None" = None
            for f in term.get("matchFields") or []:
                if f.get("key") == "metadata.name" and f.get("operator") == "In":
                    vals = set(f.get("values") or [])
                    term_names = vals if term_names is None else term_names & vals
            if term_names is None:
                # A term without a metadata.name pin can match any node.
                return None, None
            node_names |= term_names
        return PreFilterResult(node_names), None

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        node = node_info.node
        labels = node["metadata"].get("labels") or {}
        name = node_info.name
        if self.added_affinity is not None and not match_node_selector(self.added_affinity, labels, name):
            return Status.unresolvable(ERR_REASON_ENFORCED)
        node_selector = (pod.get("spec") or {}).get("nodeSelector")
        if node_selector:
            for k, v in node_selector.items():
                if labels.get(k) != v:
                    return Status.unresolvable(ERR_REASON_POD)
        required = _required(pod)
        if required is not None and not match_node_selector(required, labels, name):
            return Status.unresolvable(ERR_REASON_POD)
        return None

    def pre_score(self, state: CycleState, pod: Obj, nodes: list[Obj]) -> "Status | None":
        state.write(self.PRE_SCORE_KEY, _preferred(pod))
        return None

    def score(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "tuple[int, Status | None]":
        preferred = state.read(self.PRE_SCORE_KEY)
        if preferred is None:
            preferred = _preferred(pod)
        labels = node_info.node["metadata"].get("labels") or {}
        total = 0
        for p in preferred:
            weight = int(p.get("weight") or 0)
            if weight == 0:
                continue
            term = p.get("preference") or {}
            if match_node_selector_term(term, labels, node_info.name):
                total += weight
        return total, None

    def normalize_scores(self, state: CycleState, pod: Obj, scores: dict[str, int]) -> "Status | None":
        default_normalize_score(scores, reverse=False)
        return None
