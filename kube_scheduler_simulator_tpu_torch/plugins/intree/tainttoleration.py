"""TaintToleration plugin (upstream v1.26).

Filter: first NoSchedule/NoExecute taint not tolerated fails the node with
the exact upstream message ``node(s) had untolerated taint {key: value}``.
Score: count of PreferNoSchedule taints not tolerated by the pod's
PreferNoSchedule-effect-compatible tolerations, normalized reversed.
Vectorized twin: ops/taints.py (host pre-matches strings into matrices).
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import CycleState, Status
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo
from kube_scheduler_simulator_tpu_torch.plugins.intree.helpers import default_normalize_score
from kube_scheduler_simulator_tpu_torch.utils.labels import (
    find_untolerated_taint,
    tolerations_tolerate_taint,
)

Obj = dict[str, Any]


def node_taints(node: Obj) -> list[Obj]:
    return (node.get("spec") or {}).get("taints") or []


def pod_tolerations(pod: Obj) -> list[Obj]:
    return (pod.get("spec") or {}).get("tolerations") or []


class TaintToleration:
    name = "TaintToleration"

    PRE_SCORE_KEY = "PreScoreTaintToleration"

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        taint = find_untolerated_taint(node_taints(node_info.node), pod_tolerations(pod))
        if taint is None:
            return None
        return Status.unresolvable(
            f"node(s) had untolerated taint {{{taint.get('key', '')}: {taint.get('value', '')}}}"
        )

    def pre_score(self, state: CycleState, pod: Obj, nodes: list[Obj]) -> "Status | None":
        # Keep only tolerations that could tolerate a PreferNoSchedule taint
        # (upstream getAllTolerationPreferNoSchedule: effect empty or
        # PreferNoSchedule).
        tolerations = [
            t for t in pod_tolerations(pod) if not t.get("effect") or t.get("effect") == "PreferNoSchedule"
        ]
        state.write(self.PRE_SCORE_KEY, tolerations)
        return None

    def score(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "tuple[int, Status | None]":
        tolerations = state.read(self.PRE_SCORE_KEY)
        if tolerations is None:
            tolerations = []
        count = 0
        for taint in node_taints(node_info.node):
            if taint.get("effect") == "PreferNoSchedule" and not tolerations_tolerate_taint(tolerations, taint):
                count += 1
        return count, None

    def normalize_scores(self, state: CycleState, pod: Obj, scores: dict[str, int]) -> "Status | None":
        default_normalize_score(scores, reverse=True)
        return None
