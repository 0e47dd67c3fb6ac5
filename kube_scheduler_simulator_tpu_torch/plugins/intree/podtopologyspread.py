"""PodTopologySpread plugin (upstream v1.26).

Filter: DoNotSchedule constraints — skew(candidate) = matchNum + self - min
must not exceed maxSkew; nodes missing the topology key fail with the
"(missing required label)" variant.  Nodes counted honor the incoming pod's
nodeSelector/affinity (NodeInclusionPolicy Honor default).

Score: ScheduleAnyway constraints — per-domain match counts weighted by
log(#domains + 2), flipped in NormalizeScore via
``MaxNodeScore * (max + min - s) / max``.

System defaults (zone maxSkew 3 / hostname maxSkew 5, ScheduleAnyway) build
their selector from owning services — the simulator's store has no Services
(the reference manages the same 7 kinds, SURVEY.md section 2.1 #13), so the
system-defaulted score path contributes 0, exactly as the Go scheduler
behaves with no matching services.  Vectorized twin: ops/spread.py.
"""

from __future__ import annotations

import math
from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import MAX_NODE_SCORE, CycleState, Status
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo
from kube_scheduler_simulator_tpu_torch.utils.labels import match_label_selector, match_node_selector

Obj = dict[str, Any]

ERR_REASON = "node(s) didn't match pod topology spread constraints"
ERR_REASON_LABEL = ERR_REASON + " (missing required label)"


def _constraints(pod: Obj, when: str) -> list[Obj]:
    out = []
    for c in (pod.get("spec") or {}).get("topologySpreadConstraints") or []:
        if c.get("whenUnsatisfiable") == when:
            out.append(c)
    return out


def _node_passes_inclusion(pod: Obj, node: Obj) -> bool:
    """NodeInclusionPolicy default: Honor nodeAffinity/nodeSelector,
    Ignore nodeTaints — only nodes the pod could land on are counted."""
    labels = node["metadata"].get("labels") or {}
    name = node["metadata"]["name"]
    node_selector = (pod.get("spec") or {}).get("nodeSelector")
    if node_selector:
        for k, v in node_selector.items():
            if labels.get(k) != v:
                return False
    required = (((pod.get("spec") or {}).get("affinity") or {}).get("nodeAffinity") or {}).get(
        "requiredDuringSchedulingIgnoredDuringExecution"
    )
    if required is not None and not match_node_selector(required, labels, name):
        return False
    return True


def _count_matching(pods: list[Obj], selector: "Obj | None", namespace: str) -> int:
    n = 0
    for p in pods:
        if p["metadata"].get("namespace", "default") != namespace:
            continue
        if p["metadata"].get("deletionTimestamp"):
            continue
        if match_label_selector(selector, p["metadata"].get("labels") or {}):
            n += 1
    return n


class PodTopologySpread:
    name = "PodTopologySpread"

    PRE_FILTER_KEY = "PreFilterPodTopologySpread"
    PRE_SCORE_KEY = "PreScorePodTopologySpread"

    def __init__(self, args: "Obj | None" = None, handle: Any = None):
        self.handle = handle
        args = args or {}
        self.defaulting_type = args.get("defaultingType") or "System"
        self.default_constraints = args.get("defaultConstraints") or []

    def _snapshot_nodes(self) -> list[NodeInfo]:
        if self.handle is None:
            return []
        return self.handle.snapshot().node_infos

    # ------------------------------------------------------------ pre-filter

    def pre_filter(self, state: CycleState, pod: Obj):
        constraints = _constraints(pod, "DoNotSchedule")
        if not constraints and self.defaulting_type == "List":
            constraints = [c for c in self.default_constraints if c.get("whenUnsatisfiable") == "DoNotSchedule"]
        ns = pod["metadata"].get("namespace", "default")
        counts: dict[tuple[str, str], int] = {}
        min_match: dict[int, int] = {}
        if constraints:
            all_nodes = self._snapshot_nodes()
            for i, c in enumerate(constraints):
                key = c["topologyKey"]
                domain_counts: dict[str, int] = {}
                for ni in all_nodes:
                    labels = ni.node["metadata"].get("labels") or {}
                    if key not in labels:
                        continue
                    if not _node_passes_inclusion(pod, ni.node):
                        continue
                    val = labels[key]
                    domain_counts[val] = domain_counts.get(val, 0) + _count_matching(
                        ni.pods, c.get("labelSelector"), ns
                    )
                for val, cnt in domain_counts.items():
                    counts[(key, val)] = counts.get((key, val), 0) + cnt
                min_match[i] = min(domain_counts.values()) if domain_counts else 0
        state.write(self.PRE_FILTER_KEY, {"constraints": constraints, "counts": counts, "min": min_match})
        return None, None

    def add_pod_to_state(self, state: CycleState, pod: Obj, pod_to_add: Obj, node_info: NodeInfo) -> None:
        """upstream PreFilterExtensions.AddPod on a cloned state: bump the
        matching pair counts for a nominated pod assumed onto the node.
        The per-constraint min stays as computed at PreFilter — adding a
        pod can only raise a domain's count, so keeping the old min is
        conservative (upstream's critical-path approximation behaves the
        same way for the non-critical domains)."""
        st = state.read(self.PRE_FILTER_KEY)
        if not st or not st["constraints"]:
            return
        if not _node_passes_inclusion(pod, node_info.node):
            return
        labels = node_info.node["metadata"].get("labels") or {}
        add_ns = pod_to_add["metadata"].get("namespace", "default")
        ns = pod["metadata"].get("namespace", "default")
        counts = dict(st["counts"])
        for c in st["constraints"]:
            key = c["topologyKey"]
            if key not in labels:
                continue
            if add_ns == ns and match_label_selector(
                c.get("labelSelector"), pod_to_add["metadata"].get("labels") or {}
            ):
                pair = (key, labels[key])
                counts[pair] = counts.get(pair, 0) + 1
        state.write(self.PRE_FILTER_KEY, {"constraints": st["constraints"], "counts": counts, "min": st["min"]})

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        st = state.read(self.PRE_FILTER_KEY)
        if not st or not st["constraints"]:
            return None
        labels = node_info.node["metadata"].get("labels") or {}
        pod_labels = pod["metadata"].get("labels") or {}
        for i, c in enumerate(st["constraints"]):
            key = c["topologyKey"]
            if key not in labels:
                return Status.unresolvable(ERR_REASON_LABEL)
            self_match = 1 if match_label_selector(c.get("labelSelector"), pod_labels) else 0
            match_num = st["counts"].get((key, labels[key]), 0)
            skew = match_num + self_match - st["min"][i]
            if skew > int(c.get("maxSkew") or 1):
                return Status.unschedulable(ERR_REASON)
        return None

    # ------------------------------------------------------------- pre-score

    def pre_score(self, state: CycleState, pod: Obj, nodes: list[Obj]) -> "Status | None":
        constraints = _constraints(pod, "ScheduleAnyway")
        system_defaulted = False
        if not (pod.get("spec") or {}).get("topologySpreadConstraints"):
            if self.defaulting_type == "List":
                constraints = [c for c in self.default_constraints if c.get("whenUnsatisfiable") == "ScheduleAnyway"]
            else:
                # System defaulting needs owning Services to build a selector;
                # the simulator tracks no Services, so no default constraints
                # materialize (matches Go behavior with no services).
                constraints = []
                system_defaulted = True
        if not constraints:
            state.write(self.PRE_SCORE_KEY, None)
            return None
        require_all_topologies = bool((pod.get("spec") or {}).get("topologySpreadConstraints")) or not system_defaulted
        ns = pod["metadata"].get("namespace", "default")
        all_nodes = self._snapshot_nodes()
        ignored: set[str] = set()
        filtered_names = {n["metadata"]["name"] for n in nodes}
        topo_sizes = [set() for _ in constraints]
        for n in nodes:
            labels = n["metadata"].get("labels") or {}
            if require_all_topologies and any(c["topologyKey"] not in labels for c in constraints):
                ignored.add(n["metadata"]["name"])
                continue
            for i, c in enumerate(constraints):
                if c["topologyKey"] in labels:
                    topo_sizes[i].add(labels[c["topologyKey"]])
        counts: dict[tuple[str, str], int] = {}
        for ni in all_nodes:
            labels = ni.node["metadata"].get("labels") or {}
            if require_all_topologies and any(c["topologyKey"] not in labels for c in constraints):
                continue
            for c in constraints:
                key = c["topologyKey"]
                if key == "kubernetes.io/hostname":
                    continue  # counted per-node at Score time
                if key not in labels:
                    continue
                pair = (key, labels[key])
                counts[pair] = counts.get(pair, 0) + _count_matching(ni.pods, c.get("labelSelector"), ns)
        weights = [math.log(len(topo_sizes[i]) + 2) for i in range(len(constraints))]
        state.write(
            self.PRE_SCORE_KEY,
            {
                "constraints": constraints,
                "counts": counts,
                "weights": weights,
                "ignored": ignored,
                "filtered": filtered_names,
            },
        )
        return None

    def score(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "tuple[int, Status | None]":
        st = state.read(self.PRE_SCORE_KEY)
        if not st:
            return 0, None
        name = node_info.name
        if name in st["ignored"]:
            return 0, None
        labels = node_info.node["metadata"].get("labels") or {}
        ns = pod["metadata"].get("namespace", "default")
        score = 0.0
        for i, c in enumerate(st["constraints"]):
            key = c["topologyKey"]
            if key not in labels:
                continue
            if key == "kubernetes.io/hostname":
                cnt = _count_matching(node_info.pods, c.get("labelSelector"), ns)
            else:
                cnt = st["counts"].get((key, labels[key]), 0)
            score += cnt * st["weights"][i] + (int(c.get("maxSkew") or 1) - 1)
        return int(round(score)), None

    def normalize_scores(self, state: CycleState, pod: Obj, scores: dict[str, int]) -> "Status | None":
        st = state.read(self.PRE_SCORE_KEY)
        if not st:
            return None
        considered = [v for k, v in scores.items() if k not in st["ignored"]]
        if not considered:
            return None
        min_score = min(considered)
        max_score = max(considered)
        for k, v in scores.items():
            if k in st["ignored"]:
                scores[k] = 0
                continue
            if max_score == 0:
                scores[k] = MAX_NODE_SCORE
                continue
            scores[k] = MAX_NODE_SCORE * (max_score + min_score - v) // max_score
        return None
