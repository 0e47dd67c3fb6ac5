"""InterPodAffinity plugin (upstream v1.26).

Filter:
- existing pods' required anti-affinity terms matching the incoming pod
  poison their (topologyKey, value) domains;
- the incoming pod's required affinity terms must each find a matching pod
  in the candidate node's domain (with the self-match escape hatch when no
  pod matches anywhere);
- the incoming pod's required anti-affinity terms must find none.

Score: preferred terms of the incoming pod (weight per matching existing
pod in-domain), existing pods' preferred terms toward the incoming pod,
and existing pods' *required* affinity terms weighted by
hardPodAffinityWeight (default 1); min-max normalized to [0,100].
Vectorized twin: ops/interpod.py (pairwise [P,P] match matrices contracted
against placement on the MXU).
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import MAX_NODE_SCORE, CycleState, Status
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo
from kube_scheduler_simulator_tpu_torch.plugins.intree.helpers import affinity_term_matches_pod

Obj = dict[str, Any]

ERR_EXISTING_ANTI = "node(s) didn't satisfy existing pods' anti-affinity rules"
ERR_AFFINITY = "node(s) didn't match pod affinity rules"
ERR_ANTI_AFFINITY = "node(s) didn't match pod anti-affinity rules"

DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1


def _pod_affinity(pod: Obj) -> Obj:
    return ((pod.get("spec") or {}).get("affinity") or {}).get("podAffinity") or {}


def _pod_anti_affinity(pod: Obj) -> Obj:
    return ((pod.get("spec") or {}).get("affinity") or {}).get("podAntiAffinity") or {}


def required_affinity_terms(pod: Obj) -> list[Obj]:
    return _pod_affinity(pod).get("requiredDuringSchedulingIgnoredDuringExecution") or []


def required_anti_affinity_terms(pod: Obj) -> list[Obj]:
    return _pod_anti_affinity(pod).get("requiredDuringSchedulingIgnoredDuringExecution") or []


def preferred_affinity_terms(pod: Obj) -> list[Obj]:
    return _pod_affinity(pod).get("preferredDuringSchedulingIgnoredDuringExecution") or []


def preferred_anti_affinity_terms(pod: Obj) -> list[Obj]:
    return _pod_anti_affinity(pod).get("preferredDuringSchedulingIgnoredDuringExecution") or []


class InterPodAffinity:
    name = "InterPodAffinity"

    PRE_FILTER_KEY = "PreFilterInterPodAffinity"
    PRE_SCORE_KEY = "PreScoreInterPodAffinity"

    def __init__(self, args: "Obj | None" = None, handle: Any = None):
        args = args or {}
        self.hard_pod_affinity_weight = int(
            args.get("hardPodAffinityWeight") or DEFAULT_HARD_POD_AFFINITY_WEIGHT
        )
        self.handle = handle

    def _snapshot(self):
        return self.handle.snapshot() if self.handle is not None else None

    def _ns_labels(self):
        snap = self._snapshot()
        return snap.namespace_labels if snap is not None else {}

    # ------------------------------------------------------------ pre-filter

    def pre_filter(self, state: CycleState, pod: Obj):
        snap = self._snapshot()
        node_infos = snap.node_infos if snap is not None else []
        ns_labels = self._ns_labels()
        incoming_ns = pod["metadata"].get("namespace", "default")

        existing_anti: dict[tuple[str, str], int] = {}
        for ni in (snap.have_pods_with_required_anti_affinity() if snap is not None else []):
            labels = ni.node["metadata"].get("labels") or {}
            for existing in ni.pods:
                for term in required_anti_affinity_terms(existing):
                    key = term.get("topologyKey", "")
                    if key not in labels:
                        continue
                    if affinity_term_matches_pod(
                        term, existing["metadata"].get("namespace", "default"), pod, ns_labels
                    ):
                        pair = (key, labels[key])
                        existing_anti[pair] = existing_anti.get(pair, 0) + 1

        affinity_counts: dict[tuple[str, str], int] = {}
        anti_affinity_counts: dict[tuple[str, str], int] = {}
        aff_terms = required_affinity_terms(pod)
        anti_terms = required_anti_affinity_terms(pod)
        if aff_terms or anti_terms:
            for ni in node_infos:
                labels = ni.node["metadata"].get("labels") or {}
                for existing in ni.pods:
                    for term in aff_terms:
                        key = term.get("topologyKey", "")
                        if key in labels and affinity_term_matches_pod(term, incoming_ns, existing, ns_labels):
                            pair = (key, labels[key])
                            affinity_counts[pair] = affinity_counts.get(pair, 0) + 1
                    for term in anti_terms:
                        key = term.get("topologyKey", "")
                        if key in labels and affinity_term_matches_pod(term, incoming_ns, existing, ns_labels):
                            pair = (key, labels[key])
                            anti_affinity_counts[pair] = anti_affinity_counts.get(pair, 0) + 1

        state.write(
            self.PRE_FILTER_KEY,
            {"existing_anti": existing_anti, "affinity": affinity_counts, "anti": anti_affinity_counts},
        )
        return None, None

    def add_pod_to_state(self, state: CycleState, pod: Obj, pod_to_add: Obj, node_info: NodeInfo) -> None:
        """upstream PreFilterExtensions.AddPod: account ``pod_to_add`` (a
        nominated pod assumed onto ``node_info``) into the precomputed
        pair counts on a CLONED cycle state (copy-on-write)."""
        st = state.read(self.PRE_FILTER_KEY)
        if st is None:
            return
        ns_labels = self._ns_labels()
        labels = node_info.node["metadata"].get("labels") or {}
        new = {
            "existing_anti": dict(st["existing_anti"]),
            "affinity": dict(st["affinity"]),
            "anti": dict(st["anti"]),
        }
        add_ns = pod_to_add["metadata"].get("namespace", "default")
        for term in required_anti_affinity_terms(pod_to_add):
            key = term.get("topologyKey", "")
            if key in labels and affinity_term_matches_pod(term, add_ns, pod, ns_labels):
                pair = (key, labels[key])
                new["existing_anti"][pair] = new["existing_anti"].get(pair, 0) + 1
        incoming_ns = pod["metadata"].get("namespace", "default")
        for dest, terms in (
            ("affinity", required_affinity_terms(pod)),
            ("anti", required_anti_affinity_terms(pod)),
        ):
            for term in terms:
                key = term.get("topologyKey", "")
                if key in labels and affinity_term_matches_pod(term, incoming_ns, pod_to_add, ns_labels):
                    pair = (key, labels[key])
                    new[dest][pair] = new[dest].get(pair, 0) + 1
        state.write(self.PRE_FILTER_KEY, new)

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        st = state.read(self.PRE_FILTER_KEY)
        if st is None:
            return None
        labels = node_info.node["metadata"].get("labels") or {}

        for (key, val), cnt in st["existing_anti"].items():
            if cnt > 0 and labels.get(key) == val:
                return Status.unschedulable(ERR_EXISTING_ANTI)

        aff_terms = required_affinity_terms(pod)
        if aff_terms:
            satisfied = True
            for term in aff_terms:
                key = term.get("topologyKey", "")
                if key not in labels or st["affinity"].get((key, labels[key]), 0) <= 0:
                    satisfied = False
                    break
            if not satisfied:
                # Self-match escape hatch: no pod matches anywhere AND the
                # incoming pod matches its own affinity terms.
                incoming_ns = pod["metadata"].get("namespace", "default")
                if not (
                    not st["affinity"]
                    and all(
                        affinity_term_matches_pod(t, incoming_ns, pod, self._ns_labels())
                        for t in aff_terms
                    )
                ):
                    return Status.unschedulable(ERR_AFFINITY)

        for term in required_anti_affinity_terms(pod):
            key = term.get("topologyKey", "")
            if key in labels and st["anti"].get((key, labels[key]), 0) > 0:
                return Status.unschedulable(ERR_ANTI_AFFINITY)
        return None

    # ------------------------------------------------------------- pre-score

    def pre_score(self, state: CycleState, pod: Obj, nodes: list[Obj]) -> "Status | None":
        snap = self._snapshot()
        if snap is None:
            state.write(self.PRE_SCORE_KEY, {})
            return None
        ns_labels = self._ns_labels()
        incoming_ns = pod["metadata"].get("namespace", "default")
        pref_aff = preferred_affinity_terms(pod)
        pref_anti = preferred_anti_affinity_terms(pod)
        has_constraints = bool(pref_aff or pref_anti)

        topo_score: dict[tuple[str, str], int] = {}
        node_infos = snap.node_infos if has_constraints else snap.have_pods_with_affinity()
        for ni in node_infos:
            labels = ni.node["metadata"].get("labels") or {}
            for existing in ni.pods:
                existing_ns = existing["metadata"].get("namespace", "default")
                # Incoming pod's preferred terms vs this existing pod.
                for p in pref_aff:
                    term = p.get("podAffinityTerm") or {}
                    key = term.get("topologyKey", "")
                    w = int(p.get("weight") or 0)
                    if w and key in labels and affinity_term_matches_pod(term, incoming_ns, existing, ns_labels):
                        pair = (key, labels[key])
                        topo_score[pair] = topo_score.get(pair, 0) + w
                for p in pref_anti:
                    term = p.get("podAffinityTerm") or {}
                    key = term.get("topologyKey", "")
                    w = int(p.get("weight") or 0)
                    if w and key in labels and affinity_term_matches_pod(term, incoming_ns, existing, ns_labels):
                        pair = (key, labels[key])
                        topo_score[pair] = topo_score.get(pair, 0) - w
                # Existing pod's required affinity toward the incoming pod
                # (weighted by hardPodAffinityWeight).
                if self.hard_pod_affinity_weight > 0:
                    for term in required_affinity_terms(existing):
                        key = term.get("topologyKey", "")
                        if key in labels and affinity_term_matches_pod(term, existing_ns, pod, ns_labels):
                            pair = (key, labels[key])
                            topo_score[pair] = topo_score.get(pair, 0) + self.hard_pod_affinity_weight
                # Existing pod's preferred terms toward the incoming pod.
                for p in preferred_affinity_terms(existing):
                    term = p.get("podAffinityTerm") or {}
                    key = term.get("topologyKey", "")
                    w = int(p.get("weight") or 0)
                    if w and key in labels and affinity_term_matches_pod(term, existing_ns, pod, ns_labels):
                        pair = (key, labels[key])
                        topo_score[pair] = topo_score.get(pair, 0) + w
                for p in preferred_anti_affinity_terms(existing):
                    term = p.get("podAffinityTerm") or {}
                    key = term.get("topologyKey", "")
                    w = int(p.get("weight") or 0)
                    if w and key in labels and affinity_term_matches_pod(term, existing_ns, pod, ns_labels):
                        pair = (key, labels[key])
                        topo_score[pair] = topo_score.get(pair, 0) - w
        state.write(self.PRE_SCORE_KEY, topo_score)
        return None

    def score(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "tuple[int, Status | None]":
        topo_score = state.read(self.PRE_SCORE_KEY) or {}
        labels = node_info.node["metadata"].get("labels") or {}
        total = 0
        for (key, val), w in topo_score.items():
            if labels.get(key) == val:
                total += w
        return total, None

    def normalize_scores(self, state: CycleState, pod: Obj, scores: dict[str, int]) -> "Status | None":
        if not scores:
            return None
        min_count = min(scores.values())
        max_count = max(scores.values())
        diff = max_count - min_count
        for k, v in scores.items():
            if diff > 0:
                scores[k] = int(MAX_NODE_SCORE * ((v - min_count) / diff))
            else:
                scores[k] = 0
        return None
