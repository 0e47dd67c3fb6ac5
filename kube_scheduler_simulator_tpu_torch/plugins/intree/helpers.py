"""Shared helpers for in-tree plugins (upstream v1.26 semantics)."""

from __future__ import annotations

from typing import Any, Mapping

from kube_scheduler_simulator_tpu_torch.models.framework import MAX_NODE_SCORE
from kube_scheduler_simulator_tpu_torch.utils.labels import match_label_selector

Obj = dict[str, Any]


def default_normalize_score(scores: dict[str, int], reverse: bool) -> None:
    """helper.DefaultNormalizeScore: scale to [0, MaxNodeScore] by max,
    optionally reversed.  Integer (int64) division, like upstream."""
    if not scores:
        return
    max_count = max(scores.values())
    if max_count == 0:
        if reverse:
            for k in scores:
                scores[k] = MAX_NODE_SCORE
        return
    for k, v in scores.items():
        s = v * MAX_NODE_SCORE // max_count
        scores[k] = MAX_NODE_SCORE - s if reverse else s


def affinity_term_matches_pod(
    term: Obj,
    incoming_pod_namespace: str,
    target_pod: Obj,
    namespace_labels: "Mapping[str, Mapping[str, str]] | None" = None,
) -> bool:
    """Does a (anti)affinity term select ``target_pod``?

    Namespace resolution per upstream: explicit ``namespaces`` list, else the
    incoming pod's own namespace; ``namespaceSelector`` (non-nil) widens the
    set using namespace labels.
    """
    target_ns = target_pod["metadata"].get("namespace", "default")
    namespaces = term.get("namespaces") or []
    ns_selector = term.get("namespaceSelector")
    ns_match = False
    if namespaces:
        ns_match = target_ns in namespaces
    if not ns_match and ns_selector is not None:
        # Empty selector matches all namespaces; non-empty consults labels.
        labels = (namespace_labels or {}).get(target_ns, {})
        ns_match = match_label_selector(ns_selector, labels)
    if not ns_match and not namespaces and ns_selector is None:
        ns_match = target_ns == incoming_pod_namespace
    if not ns_match:
        return False
    return match_label_selector(term.get("labelSelector"), target_pod["metadata"].get("labels") or {})
