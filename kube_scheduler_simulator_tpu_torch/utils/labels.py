"""Label-selector / node-selector / taint-toleration matching.

Host-side string matching used by the feature encoder: all selector
semantics are evaluated here (on CPU, incrementally) and lowered to boolean
matrices before anything touches the device.  Semantics follow
k8s.io/apimachinery labels.Selector and the scheduler's nodeaffinity/
taint helpers, which the reference uses via the upstream plugin
implementations (reference simulator/scheduler/plugin/wrappedplugin.go
delegates to the originals).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

Obj = Mapping[str, Any]


def match_match_labels(match_labels: Mapping[str, str], labels: Mapping[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in match_labels.items())


def _match_expression(expr: Obj, labels: Mapping[str, str]) -> bool:
    key = expr.get("key", "")
    op = expr.get("operator", "")
    values = expr.get("values") or []
    present = key in labels
    val = labels.get(key)
    if op == "In":
        return present and val in values
    if op == "NotIn":
        # apimachinery labels.Requirement.Matches: NotIn matches when the
        # key is absent.
        return (not present) or val not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    if op == "Gt" or op == "Lt":
        if not present or len(values) != 1:
            return False
        try:
            lhs = int(val)  # type: ignore[arg-type]
            rhs = int(values[0])
        except (TypeError, ValueError):
            return False
        return lhs > rhs if op == "Gt" else lhs < rhs
    return False


def match_label_selector(selector: "Obj | None", labels: Mapping[str, str]) -> bool:
    """metav1.LabelSelector: AND of matchLabels and matchExpressions.

    A nil selector matches nothing; an empty selector matches everything
    (apimachinery LabelSelectorAsSelector semantics).
    """
    if selector is None:
        return False
    if not match_match_labels(selector.get("matchLabels") or {}, labels):
        return False
    return all(_match_expression(e, labels) for e in selector.get("matchExpressions") or [])


def match_node_selector_term(term: Obj, node_labels: Mapping[str, str], node_name: str) -> bool:
    """v1.NodeSelectorTerm: AND of matchExpressions (labels) and matchFields.

    An empty/nil term matches no objects (upstream nodeaffinity.go).
    """
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    if not exprs and not fields:
        return False
    if not all(_match_expression(e, node_labels) for e in exprs):
        return False
    return all(_match_expression(f, {"metadata.name": node_name}) for f in fields)


def match_node_selector(node_selector: "Obj | None", node_labels: Mapping[str, str], node_name: str) -> bool:
    """v1.NodeSelector: OR over nodeSelectorTerms."""
    if node_selector is None:
        return True
    terms = node_selector.get("nodeSelectorTerms") or []
    return any(match_node_selector_term(t, node_labels, node_name) for t in terms)


def toleration_tolerates_taint(tol: Obj, taint: Obj) -> bool:
    """v1.Toleration.ToleratesTaint."""
    if tol.get("effect") and tol.get("effect") != taint.get("effect"):
        return False
    if tol.get("key") and tol.get("key") != taint.get("key"):
        return False
    op = tol.get("operator") or "Equal"
    if op == "Exists":
        return True
    if op == "Equal":
        return (tol.get("value") or "") == (taint.get("value") or "")
    return False


def tolerations_tolerate_taint(tolerations: Sequence[Obj], taint: Obj) -> bool:
    return any(toleration_tolerates_taint(t, taint) for t in tolerations)


def find_untolerated_taint(
    taints: Sequence[Obj],
    tolerations: Sequence[Obj],
    effects: Sequence[str] = ("NoSchedule", "NoExecute"),
) -> "Obj | None":
    """First taint with one of ``effects`` that no toleration tolerates."""
    for taint in taints:
        if taint.get("effect") not in effects:
            continue
        if not tolerations_tolerate_taint(tolerations, taint):
            return taint
    return None
