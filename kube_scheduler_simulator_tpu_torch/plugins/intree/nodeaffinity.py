"""NodeAffinity: failure reasons and the PreFilter node-name narrowing
(upstream v1.26)."""

from __future__ import annotations

from typing import Any

Obj = dict[str, Any]

ERR_REASON_POD = "node(s) didn't match Pod's node affinity/selector"
ERR_REASON_ENFORCED = "node(s) didn't match scheduler-enforced node affinity"


def pre_filter_node_names(pod: Obj) -> "set[str] | None":
    """The explicit node names PreFilter narrows to when every required
    term pins metadata.name via matchFields In; None = all nodes."""
    required = (
        ((pod.get("spec") or {}).get("affinity") or {}).get("nodeAffinity") or {}
    ).get("requiredDuringSchedulingIgnoredDuringExecution")
    if not required:
        return None
    node_names: set[str] = set()
    for term in required.get("nodeSelectorTerms") or []:
        term_names: "set[str] | None" = None
        for f in term.get("matchFields") or []:
            if f.get("key") == "metadata.name" and f.get("operator") == "In":
                vals = set(f.get("values") or [])
                term_names = vals if term_names is None else term_names & vals
        if term_names is None:
            # A term without a metadata.name pin can match any node.
            return None
        node_names |= term_names
    return node_names
