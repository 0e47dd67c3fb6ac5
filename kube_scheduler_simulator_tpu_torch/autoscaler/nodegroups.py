"""NodeGroup objects: the capacity engine's declared node supply.

A NodeGroup is the simulator analog of a cluster-autoscaler cloud-provider
node group (an ASG / MIG / node pool): a node *template* plus [minSize,
maxSize] bounds.  The autoscaler materializes synthetic Node objects from
the template on scale-up and drains them on scale-down; every node a group
owns carries the ``scheduler-simulator/nodegroup`` label, which is also
how current group size is computed (the store itself is the source of
truth — no shadow counters to drift).

Port of the JAX package's ``autoscaler/nodegroups.py``, copied whole.

Wire shape (store kind ``nodegroups``, cluster-scoped):

    metadata:
      name: pool-a
    spec:
      minSize: 0
      maxSize: 10
      priority: 5            # only the "priority" expander reads it
      template:              # a Node object body (metadata.labels/spec/status)
        metadata:
          labels: {...}
        status:
          allocatable: {cpu: "8", memory: 32Gi, pods: "110"}

Determinism rules (docs/autoscaler.md): synthetic node names are
``{group}-{index}`` with the lowest free indices, so the same cluster
state always materializes the same names — scenario replay depends on it.
"""

from __future__ import annotations

import re
from typing import Any

Obj = dict[str, Any]

# Label stamped on every node a group owns (template labels may not
# override it).  The prefix matches the simulator's annotation namespace.
NODE_GROUP_LABEL = "scheduler-simulator/nodegroup"

_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9.]*[a-z0-9])?$")


def validate_node_group(obj: Obj) -> None:
    """Admission for NodeGroup objects; raises ValueError on bad specs."""
    name = ((obj.get("metadata") or {}).get("name")) or ""
    if not name or not _NAME_RE.match(name):
        raise ValueError(f"nodegroup needs a DNS-ish metadata.name, got {name!r}")
    spec = obj.get("spec") or {}
    try:
        mn = int(spec.get("minSize", 0))
        mx = int(spec.get("maxSize", 0))
    except (TypeError, ValueError):
        raise ValueError(f"nodegroup {name}: minSize/maxSize must be integers") from None
    if mn < 0 or mx < mn:
        raise ValueError(f"nodegroup {name}: need 0 <= minSize <= maxSize, got [{mn}, {mx}]")
    template = spec.get("template") or {}
    alloc = ((template.get("status") or {}).get("allocatable")) or {}
    if not alloc:
        raise ValueError(f"nodegroup {name}: spec.template.status.allocatable is required")
    # every quantity must PARSE — an unparseable template would otherwise
    # crash the estimator on every later pass instead of this create
    from kube_scheduler_simulator_tpu_torch.utils.quantity import parse_quantity

    for res, q in alloc.items():
        try:
            parse_quantity(q)
        except Exception:
            raise ValueError(
                f"nodegroup {name}: allocatable.{res} is not a quantity: {q!r}"
            ) from None
    if "priority" in spec:
        try:
            int(spec["priority"])
        except (TypeError, ValueError):
            raise ValueError(f"nodegroup {name}: priority must be an integer") from None


def group_bounds(group: Obj) -> "tuple[int, int]":
    spec = group.get("spec") or {}
    return int(spec.get("minSize", 0)), int(spec.get("maxSize", 0))


def group_nodes(store: Any, group_name: str) -> list[Obj]:
    """The nodes this group currently owns (label match, name order)."""
    return [
        n
        for n in store.list("nodes", copy_objects=False)
        if (n["metadata"].get("labels") or {}).get(NODE_GROUP_LABEL) == group_name
    ]


def _used_indices(nodes: list[Obj], group_name: str) -> set[int]:
    out: set[int] = set()
    prefix = f"{group_name}-"
    for n in nodes:
        name = n["metadata"]["name"]
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            out.add(int(name[len(prefix):]))
    return out


def free_indices(store: Any, group_name: str, count: int) -> list[int]:
    """The ``count`` lowest indices not currently materialized — the
    deterministic name allocator (same cluster state → same names)."""
    used = _used_indices(group_nodes(store, group_name), group_name)
    out: list[int] = []
    i = 0
    while len(out) < count:
        if i not in used:
            out.append(i)
        i += 1
    return out


def synthetic_node(group: Obj, index: int) -> Obj:
    """Materialize one Node from the group's template.

    The node gets the group label plus a ``kubernetes.io/hostname`` label
    when the template didn't set one (hostname-keyed topology spreading
    must see distinct domains per synthetic node, exactly as kubelets
    self-label real nodes)."""
    group_name = group["metadata"]["name"]
    template = (group.get("spec") or {}).get("template") or {}
    name = f"{group_name}-{index}"
    tmeta = template.get("metadata") or {}
    labels = dict(tmeta.get("labels") or {})
    labels[NODE_GROUP_LABEL] = group_name
    labels.setdefault("kubernetes.io/hostname", name)
    node: Obj = {
        "metadata": {
            "name": name,
            "labels": labels,
            **({"annotations": dict(tmeta["annotations"])} if tmeta.get("annotations") else {}),
        },
        "spec": dict(template.get("spec") or {}),
        "status": dict(template.get("status") or {}),
    }
    return node
