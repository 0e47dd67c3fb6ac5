"""PodGroup store kind: admission, membership, and the gang gates.

The PodGroup object follows the scheduler-plugins coscheduling CRD shape
(scheduling.x-k8s.io/v1alpha1 PodGroup):

    apiVersion: scheduling.x-k8s.io/v1alpha1
    kind: PodGroup
    metadata: {name: train-42, namespace: default}
    spec:
      minMember: 8                      # all-or-nothing quorum
      minResources: {cpu: "16", memory: "64Gi"}   # optional admission gate
      scheduleTimeoutSeconds: 300       # Permit wait budget (gang timeout)
      topologyPackKey: topology.kubernetes.io/zone  # packing domain label

Pods join a group via the coscheduling label
``pod-group.scheduling.sigs.k8s.io: <group name>`` (same namespace).

This module is the ONE source of truth both scheduling paths share: the
oracle Coscheduling plugin (gang/plugin.py) and the batched gang engine
(gang/engine.py) call the same ``group_gate`` / ``placed_count`` helpers,
so their decisions cannot drift — the parity bar in
tests/test_torch_gang.py rests on that.  Port of the JAX package's
``gang/podgroups.py`` (JAX-free there too), copied whole.
"""

from __future__ import annotations

import os
from typing import Any

from kube_scheduler_simulator_tpu_torch.utils.quantity import parse_quantity

Obj = dict[str, Any]

# the coscheduling membership label (scheduler-plugins v1alpha1)
POD_GROUP_LABEL = "pod-group.scheduling.sigs.k8s.io"
# default packing domain when the group doesn't pick one
DEFAULT_TOPOLOGY_KEY = "topology.kubernetes.io/zone"


def gang_default_timeout_s() -> float:
    """Default Permit wait for groups without scheduleTimeoutSeconds
    (``KSS_GANG_DEFAULT_TIMEOUT_S``, default 300 s — the coscheduling
    plugin's DefaultWaitTime neighborhood)."""
    try:
        return float(os.environ.get("KSS_GANG_DEFAULT_TIMEOUT_S", "") or 300.0)
    except ValueError:
        return 300.0


def gang_batch_enabled() -> bool:
    """``KSS_GANG_BATCH=0`` pins gang rounds to the sequential oracle
    (the batched gang replay is skipped, counted as a fallback)."""
    return os.environ.get("KSS_GANG_BATCH", "").strip().lower() not in (
        "0", "off", "false", "no",
    )


def pod_group_name(pod: Obj) -> "str | None":
    """The pod's PodGroup name (None for singleton pods)."""
    return ((pod.get("metadata") or {}).get("labels") or {}).get(POD_GROUP_LABEL)


def validate_pod_group(group: Obj) -> None:
    """Admission for a PodGroup route (the HTTP server is not ported): raises
    ValueError with the reason (the generic resources route stores raw
    objects, like nodegroups — ``group_info`` then defaults leniently)."""
    meta = group.get("metadata") or {}
    if not meta.get("name") and not meta.get("generateName"):
        raise ValueError("PodGroup needs metadata.name or metadata.generateName")
    spec = group.get("spec") or {}
    mm = spec.get("minMember")
    if not isinstance(mm, int) or isinstance(mm, bool) or mm < 1:
        raise ValueError("spec.minMember must be an integer >= 1")
    t = spec.get("scheduleTimeoutSeconds")
    if t is not None and (not isinstance(t, (int, float)) or isinstance(t, bool) or t <= 0):
        raise ValueError("spec.scheduleTimeoutSeconds must be a positive number")
    res = spec.get("minResources")
    if res is not None:
        if not isinstance(res, dict):
            raise ValueError("spec.minResources must be a map of resource quantities")
        for r, q in res.items():
            try:
                parse_quantity(q)
            except Exception:
                raise ValueError(f"spec.minResources[{r}]: unparseable quantity {q!r}") from None
    key = spec.get("topologyPackKey")
    if key is not None and not isinstance(key, str):
        raise ValueError("spec.topologyPackKey must be a label key string")


def group_info(group: Obj) -> dict:
    """The (leniently defaulted) fields scheduling consumes."""
    spec = group.get("spec") or {}
    try:
        min_member = max(int(spec.get("minMember") or 1), 1)
    except (TypeError, ValueError):
        min_member = 1
    t = spec.get("scheduleTimeoutSeconds")
    try:
        timeout = float(t) if t is not None and float(t) > 0 else gang_default_timeout_s()
    except (TypeError, ValueError):
        timeout = gang_default_timeout_s()
    return {
        "min_member": min_member,
        "timeout": timeout,
        "topology_key": spec.get("topologyPackKey") or DEFAULT_TOPOLOGY_KEY,
        "min_resources": spec.get("minResources") or {},
    }


def _members(pods: "list[Obj]", namespace: str, group_name: str) -> "list[Obj]":
    return [
        p
        for p in pods
        if pod_group_name(p) == group_name
        and (p["metadata"].get("namespace") or "default") == namespace
        and not p["metadata"].get("deletionTimestamp")
    ]


def group_gate(store: Any, namespace: str, group_name: str) -> "str | None":
    """Why the group can't be admitted to scheduling right now (None =
    admitted).  The Coscheduling PreFilter and the batched gang round's
    supportability gate BOTH call this — identical inputs, identical
    verdicts, so the two paths can never disagree on admission."""
    from kube_scheduler_simulator_tpu_torch.state.store import NotFoundError

    try:
        group = store.get("podgroups", group_name, namespace)
    except (NotFoundError, KeyError):
        return f"PodGroup {namespace}/{group_name} not found"
    info = group_info(group)
    total = len(_members(store.list("pods", copy_objects=False), namespace, group_name))
    if total < info["min_member"]:
        return (
            f"pod group {group_name} quorum not met: "
            f"{total}/{info['min_member']} members exist"
        )
    if info["min_resources"]:
        from kube_scheduler_simulator_tpu_torch.models.podresources import node_allocatable

        totals: dict[str, int] = {}
        for nd in store.list("nodes", copy_objects=False):
            for r, v in node_allocatable(nd).items():
                totals[r] = totals.get(r, 0) + v
        for r, q in info["min_resources"].items():
            want = _to_internal_quantity(r, q)
            if want > totals.get(r, 0):
                return (
                    f"pod group {group_name} minResources[{r}] exceeds "
                    f"cluster allocatable"
                )
    return None


def _to_internal_quantity(resource: str, q: Any) -> int:
    """minResources quantities in the SAME internal units node_allocatable
    and pod_resource_request use (cpu in millis, everything else whole)."""
    from kube_scheduler_simulator_tpu_torch.models.podresources import _to_internal

    try:
        return _to_internal(resource, q)
    except Exception:
        return 0


def placed_count(store: Any, framework: Any, namespace: str, group_name: str) -> int:
    """Members of the group currently HOLDING capacity: bound in the
    store, plus parked at Permit with a reservation (the waiting map).
    This count, plus one for the member being scheduled, is what the
    Permit quorum compares to minMember — the batch replay's completeness
    check mirrors it through this same function's arithmetic."""
    bound = 0
    for p in store.list("pods", copy_objects=False):
        if (
            pod_group_name(p) == group_name
            and (p["metadata"].get("namespace") or "default") == namespace
            and (p.get("spec") or {}).get("nodeName")
            and not p["metadata"].get("deletionTimestamp")
        ):
            bound += 1
    parked = 0
    for w in framework.iterate_over_waiting_pods():
        if (
            pod_group_name(w.pod) == group_name
            and (w.pod["metadata"].get("namespace") or "default") == namespace
        ):
            parked += 1
    return bound + parked


def gang_scheduler_profile(scheduler_name: str = "default-scheduler") -> Obj:
    """The canonical gang profile: the default plugin set plus the
    Coscheduling oracle (PreFilter/Reserve/Permit/PostFilter via
    MultiPoint expansion), with DefaultPreemption disabled — a failed
    gang member tears its group down instead of evicting victims.
    Scenario runs, the chip smoke, and the tests all build from this one
    shape so the batch gates and the oracle agree on the profile."""
    return {
        "schedulerName": scheduler_name,
        "plugins": {
            "multiPoint": {
                "enabled": [{"name": "Coscheduling"}],
                "disabled": [{"name": "DefaultPreemption"}],
            }
        },
    }


def gang_scheduler_config(percentage_of_nodes_to_score: int = 100) -> Obj:
    return {
        "profiles": [gang_scheduler_profile()],
        "percentageOfNodesToScore": percentage_of_nodes_to_score,
    }


def gang_reject_message(group_name: str) -> str:
    """The ONE rejection message both cascade paths use (a member failed
    mid-gang or a member's permit wait was unreserved/expired)."""
    return f"pod group {group_name} gang rejected: a member failed or timed out"


def partially_bound_groups(store: Any) -> list[str]:
    """Groups violating the all-or-nothing invariant in COMMITTED state:
    more than zero but fewer than minMember members bound.  Must always
    be empty — the ONE check the tests and the chip smoke assert
    through this function."""
    groups = {
        (g["metadata"].get("namespace") or "default", g["metadata"]["name"]): group_info(g)[
            "min_member"
        ]
        for g in store.list("podgroups")
    }
    bound: dict[tuple[str, str], int] = {k: 0 for k in groups}
    for p in store.list("pods", copy_objects=False):
        gname = pod_group_name(p)
        if not gname:
            continue
        k = (p["metadata"].get("namespace") or "default", gname)
        if k in bound and (p.get("spec") or {}).get("nodeName"):
            bound[k] += 1
    return [f"{ns}/{g}" for (ns, g), n in bound.items() if 0 < n < groups[(ns, g)]]


def group_status(store: Any, framework: Any, group: Obj) -> dict:
    """Live status of a PodGroup (what the reference's podgroups route
    serves)."""
    ns = group["metadata"].get("namespace") or "default"
    name = group["metadata"]["name"]
    info = group_info(group)
    members = _members(store.list("pods", copy_objects=False), ns, name)
    bound = sum(1 for p in members if (p.get("spec") or {}).get("nodeName"))
    parked = 0
    if framework is not None:
        for w in framework.iterate_over_waiting_pods():
            if (
                pod_group_name(w.pod) == name
                and (w.pod["metadata"].get("namespace") or "default") == ns
            ):
                parked += 1
    if bound >= info["min_member"]:
        phase = "Scheduled"
    elif bound or parked:
        phase = "Scheduling"
    else:
        phase = "Pending"
    return {
        "phase": phase,
        "members": len(members),
        "minMember": info["min_member"],
        "bound": bound,
        "waiting": parked,
        "scheduleTimeoutSeconds": info["timeout"],
        "topologyPackKey": info["topology_key"],
    }
