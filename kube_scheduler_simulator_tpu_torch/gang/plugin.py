"""The Coscheduling oracle plugin: all-or-nothing PodGroup placement on
the SEQUENTIAL scheduling cycle.

Semantics follow the scheduler-plugins coscheduling design on top of this
build's Permit/WaitingPod machinery (scheduler/framework_runner.py):

- **PreFilter** — quorum gate: the pod's PodGroup must exist and have at
  least ``minMember`` member pods in the store, and its declared
  ``minResources`` must fit within total cluster allocatable; otherwise
  the pod is rejected UnschedulableAndUnresolvable before any node work.
- **Permit** — gang parking: until ``minMember`` members hold capacity
  (bound or parked at Permit), each member returns Wait with the group's
  ``scheduleTimeoutSeconds`` and parks in the waiting map, its
  reservation held.  The member that completes the quorum allows every
  parked sibling (``allow_waiting_pod`` finishes their bind cycles) and
  itself returns Success — the whole gang binds in one release.
- **PostFilter** — gang rejection: a member that fails to place rejects
  every parked sibling (all-or-nothing; their reservations release).
- **Reserve/Unreserve** — the cascade anchor: when a parked member is
  unreserved for any reason (its permit wait EXPIRED, or a rejection is
  in flight), Unreserve rejects the remaining parked siblings, so one
  member's timeout tears down the whole gang.

The batched gang engine (gang/engine.py) replays exactly these decisions
from the batch kernel's per-member selections; byte parity between the
two traces, and with the JAX package's, is pinned by
tests/test_torch_gang.py.
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.gang.podgroups import (
    gang_default_timeout_s,
    gang_reject_message,
    group_gate,
    group_info,
    placed_count,
    pod_group_name,
)
from kube_scheduler_simulator_tpu_torch.models.framework import Status

Obj = dict[str, Any]


class Coscheduling:
    """All-or-nothing PodGroup gate over the Permit/WaitingPod machinery."""

    name = "Coscheduling"

    def __init__(self, args: "Obj | None" = None, handle: Any = None):
        self.handle = handle
        t = (args or {}).get("scheduleTimeoutSeconds")
        self.default_timeout = float(t) if t else gang_default_timeout_s()

    # ------------------------------------------------------------- helpers

    def _store(self) -> Any:
        return getattr(self.handle, "cluster_store", None)

    def _group(self, pod: Obj) -> "tuple[str, str, dict] | None":
        """(namespace, group name, group info) for a gang member pod."""
        gname = pod_group_name(pod)
        store = self._store()
        if not gname or store is None:
            return None
        ns = pod["metadata"].get("namespace", "default")
        from kube_scheduler_simulator_tpu_torch.state.store import NotFoundError

        try:
            group = store.get("podgroups", gname, ns)
        except (NotFoundError, KeyError):
            return ns, gname, group_info({})
        return ns, gname, group_info(group)

    def _parked_siblings(self, ns: str, gname: str, but: Obj) -> list:
        fw = self.handle.framework if self.handle else None
        if fw is None:
            return []
        me = (but["metadata"].get("namespace", "default"), but["metadata"]["name"])
        out = []
        for w in fw.iterate_over_waiting_pods():
            wns = w.pod["metadata"].get("namespace", "default")
            if wns != ns or pod_group_name(w.pod) != gname:
                continue
            if (wns, w.pod["metadata"]["name"]) == me:
                continue
            out.append(w)
        return out

    def _reject_siblings(self, ns: str, gname: str, but: Obj) -> None:
        fw = self.handle.framework if self.handle else None
        if fw is None:
            return
        msg = gang_reject_message(gname)
        for w in self._parked_siblings(ns, gname, but):
            # reject pops the sibling BEFORE its unreserve runs, so the
            # cascade terminates even though each rejection re-enters here
            fw.reject_waiting_pod(
                w.pod["metadata"].get("namespace", "default"),
                w.pod["metadata"]["name"],
                msg,
            )

    # ----------------------------------------------------------- PreFilter

    def pre_filter(self, state: Any, pod: Obj) -> "tuple[None, Status | None]":
        gname = pod_group_name(pod)
        store = self._store()
        if not gname or store is None:
            return None, None
        ns = pod["metadata"].get("namespace", "default")
        reason = group_gate(store, ns, gname)
        if reason is not None:
            return None, Status.unresolvable(reason)
        return None, None

    # -------------------------------------------------------------- Permit

    def permit(self, state: Any, pod: Obj, node_name: str) -> "tuple[Status | None, float]":
        g = self._group(pod)
        if g is None:
            return None, 0.0
        ns, gname, info = g
        fw = self.handle.framework
        placed = placed_count(self._store(), fw, ns, gname)
        if placed + 1 >= info["min_member"]:
            # quorum complete: release the parked siblings, then succeed —
            # the whole gang binds in this one cycle
            for w in self._parked_siblings(ns, gname, pod):
                fw.allow_waiting_pod(
                    w.pod["metadata"].get("namespace", "default"),
                    w.pod["metadata"]["name"],
                    self.name,
                )
            return None, 0.0
        return (
            Status.wait(
                f"waiting for pod group {gname}: {placed + 1}/{info['min_member']} placed"
            ),
            info["timeout"] or self.default_timeout,
        )

    # ---------------------------------------------------------- PostFilter

    def post_filter(
        self, state: Any, pod: Obj, filtered_node_status_map: dict
    ) -> "tuple[None, Status]":
        gname = pod_group_name(pod)
        if gname:
            ns = pod["metadata"].get("namespace", "default")
            # all-or-nothing: one member failing tears down the parked rest
            self._reject_siblings(ns, gname, pod)
            return None, Status.unschedulable(gang_reject_message(gname))
        return None, Status.unschedulable("Coscheduling does not preempt")

    # ----------------------------------------------------- Reserve cascade

    def reserve(self, state: Any, pod: Obj, node_name: str) -> None:
        return None

    def unreserve(self, state: Any, pod: Obj, node_name: str) -> None:
        """A gang member losing its reservation (permit wait expired, or a
        rejection in flight) rejects the remaining parked siblings."""
        gname = pod_group_name(pod)
        if not gname:
            return
        ns = pod["metadata"].get("namespace", "default")
        self._reject_siblings(ns, gname, pod)
