"""PrioritySort (QueueSort), DefaultBinder (Bind), DefaultPreemption
(PostFilter) — upstream v1.26 semantics.
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import CycleState, Status
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo

Obj = dict[str, Any]


def pod_priority(pod: Obj) -> int:
    return int((pod.get("spec") or {}).get("priority") or 0)


class PrioritySort:
    name = "PrioritySort"

    def less(self, pod_info1: Obj, pod_info2: Obj) -> bool:
        p1 = pod_priority(pod_info1)
        p2 = pod_priority(pod_info2)
        if p1 != p2:
            return p1 > p2
        t1 = pod_info1["metadata"].get("creationTimestamp") or ""
        t2 = pod_info2["metadata"].get("creationTimestamp") or ""
        return t1 < t2


class DefaultBinder:
    name = "DefaultBinder"

    def __init__(self, args: "Obj | None" = None, handle: Any = None):
        self.handle = handle

    def bind(self, state: CycleState, pod: Obj, node_name: str) -> "Status | None":
        store = getattr(self.handle, "cluster_store", None) if self.handle else None
        if store is None:
            return Status.error("no cluster store to bind against")
        try:
            store.bind_pod(pod["metadata"].get("namespace", "default"), pod["metadata"]["name"], node_name)
        except KeyError as e:
            # Pod vanished mid-cycle: the binding API call fails, the cycle
            # reports an error status (upstream binder behavior).
            return Status.error(f"binding rejected: {e}")
        return None


class DefaultPreemption:
    """PostFilter: find a node where evicting lower-priority pods makes the
    pod schedulable; nominate it and delete the victims.

    Upstream v1.26 semantics (pkg/scheduler/framework/preemption):
    - selectVictimsOnNode: remove ALL lower-priority pods, require the pod
      to fit, then reprieve (re-add) as many as possible — PDB-violating
      pods reprieved first to minimize violations, both groups in
      MoreImportantPod order (priority desc, then earlier start time).
    - pickOneNodeForPreemption criteria, in order: fewest PDB violations,
      lowest highest-victim priority, smallest priority sum, fewest
      victims, latest start time of the highest-priority victim, node
      order.
    """

    name = "DefaultPreemption"

    def __init__(self, args: "Obj | None" = None, handle: Any = None):
        self.handle = handle

    def post_filter(
        self, state: CycleState, pod: Obj, filtered_node_status_map: dict[str, Status]
    ) -> "tuple[str | None, Status | None]":
        fwk = getattr(self.handle, "framework", None) if self.handle else None
        snap = self.handle.snapshot() if self.handle else None
        if fwk is None or snap is None:
            return None, Status.unschedulable("preemption not possible")
        incoming_priority = pod_priority(pod)
        pdbs = self._pdbs()
        candidates: dict[str, list[Obj]] = {}
        violations: dict[str, int] = {}
        for node_name, status in filtered_node_status_map.items():
            if status is not None and status.code.name == "UNSCHEDULABLE_AND_UNRESOLVABLE":
                continue
            ni = snap.get(node_name)
            if ni is None:
                continue
            found = self._select_victims_on_node(fwk, state, pod, ni, incoming_priority, pdbs, snap)
            if found is not None:
                candidates[node_name], violations[node_name] = found

        # Extender preempt pass (upstream Evaluator.callExtenders): preempt-
        # verb extenders narrow the candidate map before the best candidate
        # is picked; a non-ignorable extender failure aborts preemption.
        ext = getattr(fwk, "extender_service", None)
        if candidates and ext is not None and any(e.preempt_verb for e in ext.extenders):
            try:
                candidates = ext.run_preempt(pod, candidates)
            except Exception as e:
                return None, Status.error(f"preemption extender: {e}")

        node_name = self._pick_one_node(candidates, violations)
        if node_name is None:
            return None, Status.unschedulable("preemption: 0/%d nodes are available" % len(filtered_node_status_map))
        victims = candidates[node_name]
        store = getattr(self.handle, "cluster_store", None)
        for v in victims:
            if store is not None:
                try:
                    store.delete("pods", v["metadata"]["name"], v["metadata"].get("namespace"))
                except KeyError:
                    pass
            ni = snap.get(node_name)
            if ni is not None:
                ni.remove_pod(v)
        return node_name, None

    # ------------------------------------------------------------- helpers

    def _pdbs(self) -> list[Obj]:
        store = getattr(self.handle, "cluster_store", None) if self.handle else None
        if store is None:
            return []
        try:
            return store.list("poddisruptionbudgets", copy_objects=False)
        except Exception:
            return []

    def _violates_pdb(self, victim: Obj, pdbs: list[Obj], budget: dict[int, int]) -> bool:
        """Would evicting ``victim`` violate any matching PDB, given the
        remaining per-PDB budget for this dry run?  (Shared rule —
        utils/pdb.py — so the autoscaler's drain math can't diverge.)"""
        from kube_scheduler_simulator_tpu_torch.utils.pdb import violates_pdb

        return violates_pdb(victim, pdbs, budget)

    @staticmethod
    def _start_time(p: Obj) -> str:
        return (p.get("status") or {}).get("startTime") or p["metadata"].get("creationTimestamp") or ""

    def _more_important(self, p: Obj) -> tuple:
        """MoreImportantPod sort key: higher priority first, then earlier
        start time."""
        return (-pod_priority(p), self._start_time(p))

    def _select_victims_on_node(
        self, fwk: Any, state: CycleState, pod: Obj, ni: NodeInfo, incoming_priority: int, pdbs: list[Obj],
        snap: Any = None,
    ) -> "tuple[list[Obj], int] | None":
        lower = [p for p in ni.pods if pod_priority(p) < incoming_priority]
        if not lower:
            return None
        scratch = NodeInfo(ni.node)
        for p in ni.pods:
            scratch.add_pod(p)
        # remove every lower-priority pod; the incoming pod must fit then
        for p in lower:
            scratch.remove_pod(p)
        if not fwk.run_filter_plugins_silently(state, pod, scratch, snapshot=snap):
            return None
        # split by PDB violation, each group in MoreImportantPod order;
        # reprieve the violating group first (minimizes violations)
        budget: dict[int, int] = {}
        violating, non_violating = [], []
        for p in sorted(lower, key=self._more_important):
            (violating if self._violates_pdb(p, pdbs, budget) else non_violating).append(p)
        victims: list[Obj] = []
        num_violating = 0

        def reprieve(p: Obj) -> bool:
            scratch.add_pod(p)
            if fwk.run_filter_plugins_silently(state, pod, scratch, snapshot=snap):
                return True
            scratch.remove_pod(p)
            return False

        for p in violating:
            if not reprieve(p):
                victims.append(p)
                num_violating += 1
        for p in non_violating:
            if not reprieve(p):
                victims.append(p)
        if not victims:
            return None
        return victims, num_violating

    def _pick_one_node(
        self, candidates: dict[str, list[Obj]], violations: dict[str, int]
    ) -> "str | None":
        """pickOneNodeForPreemption: lexicographic upstream criteria; node
        insertion order (the filtered map order) breaks remaining ties."""
        best_name: "str | None" = None
        best_key: "tuple | None" = None
        for name, victims in candidates.items():
            if not victims:
                return name  # no victims needed at all — immediately best
            high_prio = max(pod_priority(v) for v in victims)
            # upstream GetEarliestPodStartTime: the node whose EARLIEST
            # start time among its highest-priority victims is LATEST wins
            # — _ReverseStr flips the string comparison inside the
            # ascending tuple ordering
            earliest_start = min(
                self._start_time(v) for v in victims if pod_priority(v) == high_prio
            )
            full_key = (
                violations.get(name, 0),
                high_prio,
                sum(pod_priority(v) for v in victims),
                len(victims),
                _ReverseStr(earliest_start),
            )
            if best_key is None or full_key < best_key:
                best_key = full_key
                best_name = name
        return best_name


class _ReverseStr(str):
    """Orders strings DESCENDING inside an ascending tuple comparison
    (pickOneNodeForPreemption prefers the LATEST victim start time)."""

    def __lt__(self, other):  # type: ignore[override]
        return str.__gt__(self, other)

    def __gt__(self, other):  # type: ignore[override]
        return str.__lt__(self, other)
