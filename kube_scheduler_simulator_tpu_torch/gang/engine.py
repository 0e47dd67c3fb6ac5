"""The gang round context: supportability gates + the batched gang replay.

``prepare_round`` builds (or refuses to build, with a counted reason) the
gang state for one batch segment whose profile runs the Coscheduling
oracle at Permit; ``GangRound`` then drives the replay's gang decisions:

- **park**: a kernel-scheduled gang member records its batch trace (the
  same categories the wrapped plugins record, permit = Wait + timeout)
  and parks in the framework's waiting map holding its reservation —
  byte-identical to the oracle cycle parking at Permit;
- **commit_release**: the member completing the quorum commits the WHOLE
  gang as one wave — ``ResultStore.add_wave_results`` for every member's
  bind-cycle records, ``ClusterStore.bulk_update`` binding all members
  in park order under one lock/one batched event dispatch, one reflector
  ``flush_wave`` — the all-or-nothing atomic commit;
- **note_window**: ONE gang-kernel dispatch per replay window (not per
  group) computes every group's all-or-nothing verdict and topology-
  packing metric from the selections (gang/kernel.run_window_verdict: the
  CUDA kernel K6 on the card, its plain version on the CPU, on the
  service's device), cross-checked against host arithmetic
  (``gang_verdict_mismatch`` must stay 0).

Kernel-FAILED gang members take the exact sequential cycle (the service's
existing fallback), where the oracle Coscheduling PostFilter rejects the
parked siblings — so failure cascades run the same code on both paths and
cannot diverge.  Everything outside the envelope (quorum/minResources
gate failures, non-Coscheduling permit plugins, ``KSS_GANG_BATCH=0``)
falls back to the sequential round, counted per reason like
preemption/engine.py.

Port of the JAX package's ``gang/engine.py``.  ``group_preview`` is the
PodGroup preview's entry point (the HTTP route in front of it is not
ported) and runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.device import resolve_device
from kube_scheduler_simulator_tpu_torch.gang import kernel as GK
from kube_scheduler_simulator_tpu_torch.gang.encode import node_domain_ids
from kube_scheduler_simulator_tpu_torch.gang.podgroups import (
    gang_batch_enabled,
    group_gate,
    group_info,
    pod_group_name,
)
from kube_scheduler_simulator_tpu_torch.models.framework import CycleState, WaitingPod
from kube_scheduler_simulator_tpu_torch.plugins.resultstore import (
    SUCCESS_MESSAGE,
    WAIT_MESSAGE,
    _go_duration,
)

Obj = dict[str, Any]

PLUGIN = "Coscheduling"


def prepare_round(
    service: Any, fw: Any, eng: Any, pending: list[Obj], nodes: list[Obj]
) -> "tuple[GangRound | None, str | None]":
    """Build the gang context for one batch segment, or (None, reason)
    when the round must run on the exact sequential oracle instead."""
    permit = [wp.original.name for wp in fw.plugins["permit"]]
    if permit != [PLUGIN]:
        return None, f"permit plugins {permit} are not the Coscheduling oracle"
    if not gang_batch_enabled():
        return None, "gang batch path disabled (KSS_GANG_BATCH=0)"
    store = service.cluster_store
    groups: dict[tuple[str, str], dict] = {}
    for p in pending:
        gname = pod_group_name(p)
        if not gname:
            continue
        ns = p["metadata"].get("namespace", "default")
        k = (ns, gname)
        if k in groups:
            continue
        # the oracle's PreFilter would reject this pod with a whole-round
        # result shape the replay can't reproduce — sequential, counted
        reason = group_gate(store, ns, gname)
        if reason is not None:
            return None, reason
        groups[k] = group_info(store.get("podgroups", gname, ns))
    return GangRound(service, fw, nodes, groups), None


def group_preview(
    store: Any, group: Obj, device: "str | torch.device | None" = None, dtype: "torch.dtype | None" = None,
) -> dict:
    """Feasibility preview for one PodGroup against the live cluster:
    the all-or-nothing scan (gang/kernel.run_feasibility, K7) over the
    group's unbound members, with the group-granularity victim search
    (K5) when free capacity alone can't host the gang.  An ESTIMATION
    surface (the reference serves it at GET
    /api/v1/podgroups/<name>?preview=1) — it never drives placement.
    ``device``: the card unless the caller passes "cpu"; ``dtype``: float32
    on the card, float64 on the CPU (both kernels raise ``ValueError`` on
    magnitudes beyond exact integers in it)."""
    from kube_scheduler_simulator_tpu_torch.gang.encode import encode_feasibility
    from kube_scheduler_simulator_tpu_torch.models.snapshot import Snapshot
    from kube_scheduler_simulator_tpu_torch.plugins.intree.queue_bind import pod_priority

    ns = group["metadata"].get("namespace") or "default"
    gname = group["metadata"]["name"]
    info = group_info(group)
    pods = store.list("pods", copy_objects=False)
    nodes = store.list("nodes", copy_objects=False)
    snap = Snapshot(nodes, pods, [])
    members = [
        p
        for p in pods
        if pod_group_name(p) == gname
        and (p["metadata"].get("namespace") or "default") == ns
        and not (p.get("spec") or {}).get("nodeName")
        and not p["metadata"].get("deletionTimestamp")
    ]
    dev = resolve_device(device)
    pr = encode_feasibility([members], [info["topology_key"]], snap.node_infos)
    out = GK.run_feasibility(pr, device=dev, dtype=dtype)
    feasible = bool(out["feasible"][0])
    res: dict = {
        "feasible": feasible,
        "distinctTopologyDomains": int(out["distinct_domains"][0]),
        "assignment": {
            m["metadata"]["name"]: (
                pr.node_names[int(out["assignment"][0, i])]
                if int(out["assignment"][0, i]) >= 0
                else None
            )
            for i, m in enumerate(members)
        },
    }
    if not feasible and members:
        try:
            pdbs = store.list("poddisruptionbudgets", copy_objects=False)
        except Exception:
            pdbs = []
        prio = min(pod_priority(p) for p in members)
        res["victimPreview"] = GK.group_victim_search(
            snap.node_infos, [(members, prio)], pdbs, device=dev, dtype=dtype
        )[0]
    return res


class GangRound:
    """Gang replay state for one batch segment (see module docstring)."""

    def __init__(self, service: Any, fw: Any, nodes: list[Obj], groups: dict):
        self.service = service
        self.fw = fw
        self.groups = groups  # (ns, gname) -> group_info dict
        self.engaged = bool(groups)
        self.gid = {k: i for i, k in enumerate(groups)}
        self.node_id = {nd["metadata"]["name"]: i for i, nd in enumerate(nodes)}
        G = len(groups)
        self.min_member = np.array(
            [groups[k]["min_member"] for k in groups], dtype=np.int32
        ).reshape(G)
        if G:
            self.dom, self.D = node_domain_ids(
                nodes, [groups[k]["topology_key"] for k in groups]
            )
        else:
            self.dom, self.D = np.zeros((0, len(nodes)), np.int32), 1
        # the domain table on the service's device, uploaded at the round's
        # first window and reused by the rest
        self._dom_dev: "torch.Tensor | None" = None
        # members already holding capacity at round start
        self.bound = {k: 0 for k in groups}
        self.parked: dict[tuple[str, str], list[str]] = {k: [] for k in groups}
        self.parked_nodes: dict[tuple[str, str], list[int]] = {k: [] for k in groups}
        if groups:
            for p in service.cluster_store.list("pods", copy_objects=False):
                k = self._key_of(p)
                if (
                    k is not None
                    and (p.get("spec") or {}).get("nodeName")
                    and not p["metadata"].get("deletionTimestamp")
                ):
                    self.bound[k] += 1
            for w in fw.iterate_over_waiting_pods():
                k = self._key_of(w.pod)
                if k is not None:
                    self.parked[k].append(w.key)
                    self.parked_nodes[k].append(self.node_id.get(w.node_name, -1))

    # ------------------------------------------------------------- helpers

    def _key_of(self, pod: Obj) -> "tuple[str, str] | None":
        gname = pod_group_name(pod)
        if not gname:
            return None
        k = (pod["metadata"].get("namespace", "default"), gname)
        return k if k in self.groups else None

    def group_of(self, pod: Obj) -> "tuple[str, str] | None":
        return self._key_of(pod)

    def _prune_parked(self, k: "tuple[str, str]") -> None:
        """Drop parked entries no longer in the LIVE waiting map: a
        kernel-failed member's sequential cascade (Coscheduling
        PostFilter) rejects parked siblings mid-segment, and a stale
        count here would let completes() fire early and commit a PARTIAL
        gang — the one thing this engine exists to prevent."""
        live = self.fw.waiting_pods
        if all(sk in live for sk in self.parked[k]):
            return
        kept = [
            (sk, nid)
            for sk, nid in zip(self.parked[k], self.parked_nodes[k])
            if sk in live
        ]
        self.parked[k] = [sk for sk, _nid in kept]
        self.parked_nodes[k] = [nid for _sk, nid in kept]

    def completes(self, k: "tuple[str, str]") -> bool:
        """Would this member complete the quorum?  The same arithmetic the
        oracle Permit runs (bound + parked + 1 vs minMember)."""
        self._prune_parked(k)
        return self.bound[k] + len(self.parked[k]) + 1 >= self.groups[k]["min_member"]

    def _success_cats(
        self, result: Any, j: int, pod: Obj, node_name: str, point_names: dict
    ) -> dict:
        """The batch trace categories a kernel-scheduled gang member
        records (identical content to the wave commit's, which the
        commit-parity suite pins against the wrapped plugins)."""
        cats: dict = {}
        pf_names = point_names["pre_filter"]
        if pf_names:
            cats["preFilterStatus"] = {pn: SUCCESS_MESSAGE for pn in pf_names}
            if "NodeAffinity" in pf_names:
                names = result._engine.prefilter_node_names(pod)
                if names is not None:
                    cats["preFilterResult"] = {"NodeAffinity": sorted(names)}
        cats["filter"] = result.filter_annotation_pair(j)
        if int(result.feasible_count[j]) > 1:
            pre_score = {pn: SUCCESS_MESSAGE for pn in point_names["pre_score"]}
            if pre_score:
                cats["preScore"] = pre_score
            score_pair, final_pair = result.score_annotations_pairs(j)
            cats["score"] = score_pair
            cats["finalScore"] = final_pair
        if point_names["reserve"]:
            cats["selectedNode"] = node_name
            cats["reserve"] = {pn: SUCCESS_MESSAGE for pn in point_names["reserve"]}
        return cats

    # ---------------------------------------------------------------- park

    def park(
        self,
        result: Any,
        j: int,
        pod: Obj,
        node_name: str,
        snapshot: Any,
        point_names: dict,
    ) -> Any:
        """Park a kernel-scheduled gang member at Permit, exactly as the
        oracle cycle does: trace recorded (permit = Wait + the group's
        timeout), reservation held in the waiting map + round snapshot."""
        from kube_scheduler_simulator_tpu_torch.scheduler.framework_runner import (
            MAX_PERMIT_TIMEOUT_S,
            ScheduleResult,
        )

        k = self._key_of(pod)
        assert k is not None
        info = self.groups[k]
        ns = pod["metadata"].get("namespace", "default")
        name = pod["metadata"]["name"]
        cats = self._success_cats(result, j, pod, node_name, point_names)
        # the wrapped recorder stores the RAW plugin timeout; the waiting
        # map clamps to the 15 min max (framework_runner.schedule_one)
        cats["permit"] = {PLUGIN: WAIT_MESSAGE}
        cats["permitTimeout"] = {PLUGIN: _go_duration(info["timeout"])}
        self.fw.result_store.add_wave_results([(ns, name, cats)])
        t = info["timeout"] if info["timeout"] > 0 else MAX_PERMIT_TIMEOUT_S
        wp = WaitingPod(
            pod,
            node_name,
            CycleState(),
            {PLUGIN: min(t, MAX_PERMIT_TIMEOUT_S)},
            self.fw.clock(),
        )
        self.fw.waiting_pods[wp.key] = wp
        self.service._wait_move_seq[wp.key] = self.service.queue.move_seq
        if snapshot is not None:
            snapshot.assume(pod, node_name)
        self.parked[k].append(wp.key)
        self.parked_nodes[k].append(self.node_id.get(node_name, -1))
        self.service.stats["gang_parked"] += 1
        return ScheduleResult(waiting_on=node_name)

    # ------------------------------------------------------------- release

    def commit_release(
        self,
        result: Any,
        j: int,
        pod: Obj,
        node_name: str,
        snapshot: Any,
        point_names: dict,
    ) -> Any:
        """The quorum-completing member commits the whole gang atomically:
        one result-store wave, one bulk-update bind transaction (members
        in park order, the releasing member last — the oracle's release
        order), one reflector wave flush."""
        from kube_scheduler_simulator_tpu_torch.scheduler.framework_runner import ScheduleResult

        svc = self.service
        fw = self.fw
        k = self._key_of(pod)
        assert k is not None
        self._prune_parked(k)
        sib_keys = list(self.parked[k])
        self.parked[k] = []
        self.parked_nodes[k] = []
        wps = [fw.waiting_pods.pop(sk) for sk in sib_keys if sk in fw.waiting_pods]
        ns = pod["metadata"].get("namespace", "default")
        name = pod["metadata"]["name"]

        prebind = {pn: SUCCESS_MESSAGE for pn in point_names["pre_bind"]}
        bindc = (
            {point_names["bind"][0]: SUCCESS_MESSAGE} if point_names["bind"] else None
        )
        entries: list[tuple[str, str, dict]] = []
        for w in wps:
            cats: dict = {}
            if prebind:
                cats["prebind"] = prebind
            if bindc:
                cats["bind"] = bindc
            entries.append(
                (
                    w.pod["metadata"].get("namespace", "default"),
                    w.pod["metadata"]["name"],
                    cats,
                )
            )
        self_cats = self._success_cats(result, j, pod, node_name, point_names)
        self_cats["permit"] = {PLUGIN: SUCCESS_MESSAGE}
        self_cats["permitTimeout"] = {PLUGIN: _go_duration(0)}
        if prebind:
            self_cats["prebind"] = prebind
        if bindc:
            self_cats["bind"] = bindc
        entries.append((ns, name, self_cats))

        with svc.cluster_store.journal_txn("gang-release"):
            return self._commit_release_txn(
                entries, wps, sib_keys, pod, ns, name, node_name, snapshot, k
            )

    def _commit_release_txn(
        self,
        entries: list,
        wps: list,
        sib_keys: list,
        pod: Obj,
        ns: str,
        name: str,
        node_name: str,
        snapshot: Any,
        k: "tuple[str, str]",
    ) -> Any:
        """The release's mutating tail, grouped into ONE atomic journal
        record (state/journal.py): the result-store wave, the bulk bind
        transaction, the reflector wave flush and the Scheduled event
        recover together or not at all — a crash can never leave a
        partially-bound gang."""
        from kube_scheduler_simulator_tpu_torch.scheduler.framework_runner import ScheduleResult

        svc = self.service
        fw = self.fw
        fw.result_store.add_wave_results(entries)

        def bind_to(node: str):
            def mut(cur: "Obj | None") -> "Obj | None":
                if cur is None:
                    return None
                return {
                    **cur,
                    "metadata": dict(cur["metadata"]),
                    "spec": {**(cur.get("spec") or {}), "nodeName": node},
                }

            return mut

        svc.cluster_store.bulk_update(
            "pods",
            [
                (
                    w.pod["metadata"]["name"],
                    w.pod["metadata"].get("namespace", "default"),
                    bind_to(w.node_name),
                )
                for w in wps
            ]
            + [(name, ns, bind_to(node_name))],
        )
        for sk in sib_keys:
            svc._wait_move_seq.pop(sk, None)
        if snapshot is not None:
            snapshot.assume(pod, node_name)
        svc.reflector.flush_wave(svc.cluster_store, [w.pod for w in wps] + [pod])
        # the oracle records a Scheduled event for the RELEASING member
        # only (parked siblings bind through allow_waiting_pod, which the
        # service's event recorder never sees)
        svc._record_event(
            pod, "Normal", "Scheduled", f"Successfully assigned {ns}/{name} to {node_name}"
        )
        self.bound[k] += len(wps) + 1
        svc.stats["gang_released_groups"] += 1
        svc.stats["gang_released_pods"] += len(wps) + 1
        return ScheduleResult(selected_node=node_name)

    # -------------------------------------------------------- window verdict

    def note_window(self, result: Any, cnt: int) -> None:
        """ONE gang-kernel dispatch covering every group of this replay
        window: all-or-nothing verdict + distinct-topology-domain packing
        metric over the window's selections plus the currently parked
        members, cross-checked against host arithmetic."""
        if not self.engaged:
            return
        window = result.pending
        gids: list[int] = []
        sel_nodes: list[int] = []
        for j in range(cnt):
            k = self._key_of(window[j])
            if k is None:
                continue
            gids.append(self.gid[k])
            sel_nodes.append(int(result.selected[j]))
        for k in self.groups:
            self._prune_parked(k)
        for k, nodes in self.parked_nodes.items():
            for nid in nodes:
                gids.append(self.gid[k])
                sel_nodes.append(nid)
        if not gids:
            return
        G = len(self.groups)
        prior_bound = np.zeros(G, dtype=np.int32)
        for k, b in self.bound.items():
            prior_bound[self.gid[k]] = b
        t0 = time.perf_counter()
        if self._dom_dev is None:
            self._dom_dev = torch.from_numpy(self.dom).to(self.service.device)
        out = GK.run_window_verdict(
            np.asarray(gids, np.int32),
            np.asarray(sel_nodes, np.int32),
            self._dom_dev,
            prior_bound,
            self.min_member,
            self.D,
            device=self.service.device,
        )
        svc = self.service
        svc.stats["gang_kernel_s"] += time.perf_counter() - t0
        svc.stats["gang_kernel_dispatches"] += 1
        # host cross-check of the device arithmetic (a float/scatter bug
        # here must be LOUD, like the autoscaler's kernel-error counter)
        placed = np.zeros(G, dtype=np.int64)
        failed = np.zeros(G, dtype=np.int64)
        doms: list[set] = [set() for _ in range(G)]
        for g, n in zip(gids, sel_nodes):
            if n >= 0:
                placed[g] += 1
                doms[g].add(int(self.dom[g, n]))
            else:
                failed[g] += 1
        exp_ok = (failed == 0) & ((placed + prior_bound) >= self.min_member)
        exp_d = np.array([len(d) for d in doms], dtype=np.int32)
        if not (
            np.array_equal(np.asarray(out["feasible"], bool), exp_ok)
            and np.array_equal(np.asarray(out["distinct_domains"], np.int32), exp_d)
        ):
            svc.stats["gang_verdict_mismatch"] += 1
