"""The preemption round context: supportability gates and the decisions.

Port of the JAX package's ``preemption/engine.py``.  ``prepare_round``
builds (or refuses to build, with a reason) the encoded victim-search state
for one batch kernel run; ``PreemptionRound.decide`` then turns one replay
window's kernel failures into oracle-identical preemption decisions with
ONE victim-search dispatch for the whole window (preemption/kernel.py: the
CUDA kernel on the card, its plain version on the CPU), ranking candidates
on the host with pickOneNodeForPreemption's exact lexicographic criteria in
int64.  The node-axis tables go to the device once per round; a dispatch
uploads only the window's pods, its same-window successes and the usage
earlier windows committed.

Exactness envelope (everything outside it falls back to the sequential
DefaultPreemption cycle, counted per reason):

- the profile's PostFilter is exactly DefaultPreemption, with no
  preempt-verb extenders;
- no pod in the cluster carries required anti-affinity (evicting such a
  victim could resolve an InterPodAffinity failure the kernel diagnosis
  recorded as final);
- the unschedulable pod requests no host ports and mounts no volumes, and
  has no required spread constraints or required pod (anti-)affinity —
  leaving NodeResourcesFit as the only resolvable filter, whose victim
  arithmetic the search reproduces bit-exactly.

On a node mesh (the engine's ``mesh``) each dispatch runs one search a
shard over its node range (preemption/kernel.run_search(mesh=)), counted
in ``sharded_dispatches``.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo
from kube_scheduler_simulator_tpu_torch.plugins.intree.queue_bind import pod_priority
from kube_scheduler_simulator_tpu_torch.preemption import encode as PE
from kube_scheduler_simulator_tpu_torch.preemption import kernel as PK

Obj = dict[str, Any]

_I64_MIN = np.iinfo(np.int64).min
_I64_MAX = np.iinfo(np.int64).max


class Decision:
    """One pod's PostFilter outcome: ``node_name`` (nomination) plus the
    victims in the oracle's delete order, or a no-candidates failure
    (``node_name is None``)."""

    __slots__ = ("node_name", "victims")

    def __init__(self, node_name: "str | None", victims: "list[Obj] | None" = None):
        self.node_name = node_name
        self.victims = victims or []


def _has_host_ports(pod: Obj) -> bool:
    for c in (pod.get("spec") or {}).get("containers") or []:
        for prt in c.get("ports") or []:
            if prt.get("hostPort"):
                return True
    return False


def _required_spread(pod: Obj) -> bool:
    for tsc in (pod.get("spec") or {}).get("topologySpreadConstraints") or []:
        if (tsc.get("whenUnsatisfiable") or "DoNotSchedule") == "DoNotSchedule":
            return True
    return False


def _required_pod_affinity(pod: Obj) -> bool:
    aff = (pod.get("spec") or {}).get("affinity") or {}
    for kind in ("podAffinity", "podAntiAffinity"):
        if (aff.get(kind) or {}).get("requiredDuringSchedulingIgnoredDuringExecution"):
            return True
    return False


def _required_anti_affinity(pod: Obj) -> bool:
    aff = (pod.get("spec") or {}).get("affinity") or {}
    return bool((aff.get("podAntiAffinity") or {}).get("requiredDuringSchedulingIgnoredDuringExecution"))


def pod_search_gate(pod: Obj) -> "str | None":
    """Why this unschedulable pod's victim search can't run batched (None =
    supported)."""
    if _has_host_ports(pod):
        return "preemptor requests host ports"
    if (pod.get("spec") or {}).get("volumes"):
        return "preemptor mounts volumes"
    if _required_spread(pod):
        return "preemptor has required topology spread constraints"
    if _required_pod_affinity(pod):
        return "preemptor has required pod (anti-)affinity"
    return None


def nomination_gate(nominated: "list[tuple[Obj, str]]", round_pods: list[Obj]) -> "str | None":
    """Why pending nominations can't be modeled as filter-only usage for
    this round's kernel runs (None = modelable).  The model adds each
    nominee's requests and count to the Fit filter state on its nominated
    node (ops/encode.py ``nominated=``); that is exact only when every round
    pod must unconditionally respect every reservation (priority <=) and no
    non-monotone filter can observe the difference."""
    if not nominated:
        return None
    min_nom = min(pod_priority(p) for p, _nn in nominated)
    for p, _nn in nominated:
        if _has_host_ports(p):
            return "nominated pod requests host ports"
        if (p.get("spec") or {}).get("volumes"):
            return "nominated pod mounts volumes"
        if _required_anti_affinity(p):
            return "nominated pod has required anti-affinity"
    for p in round_pods:
        if pod_priority(p) > min_nom:
            return "pending pod outranks a nomination"
        if _required_spread(p):
            return "pending pod has required topology spread constraints"
        if _required_pod_affinity(p):
            return "pending pod has required pod (anti-)affinity"
    return None


class PreemptionRound:
    """Victim-search state for one batch kernel run over ``tail``."""

    def __init__(self, pr: "PE.PreemptionProblem", tail: list[Obj], fit_k: int,
                 ureq_all: np.ndarray, uprio_all: np.ndarray,
                 pod_reasons: "list[str | None]", n_true: int,
                 device: "torch.device | None" = None, dtype: "torch.dtype | None" = None, mesh: Any = None):
        self.pr = pr
        self.tail = tail
        self.fit_k = fit_k  # NodeResourcesFit's index in cfg.filters, -1 if absent
        self.ureq_all = ureq_all  # [T,R] GCD-scaled requests, tail order
        self.uprio_all = uprio_all  # [T]
        self.pod_reasons = pod_reasons  # per tail pod: unsupported reason or None
        self.n_true = n_true
        self.device = device
        self.dtype = dtype
        # usage committed by earlier windows of this kernel run (scaled)
        self._extra_req = np.zeros_like(pr.base_req)
        self._extra_cnt = np.zeros_like(pr.base_cnt)
        self.kernel_s = 0.0
        self.dispatches = 0
        self.mesh = mesh
        self.sharded_dispatches = 0

    def note_success(self, tail_idx: int, node_id: int) -> None:
        """Record a committed bind from an already-replayed window, so later
        windows' dry runs see its usage."""
        self._extra_req[node_id] += self.ureq_all[tail_idx]
        self._extra_cnt[node_id] += 1

    # ------------------------------------------------------------- decide

    def decide(self, result: Any, off: int, cnt: int) -> "dict[int, Decision | str]":
        """Decisions for every kernel-failed pod of one replay window
        (window-local index -> Decision, or a fallback-reason string for
        pods outside the exactness envelope).  One device dispatch."""
        sel = result.selected
        fails = [j for j in range(cnt) if int(sel[j]) < 0]
        if not fails:
            return {}
        out: dict[int, "Decision | str"] = {}
        batched: list[int] = []
        for j in fails:
            reason = self.pod_reasons[off + j]
            if reason is None:
                narrowed = result._prefilter_node_set(j)
                if narrowed is not None and not narrowed:
                    # the oracle returns BEFORE PostFilter when PreFilter
                    # narrowing excluded every node — only the sequential
                    # cycle reproduces that result shape
                    reason = "prefilter narrowed to zero nodes"
            if reason is not None:
                out[j] = reason
            else:
                batched.append(j)
        if not batched:
            return out
        pr = self.pr
        N = self.n_true
        U = len(batched)
        ucand = np.zeros((U, N), dtype=bool)
        any_cand = False
        for u, j in enumerate(batched):
            ids = result.fit_failed_ids(j)
            if ids.size:
                ucand[u, ids] = True
                any_cand = True
        if not any_cand or pr.V == 0:
            for j in batched:
                out[j] = Decision(None)
            return out
        ureq = self.ureq_all[[off + j for j in batched]]
        uprio = self.uprio_all[[off + j for j in batched]]
        # same-window prefix commits: successes at earlier queue positions
        succ = [j for j in range(cnt) if int(sel[j]) >= 0]
        snode = np.array([int(sel[j]) for j in succ], dtype=np.int32)
        sreq = self.ureq_all[[off + j for j in succ]] if succ else np.zeros((0, ureq.shape[1]), dtype=np.int64)
        smask = np.array(batched, dtype=np.int64)[:, None] > np.array(succ, dtype=np.int64)[None, :]
        smask = smask.reshape(U, len(succ))

        t0 = time.perf_counter()
        masks = PK.run_search(
            pr, ucand, ureq, uprio, smask, sreq, snode, usage=self._extra_req, cnt=self._extra_cnt,
            device=self.device, dtype=self.dtype, mesh=self.mesh,
        )
        self.kernel_s += time.perf_counter() - t0
        self.dispatches += 1
        self.sharded_dispatches += int(self.mesh is not None)

        cand, victims, viol = masks["cand"], masks["victims"], masks["viol"]
        vp = pr.vprio[None, :, :]
        vstart = pr.vstart[None, :, :]
        real = victims  # [U,N,V]
        num_viol = (real & viol).sum(axis=-1)
        nvict = real.sum(axis=-1)
        high_prio = np.max(np.where(real, vp, _I64_MIN), axis=-1)
        sum_prio = np.sum(np.where(real, vp, 0), axis=-1)
        is_high = real & (vp == high_prio[..., None])
        earliest = np.min(np.where(is_high, vstart, _I64_MAX), axis=-1)
        sample_start = result.out["sample_start"]
        for u, j in enumerate(batched):
            ids = np.nonzero(cand[u])[0]
            if ids.size == 0:
                out[j] = Decision(None)
                continue
            # pickOneNodeForPreemption's lexicographic criteria, the least
            # key (num_viol, high_prio, sum_prio, nvict, -earliest, rank) in
            # int64; final tie-break = the oracle's diagnosis-map insertion
            # order, which is the filter loop's rotated visit order (unique
            # per node, so the least key is one node)
            start_u = int(sample_start[j])
            rank = (ids - start_u) % self.n_true
            order = np.lexsort((
                rank, -earliest[u, ids], nvict[u, ids], sum_prio[u, ids], high_prio[u, ids], num_viol[u, ids],
            ))
            best = int(ids[order[0]])
            sl = np.nonzero(victims[u, best])[0]
            vio_row = viol[u, best]
            ordered = [s for s in sl if vio_row[s]] + [s for s in sl if not vio_row[s]]
            out[j] = Decision(pr.node_names[best], [pr.victim_pods[best][int(s)] for s in ordered])
        return out


def prepare_round(
    fw: Any,
    eng: Any,
    snapshot: Any,
    store: Any,
    nodes: list[Obj],
    tail: list[Obj],
    nominated: "list[tuple[Obj, str]] | None" = None,
) -> "tuple[PreemptionRound | None, str | None]":
    """Build the round context, or (None, reason) when the batched search
    can't be exact for this profile × cluster (per-POD gates are softer:
    they fall back pod by pod inside ``decide``).  The search runs on the
    engine's device in the dtype of the engine's current round (float64
    when the round was promoted)."""
    post = [wp.original.name for wp in fw.plugins["post_filter"]]
    if post != ["DefaultPreemption"]:
        return None, f"post-filter plugins {post} have no batch kernel"
    ext = getattr(fw, "extender_service", None)
    if ext is not None and any(e.preempt_verb for e in ext.extenders):
        return None, "preempt-verb extenders configured"
    if snapshot.have_pods_with_required_anti_affinity():
        return None, "pods with required anti-affinity present"

    try:
        pdbs = store.list("poddisruptionbudgets", copy_objects=False)
    except Exception:
        pdbs = []

    # node index space = the kernel run's ``nodes`` order (what the trace
    # planes' ids mean), not snapshot order
    by_name = {ni.name: ni for ni in snapshot.node_infos}
    nis = [by_name.get(nd["metadata"]["name"]) or NodeInfo(nd) for nd in nodes]
    resource_names = PE.fit_resource_axis(tail)
    max_prio = max((pod_priority(p) for p in tail), default=0)
    pr = PE.encode_preemption(nis, resource_names, pdbs, nominated=nominated, max_pending_priority=max_prio)
    T, R = len(tail), len(resource_names)
    res_idx = pr.res_idx
    ureq_all = np.zeros((T, R), dtype=np.int64)
    uprio_all = np.zeros(T, dtype=np.int64)
    reasons: "list[str | None]" = []
    for t, p in enumerate(tail):
        ureq_all[t] = PE._req_vec(p, res_idx)
        uprio_all[t] = pod_priority(p)
        reasons.append(pod_search_gate(p))
    # one GCD per resource column across every array that meets in a
    # compare — device floats stay exact (see ops/encode.py)
    for r in range(R):
        PE.gcd_scale_columns([pr.alloc[:, r], pr.base_req[:, r], pr.vreq[:, :, r], ureq_all[:, r]])
    cfg_filters = eng.cfg.filters
    fit_k = cfg_filters.index("NodeResourcesFit") if "NodeResourcesFit" in cfg_filters else -1
    return (
        PreemptionRound(
            pr, tail, fit_k, ureq_all, uprio_all, reasons, len(nis),
            device=getattr(eng, "device", None),
            dtype=getattr(eng, "round_dtype", None) or getattr(eng, "dtype", None),
            mesh=getattr(eng, "mesh", None),
        ),
        None,
    )
