"""Scale-up estimation on the batch scan: P pods x G templates in ONE launch.

Port of the JAX package's ``autoscaler/estimator.py``.  The upstream
cluster-autoscaler answers "how many nodes of group g would the pending
pods need" with a per-pod Go loop (binpacking estimator: first-fit over
template copies, re-running the scheduler framework's Filter plugins per
pod x candidate).  Here every group's template is encoded as a block of
synthetic node rows in a single BatchProblem, and the batch scheduling scan
(the exact Filter kernels the real rounds use) runs over a [G, N]
node-activity mask: lane g schedules the whole pending queue onto ONLY its
template block.  On the card that is the lane axis of the hand-written scan
(K8, ``ops/kernels.scan_lanes``: one block a lane); on the CPU its plain
version (``ops/batch.scan_lanes_plain``).  The scan's carry IS the
bin-packing state (resources consume as pods commit), so "nodes needed"
falls out of the final per-node pod counts.

Packing policy: scoring inside the estimate is pinned to
NodeResourcesFit/MostAllocated with tie_break="first" — best-fit-
decreasing-style consolidation onto the fewest template copies
(mirroring the upstream estimator's first-fit, NOT the profile's spread
-style scores, which would fan pods across every empty copy and report
maxSize for every group).  Feasibility is the profile's own filter set,
so a pod that can never pass the group's taints/affinity counts for no
group.

Each dispatch is bounded for exactness as a scheduling round is
(``ops/batch.exactness_bound``): past 2^24 it runs in float64, counted in
``promotions`` by reason; past 2^53 it raises.

Where ``supported()`` refuses the profile x workload combination, the
estimator uses a host-side first-fit over cpu/memory/pods only
(``method="resource-fallback"`` on the estimates).  Unlike the reference,
a kernel or launch error is never caught into that fallback: it
propagates, so ``kernel_errors`` stays 0 (a round's kernel error
propagates the same way).  ``method`` keeps the reference's wire value
``"xla-batch"`` for the lane-kernel path, so action records and events
compare byte for byte between the two packages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.autoscaler import nodegroups as ng
from kube_scheduler_simulator_tpu_torch.ops import batch as B
from kube_scheduler_simulator_tpu_torch.ops import encode as E

Obj = dict[str, Any]


@dataclass
class GroupEstimate:
    group: str
    max_new: int        # headroom: maxSize - current size (capped)
    nodes_needed: int   # template copies the pending pods would occupy
    pods_fit: int       # pending pods that found a home on this group
    waste: float        # mean unused allocatable fraction on the used copies
    priority: int       # spec.priority (the "priority" expander's key)
    method: str         # "xla-batch" (the lane kernel) | "resource-fallback"


class ScaleUpEstimator:
    """One lane-scan estimate per autoscaler pass."""

    def __init__(
        self,
        filters: "list[str] | None" = None,
        hard_pod_affinity_weight: int = 1,
        added_affinity: "Obj | None" = None,
        store: Any = None,
        seed: int = 0,
        mesh: Any = None,
        device: "str | torch.device | None" = None,
        dtype: "torch.dtype | None" = None,
    ):
        """The reference's signature with ``device`` (the card unless the
        caller passes "cpu") and ``dtype`` (float32 on the card, float64 on
        the CPU unless given) in place of ``mesh``, which is refused."""
        from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine

        if mesh not in (None, "auto"):
            raise ValueError("a mesh: the port runs one card; sharding the node axis is not ported yet")
        # Feasibility = the profile's filters; packing = MostAllocated
        # best-fit (see module docstring).  trace off: estimation needs
        # decisions, not annotations.
        self.engine = BatchEngine(
            filters=filters,
            scores=[("NodeResourcesFit", 1)],
            fit_strategy="MostAllocated",
            hard_pod_affinity_weight=hard_pod_affinity_weight,
            added_affinity=added_affinity,
            percentage_of_nodes_to_score=100,
            trace=False,
            tie_break="first",
            seed=seed,
            device=device,
            dtype=dtype,
        )
        self.engine._store = store
        # observability (surfaced through the autoscaler's metrics);
        # compiles counts the distinct lane-scan shapes seen
        self._shapes: set = set()
        self.dispatches = 0
        self.compiles = 0
        self.last_estimate_s = 0.0
        self.cum_estimate_s = 0.0
        self.sharded_dispatches = 0
        self.shard_plane_bytes_per_device = 0
        # kernel errors propagate (module docstring): kept at 0 for the
        # reference's metric keys
        self.kernel_errors = 0
        # the last dispatch's exactness bound (column, magnitude) and the
        # dispatches promoted to float64, by reason
        self.last_bound: "tuple[str, int]" = ("none", 0)
        self.promotions: dict[str, int] = {}

    @classmethod
    def from_framework(
        cls, framework: Any, store: Any = None, mesh: Any = None,
        device: "str | torch.device | None" = None, dtype: "torch.dtype | None" = None,
    ) -> "ScaleUpEstimator":
        filters = [wp.original.name for wp in framework.plugins["filter"]]
        hard_w = 1
        added = None
        for wp in framework.plugins["filter"] + framework.plugins["score"]:
            o = wp.original
            if o.name == "InterPodAffinity":
                hard_w = getattr(o, "hard_pod_affinity_weight", 1)
            elif o.name == "NodeAffinity":
                added = getattr(o, "added_affinity", None)
        return cls(
            filters=filters,
            hard_pod_affinity_weight=hard_w,
            added_affinity=added,
            store=store,
            seed=framework.seed,
            mesh=mesh,
            device=device,
            dtype=dtype,
        )

    # ------------------------------------------------------------- estimate

    def estimate(
        self,
        groups: list[Obj],
        headroom: "dict[str, int]",
        pending: list[Obj],
        namespaces: "list[Obj] | None" = None,
        volumes: "dict[str, list[Obj]] | None" = None,
    ) -> list[GroupEstimate]:
        """Estimate every group's scale-up in one pass.

        ``headroom[name]``: how many template copies the group may still
        add (maxSize - current, possibly capped by the caller) — also the
        size of the group's synthetic node block, bounded by the pending
        pod count (each pod occupies at most one fresh node)."""
        t0 = time.perf_counter()
        blocks: list[tuple[Obj, int, int]] = []  # (group, lo, hi) node-row slices
        synth_nodes: list[Obj] = []
        for g in groups:
            room = min(int(headroom.get(g["metadata"]["name"], 0)), len(pending))
            if room <= 0:
                continue
            lo = len(synth_nodes)
            # estimation indices are block-local; the materializer
            # allocates real names from the store's free indices
            synth_nodes.extend(ng.synthetic_node(g, i) for i in range(room))
            blocks.append((g, lo, len(synth_nodes)))
        if not blocks or not pending:
            self.last_estimate_s = time.perf_counter() - t0
            return []

        ok, _why = self.engine.supported(pending, synth_nodes, volumes=volumes)
        if ok:
            out = self._estimate_kernel(blocks, synth_nodes, pending, namespaces, volumes)
        else:
            out = self._estimate_resources(blocks, pending)
        dt = time.perf_counter() - t0
        self.last_estimate_s = dt
        self.cum_estimate_s += dt
        return out

    # ------------------------------------------------------- kernel path

    def _estimate_kernel(
        self,
        blocks: list[tuple[Obj, int, int]],
        synth_nodes: list[Obj],
        pending: list[Obj],
        namespaces: "list[Obj] | None",
        volumes: "dict[str, list[Obj]] | None",
    ) -> list[GroupEstimate]:
        eng = self.engine
        pr = E.encode(
            synth_nodes,
            [],  # fresh template copies carry no bound pods
            pending,
            namespaces,
            hard_pod_affinity_weight=eng.hard_pod_affinity_weight,
            added_affinity=eng.added_affinity,
            volumes=volumes or {},
        )
        pr = E.pad_problem(pr)
        # a dispatch whose resource values would go inexact in the engine's
        # dtype runs in float64, on the same kernel
        self.last_bound = B.exactness_bound(pr)
        dt, why = B.round_dtype(self.last_bound, eng.dtype)
        if why is not None:
            self.promotions[why] = self.promotions.get(why, 0) + 1
        # lower() takes the full node count and no rotation (sample_k =
        # n_true, start0 = 0): visit order == index order, so
        # tie_break="first" fills the lowest template copy first —
        # deterministic best-fit packing
        dp, dims = B.lower(pr, dtype=dt, device=eng.device)
        cfg = eng.cfg
        G = len(blocks)
        N = dims["N"]
        masks = np.zeros((G, N), dtype=bool)
        for g, (_grp, lo, hi) in enumerate(blocks):
            masks[g, lo:hi] = True

        key = (tuple(sorted(dims.items())), G, dt)
        if key not in self._shapes:
            self._shapes.add(key)
            self.compiles += 1
        # ONE dispatch: G lanes x (P pods x N template rows)
        out = B.build_lanes_fn(cfg, dims)(dp, torch.from_numpy(masks).to(eng.device))
        self.dispatches += 1
        packed = out["packed_pod"].cpu().numpy()                             # [G, 5, P]
        pod_count = out["final_pod_count"].cpu().numpy()                     # [G, N]
        requested = out["final_requested"].cpu().numpy().astype(np.float64)  # [G, N, R]
        alloc = np.asarray(pr.alloc, dtype=np.float64)                       # [N, R]

        estimates: list[GroupEstimate] = []
        P_true = pr.P_true
        for g, (grp, lo, hi) in enumerate(blocks):
            sel = packed[g, 0, :P_true]
            pods_fit = int((sel >= 0).sum())
            used = pod_count[g, lo:hi] > 0
            nodes_needed = int(used.sum())
            waste = 0.0
            if nodes_needed:
                a = alloc[lo:hi][used]
                r = requested[g, lo:hi][used]
                with np.errstate(divide="ignore", invalid="ignore"):
                    frac = np.where(a > 0, (a - r) / np.where(a > 0, a, 1.0), np.nan)
                waste = float(np.nanmean(frac)) if np.isfinite(np.nanmean(frac)) else 0.0
            estimates.append(
                GroupEstimate(
                    group=grp["metadata"]["name"],
                    max_new=hi - lo,
                    nodes_needed=nodes_needed,
                    pods_fit=pods_fit,
                    waste=round(waste, 6),
                    priority=int((grp.get("spec") or {}).get("priority") or 0),
                    method="xla-batch",
                )
            )
        return estimates

    # ----------------------------------------------------- fallback path

    @staticmethod
    def _estimate_resources(
        blocks: list[tuple[Obj, int, int]], pending: list[Obj]
    ) -> list[GroupEstimate]:
        """Host first-fit over cpu/memory/pods only (no label/taint/volume
        semantics) — the mode for workloads ``supported()`` refuses.
        Deterministic: pods in queue order, copies filled lowest index
        first."""
        from kube_scheduler_simulator_tpu_torch.utils.quantity import parse_quantity

        def pod_req(p: Obj) -> "tuple[float, float]":
            cpu = mem = 0.0
            for c in (p.get("spec") or {}).get("containers") or []:
                reqs = ((c.get("resources") or {}).get("requests")) or {}
                cpu += float(parse_quantity(reqs.get("cpu", 0)))
                mem += float(parse_quantity(reqs.get("memory", 0)))
            return cpu, mem

        reqs = [pod_req(p) for p in pending]
        estimates: list[GroupEstimate] = []
        for grp, lo, hi in blocks:
            alloc = ((grp.get("spec") or {}).get("template") or {}).get("status", {}).get(
                "allocatable", {}
            )
            cap_cpu = float(parse_quantity(alloc.get("cpu", 0)))
            cap_mem = float(parse_quantity(alloc.get("memory", 0)))
            cap_pods = int(float(parse_quantity(alloc.get("pods", 110))))
            room = hi - lo
            nodes: list[list[float]] = []  # [cpu_used, mem_used, pods]
            pods_fit = 0
            for cpu, mem in reqs:
                if cpu > cap_cpu or mem > cap_mem:
                    continue  # can never fit a copy
                placed = False
                for nstate in nodes:
                    if (
                        nstate[0] + cpu <= cap_cpu
                        and nstate[1] + mem <= cap_mem
                        and nstate[2] + 1 <= cap_pods
                    ):
                        nstate[0] += cpu
                        nstate[1] += mem
                        nstate[2] += 1
                        placed = True
                        break
                if not placed and len(nodes) < room:
                    nodes.append([cpu, mem, 1])
                    placed = True
                if placed:
                    pods_fit += 1
            waste = 0.0
            if nodes:
                fracs = []
                for nstate in nodes:
                    f = []
                    if cap_cpu:
                        f.append((cap_cpu - nstate[0]) / cap_cpu)
                    if cap_mem:
                        f.append((cap_mem - nstate[1]) / cap_mem)
                    if f:
                        fracs.append(sum(f) / len(f))
                waste = sum(fracs) / len(fracs) if fracs else 0.0
            estimates.append(
                GroupEstimate(
                    group=grp["metadata"]["name"],
                    max_new=room,
                    nodes_needed=len(nodes),
                    pods_fit=pods_fit,
                    waste=round(waste, 6),
                    priority=int((grp.get("spec") or {}).get("priority") or 0),
                    method="resource-fallback",
                )
            )
        return estimates
