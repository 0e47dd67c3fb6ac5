"""TPUScorerBridge: serve the batch kernel in extenderv1 wire format.

The JAX package's ``scheduler/scorer_bridge.py`` (BASELINE.json's
TPUBatchScorer deliverable), on the port's kernels: ``filter`` and
``prioritize`` in the scheduler-extender wire format the reference proxies
(reference simulator/scheduler/extender/extender.go: 122-148 —
``ExtenderArgs{pod, nodes, nodenames}`` in, ``ExtenderFilterResult{
nodes/nodenames, failedNodes, failedAndUnresolvableNodes}`` /
``HostPriorityList[{host, score}]`` out), so a REAL kube-scheduler can point
an extender stanza at this endpoint and delegate its Filter/Prioritize work
to the kernel.  The class keeps the reference's name.

Semantics:
- Filter runs the kernelized filter plugins of the CURRENT simulator
  profile over the provided candidate nodes and splits failures into
  ``failedNodes`` vs ``failedAndUnresolvableNodes`` the way the in-tree
  plugins status them (NodeName / NodeAffinity / NodeUnschedulable are
  UnschedulableAndUnresolvable upstream).
- Prioritize returns each node's weighted total (Σ normalized×weight over
  the profile's kernelized score plugins) — the same number the trace
  records as the pod's finalscore sum — as the extender score.  The Go
  side multiplies by the extender's configured weight.
- Workloads the kernel does not cover fall back to the sequential oracle
  plugins (counted in ``fallbacks``), so the endpoint is always exact.

Each kernel pass is one pod over the whole cluster (the scan K2a-f, then
the compaction K3) on the service's device and dtype: the card unless the
service runs on the CPU.  Every node and bound pod of the store enters the
pass, as the oracle's snapshot (and upstream's) holds them, so spread
domains, inter-pod terms and image spread count the cluster; the nodes that
are not candidates are masked out of the scan's feasibility
(``BatchEngine.schedule(node_active=)``), so Filter answers and Prioritize
scores and normalizes over the candidates alone.  The JAX package's bridge
encodes the candidates and their pods only, and its scores differ from its
oracle's where a domain reaches past them.  A kernel or launch error is never answered by the
oracle: Filter reports it in the wire's ``error`` field (the extenderv1
contract), Prioritize raises.

No feasible-node sampling is applied: the calling scheduler has already
chosen which nodes to offer (extenders see post-sampling candidates).
"""

from __future__ import annotations

from typing import Any

import numpy as np


Obj = dict[str, Any]

# Upstream plugins whose Filter failures are UnschedulableAndUnresolvable
# (the calling kube-scheduler's preemption skips those nodes).  Shared
# with the batch engine's diagnosis classification so both bridge paths
# and the batch path agree.
def _is_unresolvable(plugin: str, message: str) -> bool:
    from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import (
        FILTER_MESSAGES,
        UNRESOLVABLE_CODES,
    )

    codes = UNRESOLVABLE_CODES.get(plugin, False)
    if codes is False:
        return False
    if codes is None:  # every failure of this plugin
        return True
    # code-specific plugins: derive the unresolvable MESSAGES from the
    # same tables the batch engine's diagnosis uses, so the two paths
    # cannot diverge when the code set grows
    msgs = FILTER_MESSAGES.get(plugin, {})
    return message in {msgs[c] for c in codes if c in msgs}


class TPUScorerBridge:
    """Serve the current profile's kernels over extenderv1 JSON."""

    def __init__(self, scheduler_service: Any):
        import threading

        self.scheduler_service = scheduler_service
        self._engine: Any = None
        self._engine_fw: Any = None
        # ThreadingHTTPServer serves each request on its own thread; the
        # shared engine (encoder cache, resident planes, counters) is not
        # thread-safe, so kernel passes serialize here
        self._lock = threading.Lock()
        # the card the kernel passes run on, resolved in the constructing
        # thread (None on the CPU)
        self._card: "int | None" = None
        dev = scheduler_service.device
        if dev.type == "cuda":
            import torch

            self._card = dev.index if dev.index is not None else torch.cuda.current_device()
        # Observability (surfaced via /api/v1/metrics)
        self.requests = {"filter": 0, "prioritize": 0}
        self.fallbacks = 0

    # ------------------------------------------------------------ plumbing

    def _framework(self):
        fw = self.scheduler_service.framework
        if fw is None:
            raise RuntimeError("scheduler not started")
        return fw

    def _engine_for(self, fw):
        if self._engine is None or self._engine_fw is not fw:
            from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine

            svc = self.scheduler_service
            eng = BatchEngine.from_framework(fw, trace=True, device=svc.device, dtype=svc.dtype)
            # extenders see post-sampling candidates — score all of them
            eng.percentage_of_nodes_to_score = 100
            self._engine = eng
            self._engine_fw = fw
        return self._engine

    def _nodes_from_args(self, args: Obj) -> "tuple[list[Obj], bool]":
        """Candidate nodes + whether the caller sent full objects
        (node-cache-capable callers send only ``nodenames``)."""
        nodes_obj = args.get("nodes")
        if nodes_obj and nodes_obj.get("items"):
            return list(nodes_obj["items"]), True
        store = self.scheduler_service.cluster_store
        by_name = {n["metadata"]["name"]: n for n in store.list("nodes", copy_objects=False)}
        names = args.get("nodenames") or []
        return [by_name[nm] for nm in names if nm in by_name], False

    def _run(self, pod: Obj, nodes: list[Obj]):
        """One kernel pass of the pod over the cluster with the candidate
        nodes active: (result, node name → the result's node index), or
        None when the profile × workload needs the sequential fallback."""
        with self._lock:
            if self._card is not None:
                import torch

                # a handler thread starts on device 0: launch on the card
                # the service's engines use
                torch.cuda.set_device(self._card)
            fw = self._framework()
            eng = self._engine_for(fw)
            ok, _why = eng.supported([pod], nodes)
            if not ok:
                return None
            store = self.scheduler_service.cluster_store
            # the engine only reads the store's objects, as the service's
            # rounds do: no copies.  A candidate the caller sent as an
            # object stands in for the store's node of its name (the
            # oracle filters the caller's objects); one the store lacks
            # joins the cluster
            cluster = store.list("nodes", copy_objects=False)
            index = {n["metadata"]["name"]: j for j, n in enumerate(cluster)}
            cluster = list(cluster)
            active = np.zeros(len(cluster) + len(nodes), dtype=bool)
            for n in nodes:
                nm = n["metadata"]["name"]
                j = index.get(nm)
                if j is None:
                    j = index[nm] = len(cluster)
                    cluster.append(n)
                else:
                    cluster[j] = n
                active[j] = True
            result = eng.schedule(
                cluster, store.list("pods", copy_objects=False), [pod], store.list("namespaces", copy_objects=False),
                node_active=active[: len(cluster)],
            )
            return result, index

    # --------------------------------------------------------------- verbs

    def filter(self, args: Obj) -> Obj:
        """extenderv1 Filter: split candidates into passed / failed /
        failed-and-unresolvable."""
        self.requests["filter"] += 1
        pod = args.get("pod") or {}
        nodes, full_objects = self._nodes_from_args(args)
        try:
            ran = self._run(pod, nodes)
            if ran is not None:
                result, _index = ran
                from kube_scheduler_simulator_tpu_torch.plugins.resultstore import (
                    PASSED_FILTER_MESSAGE,
                )

                anno = result.filter_annotation(0)
                # candidates narrowed OUT by a NodeAffinity matchFields
                # PreFilter never appear in the annotation — they are
                # unresolvable failures, not passes
                narrowed = result._engine.prefilter_node_names(pod)
                failed: dict[str, str] = {}
                unresolvable: dict[str, str] = {}
                passed: list[Obj] = []
                for n in nodes:
                    nm = n["metadata"]["name"]
                    if narrowed is not None and nm not in narrowed:
                        unresolvable[nm] = "node(s) didn't satisfy plugin(s) prefilter result"
                        continue
                    entry = anno.get(nm) or {}
                    bad = next(
                        ((pl, msg) for pl, msg in entry.items() if msg != PASSED_FILTER_MESSAGE),
                        None,
                    )
                    if bad is None:
                        passed.append(n)
                    elif _is_unresolvable(bad[0], bad[1]):
                        unresolvable[nm] = bad[1]
                    else:
                        failed[nm] = bad[1]
            else:
                self.fallbacks += 1
                passed, failed, unresolvable = self._filter_fallback(pod, nodes)
        except Exception as e:
            return {"nodes": None, "nodenames": None, "failedNodes": None, "error": str(e)}
        out: Obj = {
            "failedNodes": failed,
            "failedAndUnresolvableNodes": unresolvable,
            "error": "",
        }
        if full_objects:
            out["nodes"] = {"items": passed}
            out["nodenames"] = None
        else:
            out["nodes"] = None
            out["nodenames"] = [n["metadata"]["name"] for n in passed]
        return out

    def prioritize(self, args: Obj) -> list[Obj]:
        """extenderv1 Prioritize: HostPriorityList of kernel score totals."""
        self.requests["prioritize"] += 1
        pod = args.get("pod") or {}
        nodes, _full = self._nodes_from_args(args)
        ran = self._run(pod, nodes)
        if ran is not None and "trace" in ran[0].out:
            result, index = ran
            totals = result.totals_map(0)
            feasible = result.feasible_idx(0)
            out = []
            for n in nodes:
                j = index[n["metadata"]["name"]]
                out.append({"host": n["metadata"]["name"], "score": totals.get(j, 0) if j in feasible else 0})
            return out
        self.fallbacks += 1
        return self._prioritize_fallback(pod, nodes)

    # ----------------------------------------------------------- fallbacks

    def _filter_fallback(self, pod: Obj, nodes: list[Obj]):
        """Sequential oracle filters (exact for any workload)."""
        from kube_scheduler_simulator_tpu_torch.models.framework import CycleState
        from kube_scheduler_simulator_tpu_torch.models.nodeinfo import build_node_infos

        fw = self._framework()
        store = self.scheduler_service.cluster_store
        node_infos = build_node_infos(nodes, store.list("pods"))
        state = CycleState()
        self._oracle_pre_filter(fw, state, pod)
        passed, failed, unresolvable = [], {}, {}
        from kube_scheduler_simulator_tpu_torch.models.framework import Code

        for ni in node_infos:
            bad = None
            for wp in fw.plugins["filter"]:
                status = wp.original.filter(state, pod, ni)
                if status is not None and not status.is_success():
                    # the oracle's own status carries the exact
                    # resolvability classification
                    bad = (status.code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE, status.message())
                    break
            if bad is None:
                passed.append(ni.node)
            elif bad[0]:
                unresolvable[ni.name] = bad[1]
            else:
                failed[ni.name] = bad[1]
        return passed, failed, unresolvable

    def _prioritize_fallback(self, pod: Obj, nodes: list[Obj]) -> list[Obj]:
        from kube_scheduler_simulator_tpu_torch.models.framework import CycleState
        from kube_scheduler_simulator_tpu_torch.models.nodeinfo import build_node_infos

        fw = self._framework()
        store = self.scheduler_service.cluster_store
        node_infos = build_node_infos(nodes, store.list("pods"))
        state = CycleState()
        self._oracle_pre_filter(fw, state, pod)
        for wp in fw.plugins["pre_score"]:
            wp.original.pre_score(state, pod, [ni.node for ni in node_infos])
        totals = {ni.name: 0 for ni in node_infos}
        for wp in fw.plugins["score"]:
            raw: dict[str, int] = {}
            for ni in node_infos:
                score, status = wp.original.score(state, pod, ni)
                raw[ni.name] = score if status is None or status.is_success() else 0
            normalizer = getattr(wp.original, "normalize_scores", None)
            if normalizer is not None:
                normalizer(state, pod, raw)
            weight = fw.score_weights.get(wp.original.name, 1)
            for nm, s in raw.items():
                totals[nm] += s * weight
        return [{"host": nm, "score": int(s)} for nm, s in totals.items()]

    @staticmethod
    def _oracle_pre_filter(fw, state, pod: Obj) -> None:
        """PreFilter state the oracle plugins need (snapshot comes from the
        framework handle, matching the in-process cycle)."""
        snap = fw.handle.snapshot()
        if snap is None:
            from kube_scheduler_simulator_tpu_torch.models.snapshot import Snapshot

            store = fw.handle.cluster_store
            snap = Snapshot(
                store.list("nodes"), store.list("pods"), store.list("namespaces")
            )
            fw.handle.set_snapshot(snap)
        for wp in fw.plugins["pre_filter"]:
            wp.original.pre_filter(state, pod)
