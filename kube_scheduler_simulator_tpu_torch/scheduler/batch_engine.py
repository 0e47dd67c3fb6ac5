"""BatchEngine: batch scheduling rounds on the card, with the reference's
annotation contract.

Port of the JAX package's ``scheduler/batch_engine.py``: the per-pod
Filter/Score loop evaluated as one scan kernel over features encoded on the
host (ops/encode.py), the trace compacted on the card, and the per-plugin
annotation trail the reference writes onto pods reproduced byte for byte
from the fetched planes (``BatchResult``).  ``schedule`` runs a round in one
launch; ``schedule_waves`` runs it in pod windows whose carry chains on the
card, double-buffered against the caller's commit of the previous window.
By default the engine is incremental: an ``EncodeCache`` re-encodes only
what changed and a ``DevicePlacer`` keeps the problem's planes on the card,
row-updating them with the scatter kernel.  ``from_framework`` builds the
engine a scheduler profile describes.

Left out of the reference's engine: the mesh, the weight override (the
tuner's traced weights), the streaming ``schedule_async``, the AOT
artifact cache and the process ensemble, and the C renderer of the
annotation documents (``materialize_wave`` returns None; every document
takes the Python paths, which the parity suites pin to the same bytes).

Kernels: upstream's whole default profile, the fifteen filters of
``ops/batch.FILTER_KERNELS`` (NodePorts, VolumeRestrictions, the EBS, GCE
PD and Azure disk limits, NodeVolumeLimits, VolumeBinding and VolumeZone
among them) and the scores NodeResourcesFit (LeastAllocated,
MostAllocated, RequestedToCapacityRatio), NodeResourcesBalancedAllocation,
ImageLocality, TaintToleration, NodeAffinity, PodTopologySpread and
InterPodAffinity.  ``supported()`` names a plugin without a batch kernel
and the workloads the kernels do not model.  Where feasible-node sampling
narrows the nodes, the scan writes the score planes compacted to the
sampled width (``ws0``).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.device import resolve_device, resolve_dtype
from kube_scheduler_simulator_tpu_torch.models.framework import CycleState, Status
from kube_scheduler_simulator_tpu_torch.models.snapshot import has_pending_nomination
from kube_scheduler_simulator_tpu_torch.ops import batch as B
from kube_scheduler_simulator_tpu_torch.ops import encode as E
from kube_scheduler_simulator_tpu_torch.ops.profile import WaveProfiler
from kube_scheduler_simulator_tpu_torch.plugins.intree import interpodaffinity as ip
from kube_scheduler_simulator_tpu_torch.plugins.intree import node_basic as nb
from kube_scheduler_simulator_tpu_torch.plugins.intree import nodeaffinity as na
from kube_scheduler_simulator_tpu_torch.plugins.intree import podtopologyspread as pts
from kube_scheduler_simulator_tpu_torch.plugins.intree import volumes as vol
from kube_scheduler_simulator_tpu_torch.plugins.resultstore import PASSED_FILTER_MESSAGE
from kube_scheduler_simulator_tpu_torch.scheduler.framework_runner import (
    MIN_FEASIBLE_NODES_TO_FIND,
    num_feasible_nodes_to_find,
)
from kube_scheduler_simulator_tpu_torch.utils.gojson import go_marshal, go_string_key

Obj = dict[str, Any]

# the resource kinds the volume kernels resolve on the host
VOLUME_KINDS = ("persistentvolumeclaims", "persistentvolumes", "storageclasses", "csinodes")

# Which kernel filter failures upstream statuses as
# UnschedulableAndUnresolvable (DefaultPreemption skips those nodes); None =
# every failure code of that plugin, else the specific codes.
UNRESOLVABLE_CODES: "dict[str, set | None]" = {
    "NodeName": None,
    "NodeUnschedulable": None,
    "NodeAffinity": None,
    "TaintToleration": None,
    "VolumeBinding": None,
    "VolumeZone": None,
    # code 1 = missing topology label (unresolvable); code 2 = skew
    "PodTopologySpread": {1},
}


def is_unresolvable_failure(plugin: str, code: int) -> bool:
    codes = UNRESOLVABLE_CODES.get(plugin, False)
    if codes is False:
        return False
    return codes is None or code in codes


FILTER_MESSAGES = {
    "NodeUnschedulable": {1: nb.NODE_UNSCHEDULABLE_ERR},
    "NodeName": {1: nb.NODE_NAME_ERR},
    "NodePorts": {1: nb.NODE_PORTS_ERR},
    "NodeAffinity": {1: na.ERR_REASON_ENFORCED, 2: na.ERR_REASON_POD},
    "VolumeBinding": {1: vol.ERR_UNBOUND_IMMEDIATE_PVC, 2: vol.ERR_VOLUME_NODE_CONFLICT},
    "VolumeZone": {1: vol.ERR_VOLUME_ZONE},
    "VolumeRestrictions": {1: vol.ERR_DISK_CONFLICT},
    "EBSLimits": {1: vol.ERR_MAX_VOLUME_COUNT},
    "GCEPDLimits": {1: vol.ERR_MAX_VOLUME_COUNT},
    "AzureDiskLimits": {1: vol.ERR_MAX_VOLUME_COUNT},
    "NodeVolumeLimits": {1: vol.ERR_MAX_VOLUME_COUNT},
    "PodTopologySpread": {1: pts.ERR_REASON_LABEL, 2: pts.ERR_REASON},
    "InterPodAffinity": {1: ip.ERR_EXISTING_ANTI, 2: ip.ERR_AFFINITY, 3: ip.ERR_ANTI_AFFINITY},
}


class BatchResult:
    """Outcome of one batch scheduling pass, with lazy trace formatting.

    The per-node trace arrives COMPACTED to the annotation writer's
    minimal reads: one (first-failing plugin, code) plane over each pod's
    visited window — whose node ids the host re-derives arithmetically from
    (start, processed) — plus feasible node ids and raw/normalized scores
    over the feasible width only.  Score strings are pre-rendered through
    offset LUTs and annotation JSON is assembled from precomputed
    fragments, byte-identical to go_marshal on the equivalent dicts."""

    # the wave-profiler record this round accumulates into
    prof_rec: "dict | None" = None

    def __init__(
        self, engine: "BatchEngine", pending: list[Obj], out: dict, pr: "E.BatchProblem | _WindowProblem",
        nodes: list[Obj], fr_shared: "dict | None" = None,
    ):
        self._engine = engine
        self.pending = pending
        self.out = out
        self.problem = pr
        self.nodes = nodes
        self.selected = np.asarray(out["selected"])  # node index or -1, per pod
        self.feasible_count = np.asarray(out["feasible_count"])
        self.node_names = pr.node_names
        self.pod_keys = pr.pod_keys
        self._lists: "dict | None" = None
        # the windows of one round share a node axis: the O(N) fragment
        # tables are built once per round (schedule_waves passes the dict)
        self._fr_shared = fr_shared

    @property
    def selected_nodes(self) -> "list[str | None]":
        return [self.node_names[s] if s >= 0 else None for s in self.selected]

    @property
    def final_start(self) -> int:
        """next_start_node_index after this round (rotating sample start)."""
        return int(np.asarray(self.out["final_start"]))

    # ------------------------------------------------------------ trace

    def _tr(self) -> dict:
        """Python views of the compact int trace (built once, vectorized)."""
        if self._lists is None:
            tr = self.out["trace"]
            cfg = self._engine.cfg

            def lut_inv(arr: "np.ndarray") -> tuple:
                """[P,WS] ints → (rendered str per DISTINCT value, [P,WS]
                indices into it): each distinct value is formatted once."""
                mn = int(arr.min()) if arr.size else 0
                mx = int(arr.max()) if arr.size else 0
                if mx - mn <= 4096:
                    return [str(v) for v in range(mn, mx + 1)], arr.astype(np.int64) - mn
                uniq, inv = np.unique(arr, return_inverse=True)
                return [str(int(v)) for v in uniq], inv.reshape(arr.shape).astype(np.int64)

            fp = tr.get("fail_plug")
            self._lists = {
                "fail_plug": fp,
                "fail_code": tr.get("fail_code"),
                # [P] bool: any visited node failed any filter
                "fail_any_row": (fp >= 0).any(axis=1) if fp is not None else np.zeros(len(self.pending), bool),
                "sids": tr["sids"],
                # engine.filters position of each kernel filter: the trail
                # records "passed" for every enabled plugin BEFORE the
                # first failure, in profile order
                "fail_pos": [self._engine.filters.index(f) for f in cfg.filters],
                "raw_li": {s: lut_inv(tr["raw"][k]) for k, (s, _w) in enumerate(cfg.scores)},
                "fin_li": {
                    s: lut_inv(tr["norm"][k].astype(np.int32) * int(w)) for k, (s, w) in enumerate(cfg.scores)
                },
                "raw_s": {},
                "final_s": {},
                "msg_memo": {},
            }
            self._lists["passed_entry"] = {p: PASSED_FILTER_MESSAGE for p in self._engine.filters}
        return self._lists

    def _strs_of(self, plugin: str, final: bool = False) -> list:
        """[P][WS] interned score strings for one plugin."""
        tr = self._tr()
        cache = tr["final_s" if final else "raw_s"]
        v = cache.get(plugin)
        if v is None:
            lut, inv = tr["fin_li" if final else "raw_li"][plugin]
            v = cache[plugin] = np.array(lut, dtype=object)[inv].tolist()
        return v

    def _visited_ids(self, i: int) -> "np.ndarray":
        """The nodes pod i's cycle visited, ascending node index — the
        column order of the compact fail planes."""
        proc = int(self.out["sample_processed"][i])
        n_true = self.problem.N_true
        if proc >= n_true:
            return np.arange(n_true, dtype=np.int64)
        ids = self.out["trace"].get("visit_ids")
        if ids is not None:
            return ids[i, :proc]
        start = int(self.out["sample_start"][i])
        return np.sort((start + np.arange(proc, dtype=np.int64)) % n_true)

    def _msg(self, i: int, n: int, plugin: str, code: int) -> str:
        """Memoized failure-message formatting: messages depend only on
        (plugin, code) plus the node's taints (TaintToleration) or the pod's
        resource order (Fit)."""
        memo = self._tr()["msg_memo"]
        if plugin == "TaintToleration":
            key = (plugin, code, n)
        elif plugin == "NodeResourcesFit":
            key = (plugin, code, tuple(self.problem.fit_order[i]))
        else:
            key = (plugin, code, None)
        v = memo.get(key)
        if v is None:
            v = memo[key] = self._engine.filter_message(self, i, n, plugin, code)
        return v

    # ------------------------------------------------- pre-marshaled JSON

    def _fr(self) -> dict:
        """Per-round fragments for direct annotation-JSON assembly: node
        key fragments, the shared all-passed entry's bytes, and sorted
        score-plugin key fragments."""
        tr = self._tr()
        if "frags" not in tr:
            shared = self._fr_shared
            if shared is not None and "frags" in shared:
                tr["frags"] = shared["frags"]
                return tr["frags"]
            names = self.problem.node_names
            key = [go_string_key(nm) for nm in names]
            passed = go_marshal(tr["passed_entry"])
            order_by_name = np.array(sorted(range(len(names)), key=names.__getitem__), dtype=np.int64)
            rank_by_name = np.empty(len(names), dtype=np.int64)
            rank_by_name[order_by_name] = np.arange(len(names))
            tr["frags"] = {
                "key": key,
                "key_arr": np.array(key, dtype=object),
                "splug": [(go_string_key(s) + '"', s) for s in sorted(s for s, _w in self._engine.cfg.scores)],
                # go_marshal key order = sorted node names
                "order_by_name": order_by_name,
                "rank_by_name": rank_by_name,
                "pass_arr": np.array([k + passed for k in key], dtype=object),
            }
            if shared is not None:
                shared["frags"] = tr["frags"]
        return tr["frags"]

    def filter_annotation_json(self, i: int) -> str:
        """go_marshal of pod i's filter-result map (node → plugin →
        "passed"/failure message, first-failure short circuit), assembled
        from fragments."""
        assert self._engine.cfg.trace, "run with trace=True for annotations"
        tr = self._tr()
        fr = self._fr()
        ids = self._visited_ids(i)
        narrowed = self._prefilter_node_set(i)
        n_true = self.problem.N_true
        mask = np.zeros(n_true, dtype=bool)
        mask[ids] = True
        if narrowed is not None:
            nmask = np.zeros(n_true, dtype=bool)
            nmask[list(narrowed)] = True
            mask &= nmask
        order = fr["order_by_name"]
        sel = order[mask[order]]  # visited ids in go_marshal key order
        fp = tr["fail_plug"]
        if fp is None or not tr["fail_any_row"][i]:
            return "{" + ",".join(fr["pass_arr"][sel]) + "}"
        # column of each node in the compact planes (ascending-id order)
        col_of = np.empty(n_true, dtype=np.int64)
        col_of[ids] = np.arange(len(ids))
        cols = col_of[sel]
        fps = fp[i][cols]
        parts = fr["pass_arr"][sel].copy()
        failing = np.nonzero(fps >= 0)[0]
        if failing.size:
            filters = self._engine.filters
            cfg_filters = self._engine.cfg.filters
            fail_pos = tr["fail_pos"]
            key_frag = fr["key"]
            fc_row = tr["fail_code"][i]
            # (first failing plugin, message) fully determines the entry
            entry_memo = tr.setdefault("entry_memo", {})
            for t in failing:
                k = int(fps[t])
                n = int(sel[t])
                plugin = cfg_filters[k]
                msg = self._msg(i, n, plugin, int(fc_row[cols[t]]))
                frag = entry_memo.get((k, msg))
                if frag is None:
                    entry = {p: PASSED_FILTER_MESSAGE for p in filters[: fail_pos[k]]}
                    entry[plugin] = msg
                    frag = entry_memo[(k, msg)] = go_marshal(entry)
                parts[t] = key_frag[n] + frag
        return "{" + ",".join(parts) + "}"

    def filter_annotation_pair(self, i: int, want_esc: bool = True) -> "tuple[str, None]":
        """(annotation, history-escaped twin): the twin is None, as on the
        reference's Python path, and the history writer escapes it."""
        return self.filter_annotation_json(i), None

    def score_annotations_pairs(self, i: int) -> "tuple[tuple[str, None], tuple[str, None]]":
        """((score, None), (finalScore, None)), as ``filter_annotation_pair``."""
        s, f = self.score_annotations_json(i)
        return (s, None), (f, None)

    def materialize_wave(self, js: "list[int]") -> None:
        """The reference renders a whole commit wave's documents in its C
        extension here; the port has no copy of it yet, so every pod takes
        the per-pod builders (None, as the reference without the
        extension)."""
        return None

    def diagnosis(self, i: int) -> dict[str, Status]:
        """Per-node failure Status map (failure messages, PostFilter)."""
        assert self._engine.cfg.trace
        tr = self._tr()
        fp = tr["fail_plug"]
        if fp is None:
            return {}
        ids = self._visited_ids(i)
        narrowed = self._prefilter_node_set(i)
        cfg_filters = self._engine.cfg.filters
        fc = tr["fail_code"][i]
        diag: dict[str, Status] = {}
        for j in np.nonzero(fp[i][: len(ids)] >= 0)[0]:
            n = int(ids[j])
            if narrowed is not None and n not in narrowed:
                continue
            plugin = cfg_filters[int(fp[i][j])]
            code = int(fc[j])
            msg = self._msg(i, n, plugin, code)
            # upstream's UnschedulableAndUnresolvable, which preemption skips
            if is_unresolvable_failure(plugin, code):
                diag[self.problem.node_names[n]] = Status.unresolvable(msg)
            else:
                diag[self.problem.node_names[n]] = Status.unschedulable(msg)
        return diag

    def score_annotations_json(self, i: int) -> "tuple[str, str]":
        """(score, finalScore) annotation JSON over pod i's feasible nodes."""
        assert self._engine.cfg.trace, "run with trace=True for annotations"
        tr = self._tr()
        fr = self._fr()
        sids_row = tr["sids"][i]
        js = np.nonzero(sids_row >= 0)[0]
        if js.size == 0:
            return "{}", "{}"
        ns = sids_row[js]
        order = np.argsort(fr["rank_by_name"][ns], kind="stable")
        js = js[order]
        ns = ns[order]
        keys = fr["key_arr"][ns].tolist()
        splug = fr["splug"]
        frags = [frag for frag, _s in splug]
        raw_rows = [self._strs_of(s)[i] for _f, s in splug]
        fin_rows = [self._strs_of(s, final=True)[i] for _f, s in splug]
        s_parts = []
        f_parts = []
        for kf, j in zip(keys, js.tolist()):
            s_parts.append(kf + "{" + ",".join([frag + row[j] + '"' for frag, row in zip(frags, raw_rows)]) + "}")
            f_parts.append(kf + "{" + ",".join([frag + row[j] + '"' for frag, row in zip(frags, fin_rows)]) + "}")
        return "{" + ",".join(s_parts) + "}", "{" + ",".join(f_parts) + "}"

    def fit_failed_ids(self, i: int) -> "np.ndarray":
        """Visited node ids whose first filter failure was NodeResourcesFit —
        under the preemption engine's workload gates these are exactly the
        non-UnschedulableAndUnresolvable nodes of the diagnosis, i.e.
        DefaultPreemption's candidate set (preemption/engine.py)."""
        tr = self._tr()
        fp = tr["fail_plug"]
        if fp is None or "NodeResourcesFit" not in self._engine.cfg.filters:
            return np.empty(0, dtype=np.int64)
        k = self._engine.cfg.filters.index("NodeResourcesFit")
        ids = self._visited_ids(i)
        cand = np.asarray(ids[fp[i][: len(ids)] == k], dtype=np.int64)
        narrowed = self._prefilter_node_set(i)
        if narrowed is not None and cand.size:
            cand = cand[np.isin(cand, np.fromiter(narrowed, dtype=np.int64))]
        return cand

    def _prefilter_node_set(self, i: int) -> "set[int] | None":
        """Node indices surviving PreFilter narrowing (NodeAffinity
        matchFields pinning restricts which nodes the cycle visits)."""
        narrowed = self._engine.prefilter_node_names(self.pending[i])
        if narrowed is None:
            return None
        idx = {nm: j for j, nm in enumerate(self.problem.node_names)}
        return {idx[nm] for nm in narrowed if nm in idx}


class _WindowProblem:
    """Pod-window view of an encoded BatchProblem: what BatchResult and the
    annotation writers read, with the pod-axis host metadata cut to the
    window and the node-axis metadata shared."""

    __slots__ = ("node_names", "pod_keys", "fit_order", "resource_names", "N_true")

    def __init__(self, pr: "E.BatchProblem", lo: int, hi: int):
        self.node_names = pr.node_names
        self.pod_keys = pr.pod_keys[lo:hi]
        self.fit_order = pr.fit_order[lo:hi]
        self.resource_names = pr.resource_names
        self.N_true = pr.N_true


class BatchEngine:
    """Run-per-snapshot driver for the batch kernels."""

    def __init__(
        self,
        filters: "list[str] | None" = None,
        scores: "list[tuple[str, int]] | None" = None,
        fit_strategy: str = "LeastAllocated",
        fit_resources: "tuple | None" = None,
        fit_shape: "tuple | None" = None,
        percentage_of_nodes_to_score: int = 100,
        trace: bool = False,
        dtype: "torch.dtype | None" = None,
        tie_break: str = "first",
        seed: int = 0,
        device: "str | torch.device | None" = None,
        hard_pod_affinity_weight: int = 1,
        added_affinity: "Obj | None" = None,
    ):
        """``device``: the card unless the caller passes ``"cpu"`` (where the
        plain versions stand in for the kernels); a missing card raises.
        ``dtype``: float32 on the card, float64 on the CPU unless given; a
        round whose scaled resource values would go inexact in it runs in
        float64 (``round_dtype``, ``last_promotion``, and
        ``last_timings["promoted_f64"]``).
        ``hard_pod_affinity_weight``: InterPodAffinity's
        hardPodAffinityWeight argument (upstream default 1);
        ``added_affinity``: NodeAffinity's addedAffinity argument."""
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.device, dtype)
        self.filters = list(filters if filters is not None else B.FILTER_KERNELS)
        self.scores = list(scores if scores is not None else [])
        self.fit_strategy = fit_strategy
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.trace = trace
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.added_affinity = added_affinity
        self.cfg = B.BatchConfig(
            filters=tuple(self.filters),
            scores=tuple((s, w) for s, w in self.scores),
            fit_strategy=fit_strategy,
            fit_resources=tuple(fit_resources) if fit_resources else ((0, 1), (1, 1)),
            fit_shape=tuple(fit_shape) if fit_shape else (),
            trace=trace,
            tie_break=tie_break,
            seed=seed,
        )
        self.encode_cache = E.EncodeCache()
        self._placer = B.DevicePlacer()
        # sticky per-plugin raw fetch dtypes: only widen across rounds
        self._raw_dtypes: dict[int, str] = {}
        self.last_timings: dict[str, float] = {}
        self.cum_timings: dict[str, float] = {}
        # the last round's exactness bound (column, magnitude), its working
        # dtype and, when the bound promoted it to float64, why
        # (ops/batch.exactness_bound, round_dtype)
        self.last_bound: "tuple[str, int]" = ("none", 0)
        self.round_dtype = self.dtype
        self.last_promotion: "str | None" = None
        self.profiler = WaveProfiler()
        # set by from_framework: config aspects the kernels cannot honor,
        # the framework, and the store the volume kinds are listed from
        self._unsupported_config: "str | None" = None
        self._framework: Any = None
        self._store: Any = None

    # ------------------------------------------------------------ factory

    @classmethod
    def from_framework(
        cls, framework: Any, trace: bool = False, dtype: "torch.dtype | None" = None,
        device: "str | torch.device | None" = None,
    ) -> "BatchEngine":
        """Build from a scheduler Framework: the plugin set, weights and
        arguments the sequential path uses."""
        filters = [wp.original.name for wp in framework.plugins["filter"]]
        scores = [
            (wp.original.name, framework.score_weights.get(wp.original.name, 1))
            for wp in framework.plugins["score"]
        ]
        fit_strategy = "LeastAllocated"
        fit_resources = None
        fit_shape = None
        hard_w = 1
        added = None
        unsupported = None
        nz_col = {"cpu": 0, "memory": 1}
        for wp in framework.plugins["filter"] + framework.plugins["score"]:
            o = wp.original
            if o.name == "NodeResourcesFit":
                fit_strategy = getattr(o, "strategy_type", "LeastAllocated")
                res = getattr(o, "score_resources", [("cpu", 1), ("memory", 1)])
                if all(r in nz_col for r, _w in res):
                    fit_resources = tuple((nz_col[r], w) for r, w in res)
                else:
                    unsupported = f"NodeResourcesFit scoringStrategy over {[r for r, _ in res]}"
                if fit_strategy == "RequestedToCapacityRatio":
                    fit_shape = tuple(getattr(o, "rtcr_shape", ()) or ())
            elif o.name == "NodeResourcesBalancedAllocation":
                res = getattr(o, "resources", ["cpu", "memory"])
                if sorted(res) != ["cpu", "memory"]:
                    unsupported = f"NodeResourcesBalancedAllocation over {res}"
            elif o.name == "InterPodAffinity":
                hard_w = getattr(o, "hard_pod_affinity_weight", 1)
            elif o.name == "NodeAffinity":
                added = getattr(o, "added_affinity", None)
        # the batch pass replays the default cycle around the kernels:
        # PrioritySort queue, DefaultBinder, reserve/preBind limited to
        # VolumeBinding (plus Coscheduling's no-op Reserve), and no permit
        # plugin but the Coscheduling gang oracle, whose decisions the gang
        # round (gang/engine.py) parks and releases; any other permit plugin
        # keeps the round sequential
        point_names = {
            p: [wp.original.name for wp in framework.plugins[p]]
            for p in ("reserve", "permit", "pre_bind", "bind")
        }
        if point_names["permit"] and point_names["permit"] != ["Coscheduling"]:
            unsupported = unsupported or f"permit plugins {point_names['permit']}"
        if point_names["bind"] != ["DefaultBinder"]:
            unsupported = unsupported or f"bind plugins {point_names['bind']}"
        if not set(point_names["reserve"]) <= {"VolumeBinding", "Coscheduling"}:
            unsupported = unsupported or f"reserve plugins {point_names['reserve']}"
        if not set(point_names["pre_bind"]) <= {"VolumeBinding"}:
            unsupported = unsupported or f"preBind plugins {point_names['pre_bind']}"
        ext = getattr(framework, "extender_service", None)
        if ext is not None and ext.extenders:
            unsupported = unsupported or "extender webhooks configured"
        eng = cls(
            filters=filters,
            scores=scores,
            fit_strategy=fit_strategy,
            fit_resources=fit_resources,
            fit_shape=fit_shape,
            hard_pod_affinity_weight=hard_w,
            added_affinity=added,
            percentage_of_nodes_to_score=framework.percentage_of_nodes_to_score,
            trace=trace,
            dtype=dtype,
            tie_break=framework.tie_break,
            seed=framework.seed,
            device=device,
        )
        eng._unsupported_config = unsupported
        eng._framework = framework
        eng._store = getattr(framework.handle, "cluster_store", None)
        return eng

    def _volumes(self) -> "dict[str, list[Obj]]":
        """The volume resource kinds for encode() (empty without a store)."""
        if self._store is None:
            return {}
        return {k: self._store.list(k, copy_objects=False) for k in VOLUME_KINDS}

    # ---------------------------------------------------------- supported

    def supported(
        self, pending: list[Obj], nodes: list[Obj], volumes: "dict[str, list[Obj]] | None" = None
    ) -> "tuple[bool, str]":
        """Can this profile × workload run fully on the port's batch path?
        (False, reason) names what it cannot.  ``volumes``: the volume
        objects ``schedule`` will be given (default: the store's)."""
        if self._unsupported_config:
            return False, self._unsupported_config
        try:
            B.check_slice(self.cfg)
        except ValueError as exc:
            return False, str(exc)
        if not nodes:
            return False, "no nodes in cluster"
        # an unbound pod nominated by an earlier preemption reserves its
        # node for other pods' filter runs — not modeled by the kernel
        if any(has_pending_nomination(p) for p in pending):
            return False, "nominated pods present (preemption in flight)"
        # a PreFilter that narrows the node list while sampling rotates (or
        # from a rotated start) desynchronizes the shared start index from
        # the kernel's all-nodes rotation
        sampling = len(nodes) >= MIN_FEASIBLE_NODES_TO_FIND and self.percentage_of_nodes_to_score < 100
        start = getattr(self._framework, "next_start_node_index", 0)
        if (sampling or start != 0) and any(self.prefilter_node_names(p) is not None for p in pending):
            return False, (
                "PreFilter node narrowing while feasible-node sampling (or a "
                "rotated start index) is active"
            )
        # the encoder's host-port and volume class matrices are capped; the
        # reference also caps distinct CSI/PVC volume ids at 256 (its step
        # reads an [N,V] product), which the port's scan, reading only the
        # pod's own ids, does not need
        distinct_ports: set = set()
        distinct_restr: set = set()
        for p in pending:
            distinct_ports.update(nb._host_ports(p))
            distinct_restr.update(vol.pod_cloud_triples(p))
        if len(distinct_ports) > 128:
            return False, f"{len(distinct_ports)} distinct host ports exceed the batch kernel cap"
        if len(distinct_restr) > 128:
            return False, f"{len(distinct_restr)} distinct conflict volumes exceed the batch kernel cap"
        # a claim that does not exist is VolumeBinding's PreFilter reject of
        # the whole pod, which the kernel does not model
        if "VolumeBinding" in self.filters:
            vols = volumes if volumes is not None else self._volumes()
            claims = {
                (o["metadata"].get("namespace") or "default", o["metadata"]["name"])
                for o in vols.get("persistentvolumeclaims") or []
            }
            for p in pending:
                ns = p["metadata"].get("namespace", "default")
                if any((ns, c) not in claims for c in vol._pod_pvc_names(p)):
                    return False, "pod references a missing PersistentVolumeClaim (PreFilter reject)"
        # the Fit filter's reason bitmask covers at most 30 resource columns
        distinct: set = {"cpu", "memory"}
        for p in pending:
            distinct |= set(E._fit_resources(p))
        if len(distinct) > 30:
            return False, f"{len(distinct)} distinct requested resources exceed the batch kernel's bitmask"
        return True, ""

    # ------------------------------------------------------------- running

    def schedule(
        self,
        nodes: list[Obj],
        all_pods: list[Obj],
        pending: list[Obj],
        namespaces: "list[Obj] | None" = None,
        base_counter: int = 0,
        start_index: int = 0,
        volumes: "dict[str, list[Obj]] | None" = None,
        nominated: "list[tuple[Obj, str]] | None" = None,
    ) -> BatchResult:
        """One batch scheduling pass over ``pending`` (already in queue
        order), in one scan launch.  ``base_counter`` is the framework's
        attempt counter for the round's first pod (keys the reservoir
        tie-break draws); ``start_index`` is the rotating
        next_start_node_index at round start; ``volumes`` the volume kinds
        (default: the store's); ``nominated`` the pending nominations the
        encoder models as filter-only usage."""
        return self._finish_prepped(
            self._prep(nodes, all_pods, pending, namespaces, base_counter, start_index, volumes, nominated)
        )

    def _prep(self, nodes, all_pods, pending, namespaces, base_counter, start_index, volumes, nominated=None) -> dict:
        """Encode (delta through the EncodeCache) + pad + lower the round's
        problem and place it on the device through the DevicePlacer (reuse,
        scatter, or one upload of what changed)."""
        prof = self.profiler
        rec = prof.open()
        t0 = time.perf_counter()
        kw = dict(
            hard_pod_affinity_weight=self.hard_pod_affinity_weight,
            added_affinity=self.added_affinity,
            volumes=volumes if volumes is not None else self._volumes(),
            nominated=nominated,
        )
        pr = E.pad_problem(self.encode_cache.encode(nodes, all_pods, pending, namespaces, **kw))
        t1 = time.perf_counter()
        # a round whose resource values would go inexact in the engine's
        # dtype runs in float64, on the same device and kernels
        self.last_bound = B.exactness_bound(pr)
        self.round_dtype, self.last_promotion = B.round_dtype(self.last_bound, self.dtype)
        host, dims = B.lower_host(pr, self.round_dtype)
        sample_k = num_feasible_nodes_to_find(len(nodes), self.percentage_of_nodes_to_score)
        host.update(
            tb_base=base_counter & B.MASK32,
            sample_k=sample_k,
            start0=start_index % max(len(nodes), 1),
        )
        # in-step score compaction when sampling narrows the nodes: the
        # planes are [P, bucket(sample_k)] instead of [P, N]
        ws0 = B.pick_ws0(self.cfg, dims, sample_k, len(nodes))
        tl = time.perf_counter()
        prof.note(rec, "encode", tl - t0)
        # planes are resident per (dtype, shape): a float64 round never
        # reuses float32 planes, nor the reverse
        dp = self._placer.place(host, (str(self.round_dtype), tuple(sorted(dims.items()))), self.device)
        prof.note(rec, "upload", time.perf_counter() - tl)
        return dict(pr=pr, dp=dp, dims=dims, ws0=ws0, nodes=nodes, pending=pending, t0=t0, t1=t1, prof=rec)

    @staticmethod
    def _packed_out(packed: np.ndarray) -> dict:
        return {
            "selected": packed[0],
            "feasible_count": packed[1],
            "sample_start": packed[2],
            "sample_processed": packed[3],
            "final_start": packed[4, 0] if packed.shape[1] else np.int32(0),
        }

    def _compact_dispatch(self, dims: dict, ws0: "int | None", out_dev: dict, packed: np.ndarray, n_true: int):
        """Pick this round's widths and fetch dtypes from the scan's packed
        outputs and trace meta, and launch the compaction → (blob on the
        device, manifest, raw_dtypes, WS)."""
        cfg = self.cfg
        W = min(dims["N"], E._bucket(max(int(packed[3].max()) if packed.shape[1] else 1, 1)))
        WS = min(dims["N"], E._bucket(max(int(packed[1].max()) if packed.shape[1] else 1, 1)))
        if ws0 is not None:
            WS = min(WS, ws0)  # the in-step planes are [P, ws0]
        mm = out_dev["trace_meta"].cpu().numpy()
        widths = {"int8": 0, "int16": 1, "int32": 2}
        raw_dtypes = []
        for k in range(len(cfg.scores)):
            dt = B.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1]))
            prev = self._raw_dtypes.get(k)
            if prev is not None and widths[prev] > widths[dt]:
                dt = prev
            self._raw_dtypes[k] = dt
            raw_dtypes.append(dt)
        raw_dtypes = tuple(raw_dtypes)
        cfn, manifest = B.build_compact_fn(cfg, dims, W, WS, raw_dtypes, int(mm[-1, 1]), in_step_ws0=ws0)
        return cfn(out_dev, n_true), manifest, raw_dtypes, WS

    def encode_stats(self) -> dict:
        """Incremental-encoder and device-upload counters (the reference's
        keys; the mesh, bank and AOT families are not ported)."""
        s = self.encode_cache.stats_snapshot()
        pl = self._placer
        s["device_bytes_uploaded_total"] = pl.bytes_uploaded
        s["device_plane_reuses_total"] = pl.plane_reuses
        s["device_scatter_updates_total"] = pl.scatter_updates
        return s

    def _note_round(self, timings: dict) -> None:
        self.last_timings = timings
        # rebind, never mutate: a reader may hold the old dict
        self.cum_timings = {
            k: self.cum_timings.get(k, 0.0) + timings.get(k, 0.0) for k in {*self.cum_timings, *timings}
        }

    def schedule_waves(
        self,
        nodes: list[Obj],
        all_pods: list[Obj],
        pending: list[Obj],
        namespaces: "list[Obj] | None" = None,
        base_counter: int = 0,
        start_index: int = 0,
        volumes: "dict[str, list[Obj]] | None" = None,
        nominated: "list[tuple[Obj, str]] | None" = None,
        wave_pods: int = 512,
    ):
        """Pipelined round: yields (BatchResult, offset, count) per pod
        WINDOW, double-buffering the scan against the caller's commit.

        The round encodes once; the scan then runs in windows of about
        ``wave_pods`` pods (the largest power-of-two split of the padded
        pod axis that keeps windows at least that wide) whose carry chains
        on the device, equal to one launch over every pod.  Per window c:
        fetch its packed outputs (blocks on scan c), launch its compaction,
        enqueue the blob's copy into pinned host memory and record an
        event, launch scan c+1, and only then wait on the event, so while
        the caller commits window c on the host, scan c+1 runs on the card
        (on one stream, a plain fetch after scan c+1 would wait for it).
        Trace rounds only; callers consume the windows in order, and stop
        on a restart (the remaining device work is dropped)."""
        assert self.trace, "pipelined rounds are trace rounds"
        ctx = self._prep(nodes, all_pods, pending, namespaces, base_counter, start_index, volumes, nominated)
        pr, dims, ws0 = ctx["pr"], ctx["dims"], ctx["ws0"]
        P = dims["P"]
        pend_n = len(pending)
        S = 1
        while P % (S * 2) == 0 and P // (S * 2) >= max(int(wave_pods), 1):
            S *= 2
        Wp = P // S
        if S == 1 or pend_n <= Wp // 2:
            # too small to split: the one-launch path
            yield self._finish_prepped(ctx), 0, pend_n
            return
        wdims = dict(dims, P=Wp)
        t2 = time.perf_counter()
        fnw = B.build_batch_fn(self.cfg, dims, ws0=ws0, window=Wp)
        dp = ctx.pop("dp")
        n_windows = (min(pend_n, P) + Wp - 1) // Wp
        dev_wait = 0.0
        est_scan = None
        fr_shared: dict = {}  # one O(N) fragment build per round
        prof, rec = self.profiler, ctx["prof"]
        try:
            ys = fnw(None, dp, 0)
            prof.note(rec, "dispatch", time.perf_counter() - t2)
            for c in range(n_windows):
                offset = c * Wp
                tw = time.perf_counter()
                packed = ys["packed_pod"].cpu().numpy()  # blocks on window c's scan
                wait = time.perf_counter() - tw
                dev_wait += wait
                prof.note(rec, "device_blocked", wait)
                if est_scan is None:
                    est_scan = wait  # the first window overlaps nothing
                out = self._packed_out(packed)
                tw = time.perf_counter()
                blob, manifest, raw_dtypes, WS = self._compact_dispatch(wdims, ws0, ys, packed, pr.N_true)
                host_blob, ready = _fetch_async(blob)
                # double buffer: the next window's scan queues behind this
                # window's compaction and blob copy, ahead of the host commit
                if c + 1 < n_windows:
                    ys = fnw(ys["final_carry"], dp, offset + Wp)
                prof.note(rec, "dispatch", time.perf_counter() - tw)
                tw = time.perf_counter()
                if ready is not None:
                    ready.synchronize()
                dev_wait += time.perf_counter() - tw
                fetched = B.unpack_compact_blob(host_blob.numpy(), manifest)
                cnt = min(Wp, pend_n - offset)
                out["trace"] = B.reconstruct_trace(
                    self.cfg, fetched, out["sample_start"], out["sample_processed"],
                    pr.N_true, out["feasible_count"], raw_dtypes, cnt, WS,
                )
                prof.note(rec, "trace_fetch", time.perf_counter() - tw)
                result = BatchResult(
                    self, pending[offset : offset + cnt], out, _WindowProblem(pr, offset, offset + cnt), nodes,
                    fr_shared=fr_shared,
                )
                # the windows of a round share one wave record; the commit
                # path re-closes it per window
                result.prof_rec = rec
                yield result, offset, cnt
        finally:
            t3 = time.perf_counter()
            self._note_round(
                {
                    "encode_s": ctx["t1"] - ctx["t0"],
                    "promoted_f64": float(self.last_promotion is not None),
                    "lower_s": t2 - ctx["t1"],
                    # blocked device wait: the device time the host paid
                    "device_s": dev_wait,
                    # estimated device busy: the first (unoverlapped)
                    # window's latency times the window count
                    "device_est_s": (est_scan or 0.0) * n_windows,
                    "total_s": t3 - ctx["t0"],
                    "windows": float(n_windows),
                }
            )

    def _finish_prepped(self, ctx: dict) -> BatchResult:
        """Run a prepped round in one scan launch."""
        pr, dp, dims = ctx["pr"], ctx["dp"], ctx["dims"]
        prof, rec = self.profiler, ctx["prof"]
        t2 = time.perf_counter()
        out_dev = B.build_batch_fn(self.cfg, dims, ws0=ctx["ws0"])(dp)
        td = time.perf_counter()
        prof.note(rec, "dispatch", td - t2)
        packed = out_dev["packed_pod"].cpu().numpy()
        out = self._packed_out(packed)
        if not packed.shape[1]:
            out["final_start"] = np.int32(dp.start0)
        tb = time.perf_counter()
        prof.note(rec, "device_blocked", tb - td)
        if self.trace:
            blob, manifest, raw_dtypes, WS = self._compact_dispatch(dims, ctx["ws0"], out_dev, packed, pr.N_true)
            fetched = B.unpack_compact_blob(blob.cpu().numpy(), manifest)
            out["trace"] = B.reconstruct_trace(
                self.cfg, fetched, out["sample_start"], out["sample_processed"],
                pr.N_true, out["feasible_count"], raw_dtypes, len(ctx["pending"]), WS,
            )
            prof.note(rec, "trace_fetch", time.perf_counter() - tb)
        t3 = time.perf_counter()
        self._note_round(
            {
                "encode_s": ctx["t1"] - ctx["t0"],
                "promoted_f64": float(self.last_promotion is not None),
                "lower_s": t2 - ctx["t1"],
                "device_s": t3 - t2,
                "total_s": t3 - ctx["t0"],
            }
        )
        prof.close(rec, pods=len(ctx["pending"]))
        res = BatchResult(self, ctx["pending"], out, pr, ctx["nodes"])
        res.prof_rec = rec
        return res

    # ----------------------------------------------------- trace helpers

    def filter_message(self, result: BatchResult, i: int, n: int, plugin: str, code: int) -> str:
        if plugin == "TaintToleration":
            node = result.nodes[n]
            taints = (node.get("spec") or {}).get("taints") or []
            t = taints[code - 1] if 0 <= code - 1 < len(taints) else {}
            return f"node(s) had untolerated taint {{{t.get('key', '')}: {t.get('value', '')}}}"
        if plugin == "NodeResourcesFit":
            reasons = []
            if code & 1:
                reasons.append("Too many pods")
            # pod-manifest resource order, matching the oracle's req.items()
            for r in result.problem.fit_order[i]:
                if code & (1 << (r + 1)):
                    reasons.append(f"Insufficient {result.problem.resource_names[r]}")
            return ", ".join(reasons)
        return FILTER_MESSAGES.get(plugin, {}).get(code, f"failed ({plugin} code {code})")

    def prefilter_node_names(self, pod: Obj) -> "set[str] | None":
        """NodeAffinity's matchFields metadata.name pinning (the only
        node-narrowing PreFilter among the kernelized plugins)."""
        if "NodeAffinity" not in self.filters:
            return None
        # pre_filter only inspects the pod's own required terms
        result, _status = na.NodeAffinity(None).pre_filter(CycleState(), pod)
        return None if result is None else result.node_names


def _fetch_async(t: torch.Tensor) -> "tuple[torch.Tensor, torch.cuda.Event | None]":
    """(host tensor, event): on the card, a copy into pinned host memory
    enqueued on the current stream with an event recorded after it, so
    waiting on the event waits for this copy and what came before it, not
    for kernels launched later; on the CPU the tensor itself and None."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev
