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

A plugin-weight override (``weights=``, ``set_weight_override``; the
service's ``set_plugin_weights``) runs the scan with the override's [S]
vector as its weight argument and renders finalScore through
``format_weighted_score``, with the vector each round was dispatched with.

The annotation documents are assembled by the C renderer
(``native/fastjson.c``) where it loaded: ``materialize_wave`` renders a
commit wave's documents in three calls, the per-pod pair functions render
one pod's from the same tables and hand the history writer deferred escaped
twins.  Without it (``KSS_NO_NATIVE=1``,
no compiler), for lone surrogates and for PreFilter-narrowed node sets the
Python renderer writes the same bytes.

``schedule_async`` dispatches a round without blocking and returns a
``PendingBatch`` (the streaming pipeline's in-flight wave,
scheduler/stream.py): ``decisions()`` fetches the packed per-pod outputs
and launches the compaction with the blob's copy behind an event,
``result()`` waits on that event only.

Left out of the reference's engine: the mesh, the AOT artifact cache and
the process ensemble.

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

from kube_scheduler_simulator_tpu_torch import native
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
from kube_scheduler_simulator_tpu_torch.tuning.validate import format_weighted_score, validate_plugin_weights
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
        nodes: list[Obj], fr_shared: "dict | None" = None, weight_override: Any = "_at_construction",
    ):
        self._engine = engine
        # the weight vector this round was dispatched with (rendering is
        # lazy, so a set_weight_override between dispatch and commit must
        # not reach it); the synchronous paths build the result at
        # dispatch time, where the engine's live value is that vector
        self.weight_override = (
            engine.weight_override
            if isinstance(weight_override, str) and weight_override == "_at_construction"
            else weight_override
        )
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

            def lut_inv(arr: "np.ndarray", fmt=str) -> tuple:
                """[P,WS] ints → (rendered str per DISTINCT value, [P,WS]
                int64 indices into it): each distinct value is formatted
                once, and the C wave path splices values from the LUT by
                index (C-contiguous int64, as the renderer reads them)."""
                mn = int(arr.min()) if arr.size else 0
                mx = int(arr.max()) if arr.size else 0
                if mx - mn <= 4096:
                    return [fmt(v) for v in range(mn, mx + 1)], np.ascontiguousarray(arr.astype(np.int64) - mn)
                uniq, inv = np.unique(arr, return_inverse=True)
                return [fmt(int(v)) for v in uniq], np.ascontiguousarray(inv.reshape(arr.shape).astype(np.int64))

            wov = self.weight_override  # dispatch-time snapshot, not live

            def fin_li_of(k: int, w) -> tuple:
                if wov is None:
                    return lut_inv(tr["norm"][k].astype(np.int32) * int(w))
                wk = float(wov[k])
                return lut_inv(tr["norm"][k].astype(np.int32), fmt=lambda v: format_weighted_score(v, wk))

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
                "taint_k": cfg.filters.index("TaintToleration") if "TaintToleration" in cfg.filters else -1,
                "raw_li": {s: lut_inv(tr["raw"][k]) for k, (s, _w) in enumerate(cfg.scores)},
                "fin_li": {s: fin_li_of(k, w) for k, (s, w) in enumerate(cfg.scores)},
                "raw_s": {},
                "final_s": {},
                "msg_memo": {},
            }
            self._lists["passed_entry"] = {p: PASSED_FILTER_MESSAGE for p in self._engine.filters}
        return self._lists

    def _strs_of(self, plugin: str, final: bool = False) -> list:
        """[P][WS] interned score strings for one plugin (the paths other
        than the C wave path read these)."""
        tr = self._tr()
        cache = tr["final_s" if final else "raw_s"]
        v = cache.get(plugin)
        if v is None:
            lut, inv = tr["fin_li" if final else "raw_li"][plugin]
            v = cache[plugin] = np.array(lut, dtype=object)[inv].tolist()
        return v

    def _wave(self) -> "dict | None":
        """The round's C commit tables, or None where the C wave path
        cannot run (no renderer, lone surrogates): a capsule resolving
        every fragment table once, and one batched name-order argsort of
        the feasible ids, so each document is assembled from resolved
        tables and int64 buffers (native.fastjson ``wave_*``)."""
        tr = self._tr()
        if "wave" in tr:
            return tr["wave"]
        wave = None
        fj = native.fastjson
        fr = self._fr()
        if fj is not None and "pass_esc" in fr:
            try:
                splug = fr["splug"]
                cap = fj.wave_new(
                    fr["pass_list"], fr["pass_esc"], fr["key"], fr["key_esc"], fr["order_i64"],
                    self.problem.N_true, [f for f, _s in splug], fr["splug_esc"],
                    [tr["raw_li"][s][0] for _f, s in splug], [tr["fin_li"][s][0] for _f, s in splug],
                )
                sids = tr["sids"]
                valid = sids >= 0
                rank = fr["rank_by_name"]
                keys = np.where(valid, rank[np.clip(sids, 0, None)], len(rank) + 1)
                sperm = np.ascontiguousarray(np.argsort(keys, axis=1, kind="stable").astype(np.int64))
                wave = {
                    "cap": cap,
                    "ns": np.ascontiguousarray(np.take_along_axis(sids.astype(np.int64), sperm, axis=1)),
                    "perm": sperm,
                    "counts": valid.sum(axis=1),
                    "raw_inv": [tr["raw_li"][s][1] for _f, s in splug],
                    "fin_inv": [tr["fin_li"][s][1] for _f, s in splug],
                }
            except UnicodeEncodeError:
                wave = None
        tr["wave"] = wave
        return wave

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
        score-plugin key fragments; with the C renderer, their escaped
        twins too."""
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
            pass_list = [k + passed for k in key]
            tr["frags"] = {
                "key": key,
                "key_arr": np.array(key, dtype=object),
                "splug": [(go_string_key(s) + '"', s) for s in sorted(s for s, _w in self._engine.cfg.scores)],
                # go_marshal key order = sorted node names
                "order_by_name": order_by_name,
                "rank_by_name": rank_by_name,
                "pass_arr": np.array(pass_list, dtype=object),
            }
            if native.fastjson is not None:
                # the escaped twins of every fragment: the C assembly
                # emits (annotation, history-escaped) pairs from them in
                # one pass, where escaping the quote-dense documents at
                # history-write time costs ~5-10x more.  Lone surrogates
                # (node names UTF-8 cannot encode) keep the round on the
                # Python path.
                try:
                    eb = native.fastjson.escape_body
                    tr["frags"].update(
                        pass_list=pass_list,
                        pass_esc=[eb(p) for p in pass_list],
                        key_esc=[eb(k) for k in key],
                        splug_esc=[eb(f) for f, _s in tr["frags"]["splug"]],
                        order_i64=np.ascontiguousarray(order_by_name, dtype=np.int64),
                    )
                except UnicodeEncodeError:
                    pass
            if shared is not None:
                shared["frags"] = tr["frags"]
        return tr["frags"]

    def filter_annotation_json(self, i: int) -> str:
        """go_marshal of pod i's filter-result map (node → plugin →
        "passed"/failure message, first-failure short circuit), assembled
        from fragments."""
        return self.filter_annotation_pair(i, want_esc=False)[0]

    def filter_annotation_pair(self, i: int, want_esc: bool = True) -> "tuple[str, Any]":
        """(annotation, history-escaped twin or None): the batch commit
        hands the pair to the result store, and the history write embeds
        the twin (a deferred spec the C renderer writes straight into the
        trail) instead of re-escaping a megabyte document.  The wave
        capsule renders it where the C renderer loaded and the pod's node
        set is not PreFilter-narrowed; otherwise the Python renderer, with
        the same bytes."""
        assert self._engine.cfg.trace, "run with trace=True for annotations"
        tr = self._tr()
        fj = native.fastjson
        wave = self._wave() if fj is not None and self._prefilter_node_set(i) is None else None
        if wave is not None:
            try:
                return self._filter_annotation_wave(i, tr, fj, wave, want_esc)
            except UnicodeEncodeError:
                pass  # lone surrogates in a message: the Python path
        return self._filter_annotation_json_py(i, tr, self._fr()), None

    def _fail_tables(self, i: int, tr: dict, fj) -> tuple:
        """(fail_ids, fail_uidx, ftable, etable) of pod i's failing visited
        nodes, (None, None, [], []) where every visited node passed.  One
        entry a distinct (plugin, code), and a node for TaintToleration,
        whose message names the node's taint."""
        fp_all = tr["fail_plug"]
        if fp_all is None or not tr["fail_any_row"][i]:
            return None, None, [], []
        ids = self._visited_ids(i)
        fp = fp_all[i][: len(ids)]
        cols = np.nonzero(fp >= 0)[0]
        fpc = fp[cols].astype(np.int64)
        fcc = tr["fail_code"][i][cols].astype(np.int64)
        idsc = np.ascontiguousarray(ids[cols], dtype=np.int64)
        taint_k = tr["taint_k"]
        extra = np.where(fpc == taint_k, idsc + 1, 0) if taint_k >= 0 else 0
        ucode = (fpc << 40) | (extra << 16) | fcc
        uniq, first, inv = np.unique(ucode, return_index=True, return_inverse=True)
        entry_memo = tr.setdefault("entry_memo_esc", {})
        cfg_filters = self._engine.cfg.filters
        filters = self._engine.filters
        fail_pos = tr["fail_pos"]
        ftable: list = []
        etable: list = []
        for t0, u in zip(first, uniq):
            k = int(u >> 40)
            plugin = cfg_filters[k]
            msg = self._msg(i, int(idsc[t0]), plugin, int(fcc[t0]))
            pair = entry_memo.get((k, msg))
            if pair is None:
                entry = {p: PASSED_FILTER_MESSAGE for p in filters[: fail_pos[k]]}
                entry[plugin] = msg
                frag = go_marshal(entry)
                pair = entry_memo[(k, msg)] = (frag, fj.escape_body(frag))
            ftable.append(pair[0])
            etable.append(pair[1])
        return idsc, np.ascontiguousarray(inv.reshape(-1), dtype=np.int64), ftable, etable

    def _filter_annotation_wave(self, i: int, tr: dict, fj, wave: dict, want_esc: bool) -> "tuple[str, Any]":
        """The filter pair from the wave capsule: one C call; the twin is a
        deferred ``wfilter`` spec."""
        start = int(self.out["sample_start"][i])
        proc = int(self.out["sample_processed"][i])
        fail_ids, fail_uidx, ftable, etable = self._fail_tables(i, tr, fj)
        cap = wave["cap"]
        s = fj.wave_filter_json(cap, start, proc, fail_ids, fail_uidx, ftable)
        if not want_esc:
            return s, None
        return s, ("wfilter", cap, start, proc, fail_ids, fail_uidx, etable)

    def _filter_annotation_json_py(self, i: int, tr: dict, fr: dict) -> str:
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

    def score_annotations_json(self, i: int) -> "tuple[str, str]":
        """(score, finalScore) annotation JSON over pod i's feasible nodes."""
        (s, _se), (f, _fe) = self.score_annotations_pairs(i)
        return s, f

    def score_annotations_pairs(self, i: int) -> "tuple[tuple[str, Any], tuple[str, Any]]":
        """((score, twin), (finalScore, twin)) assembled from fragments:
        from the wave capsule (deferred ``wscore`` twins), else by the
        Python loop (twins None); the same bytes on both paths."""
        assert self._engine.cfg.trace, "run with trace=True for annotations"
        tr = self._tr()
        fr = self._fr()
        fj = native.fastjson
        wave = self._wave() if fj is not None else None
        if wave is not None:
            T = int(wave["counts"][i])
            if T == 0:
                return ("{}", "{}"), ("{}", "{}")
            cap = wave["cap"]
            ns_row = wave["ns"][i, :T]
            perm_row = wave["perm"][i, :T]
            raw_inv = [inv[i] for inv in wave["raw_inv"]]
            fin_inv = [inv[i] for inv in wave["fin_inv"]]
            try:
                return (
                    (fj.wave_score_json(cap, 0, ns_row, perm_row, raw_inv), ("wscore", cap, 0, ns_row, perm_row, raw_inv)),
                    (fj.wave_score_json(cap, 1, ns_row, perm_row, fin_inv), ("wscore", cap, 1, ns_row, perm_row, fin_inv)),
                )
            except UnicodeEncodeError:
                pass  # lone surrogates: the Python loop below
        sids_row = tr["sids"][i]
        js = np.nonzero(sids_row >= 0)[0]
        if js.size == 0:
            return ("{}", "{}"), ("{}", "{}")
        ns = sids_row[js]
        order = np.argsort(fr["rank_by_name"][ns], kind="stable")
        js = js[order]
        ns = ns[order]
        keys = fr["key_arr"][ns].tolist()
        perm = js.tolist()
        splug = fr["splug"]
        frags = [frag for frag, _s in splug]
        raw_rows = [self._strs_of(s)[i] for _f, s in splug]
        fin_rows = [self._strs_of(s, final=True)[i] for _f, s in splug]
        s_parts = []
        f_parts = []
        for kf, j in zip(keys, perm):
            s_parts.append(kf + "{" + ",".join([frag + row[j] + '"' for frag, row in zip(frags, raw_rows)]) + "}")
            f_parts.append(kf + "{" + ",".join([frag + row[j] + '"' for frag, row in zip(frags, fin_rows)]) + "}")
        return ("{" + ",".join(s_parts) + "}", None), ("{" + ",".join(f_parts) + "}", None)

    def materialize_wave(self, js: "list[int]") -> "dict[int, dict] | None":
        """A whole commit wave's annotation documents in three C calls: one
        ``wave_filter_many`` for every pod's filter document, two
        ``wave_score_many`` (score, finalScore) for the pods that score.
        Returns ``{j: {"filter": pair, "score": pair, "finalScore": pair}}``
        (score and finalScore only where ``feasible_count[j] > 1``); a pod
        whose node set PreFilter narrows is left out, and the caller
        renders it with the per-pod functions.  None where the C wave path
        cannot run at all (no renderer, lone surrogates): every pod then
        takes the per-pod functions, with the same bytes."""
        fj = native.fastjson
        if fj is None:
            return None
        wave = self._wave()
        if wave is None:
            return None
        tr = self._tr()
        try:
            render = [j for j in js if self._prefilter_node_set(j) is None]
            if not render:
                return {}
            cap = wave["cap"]
            starts_m = np.ascontiguousarray(np.asarray(self.out["sample_start"], dtype=np.int64)[render])
            procs_m = np.ascontiguousarray(np.asarray(self.out["sample_processed"], dtype=np.int64)[render])
            # every pod's failure entries in one table shared by the wave
            # (the entry memo already shares fragments across pods, so the
            # index hits by identity); the per-pod tables ride along for
            # the deferred escaped twins
            frag_index: dict[str, int] = {}
            ftable: list[str] = []
            frow_l: list = []
            fids_l: list = []
            fuidx_l: list = []
            fail_specs: dict[int, tuple] = {}
            for m, j in enumerate(render):
                ids_j, uidx_j, ft_j, et_j = self._fail_tables(j, tr, fj)
                if ids_j is None:
                    fail_specs[j] = (None, None, [])
                    continue
                rebase = np.empty(len(ft_j), dtype=np.int64)
                for t, frag in enumerate(ft_j):
                    u = frag_index.get(frag)
                    if u is None:
                        u = frag_index[frag] = len(ftable)
                        ftable.append(frag)
                    rebase[t] = u
                frow_l.append(np.full(len(ids_j), m, dtype=np.int64))
                fids_l.append(ids_j)
                fuidx_l.append(rebase[uidx_j])
                fail_specs[j] = (ids_j, uidx_j, et_j)
            if frow_l:
                frow = np.ascontiguousarray(np.concatenate(frow_l))
                fids = np.ascontiguousarray(np.concatenate(fids_l))
                fuidx = np.ascontiguousarray(np.concatenate(fuidx_l))
            else:
                frow = fids = fuidx = None
            filt_docs = fj.wave_filter_many(cap, starts_m, procs_m, frow, fids, fuidx, ftable or None)
            out: dict[int, dict] = {}
            for m, j in enumerate(render):
                ids_j, uidx_j, et_j = fail_specs[j]
                out[j] = {"filter": (filt_docs[m], ("wfilter", cap, int(starts_m[m]), int(procs_m[m]),
                                                    ids_j, uidx_j, et_j))}
            scoring = [j for j in render if int(self.feasible_count[j]) > 1]
            if scoring:
                sjs = np.asarray(scoring, dtype=np.int64)
                cnts = np.ascontiguousarray(np.asarray(wave["counts"], dtype=np.int64)[sjs])
                ns2 = np.ascontiguousarray(wave["ns"][sjs])
                perm2 = np.ascontiguousarray(wave["perm"][sjs])
                raw2 = [np.ascontiguousarray(np.asarray(inv, dtype=np.int64)[sjs]) for inv in wave["raw_inv"]]
                fin2 = [np.ascontiguousarray(np.asarray(inv, dtype=np.int64)[sjs]) for inv in wave["fin_inv"]]
                score_docs = fj.wave_score_many(cap, 0, cnts, ns2, perm2, raw2)
                final_docs = fj.wave_score_many(cap, 1, cnts, ns2, perm2, fin2)
                for m2, j in enumerate(scoring):
                    T = int(cnts[m2])
                    if T == 0:
                        out[j]["score"] = ("{}", "{}")
                        out[j]["finalScore"] = ("{}", "{}")
                        continue
                    ns_row = ns2[m2, :T]
                    perm_row = perm2[m2, :T]
                    out[j]["score"] = (score_docs[m2], ("wscore", cap, 0, ns_row, perm_row, [r[m2] for r in raw2]))
                    out[j]["finalScore"] = (final_docs[m2], ("wscore", cap, 1, ns_row, perm_row, [r[m2] for r in fin2]))
            return out
        except UnicodeEncodeError:
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
        weights: Any = None,
    ):
        """``device``: the card unless the caller passes ``"cpu"`` (where the
        plain versions stand in for the kernels); a missing card raises.
        ``dtype``: float32 on the card, float64 on the CPU unless given; a
        round whose scaled resource values would go inexact in it runs in
        float64 (``round_dtype``, ``last_promotion``, and
        ``last_timings["promoted_f64"]``).
        ``hard_pod_affinity_weight``: InterPodAffinity's
        hardPodAffinityWeight argument (upstream default 1);
        ``added_affinity``: NodeAffinity's addedAffinity argument.
        ``weights``: a plugin-weight override for the score pass (a vector in
        the profile's score order or a name → weight mapping), validated
        here (WeightValidationError); the scan then takes it as its weight
        argument and finalScore renders through ``format_weighted_score``.
        None keeps the profile's weights and bytes."""
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.device, dtype)
        self.filters = list(filters if filters is not None else B.FILTER_KERNELS)
        self.scores = list(scores if scores is not None else [])
        self.fit_strategy = fit_strategy
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.trace = trace
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.added_affinity = added_affinity
        self.weight_override: "np.ndarray | None" = None
        if weights is not None:
            self.weight_override = validate_plugin_weights(
                weights, [s for s, _w in self.scores], defaults=dict(self.scores)
            )
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
        # a service-level weight override (SchedulerService(weights=),
        # set_plugin_weights) rides on the framework
        override = getattr(framework, "score_weight_override", None)
        weights = [float(override.get(s, w)) for s, w in scores] if override else None
        eng = cls(
            filters=filters,
            scores=scores,
            weights=weights,
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

    def set_weight_override(self, override: "dict[str, float] | None") -> None:
        """Swap the engine's weight vector (None: back to the profile's)
        without rebuilding it: the next round's scan takes the new vector.
        Validated as the constructor's."""
        if override is None:
            self.weight_override = None
            return
        weights = [float(override.get(s, w)) for s, w in self.scores]
        self.weight_override = validate_plugin_weights(
            weights, [s for s, _w in self.scores], defaults=dict(self.scores)
        )

    def _round_weights(self, dt: torch.dtype) -> torch.Tensor:
        """The [S] weight row a round's scan takes, in its dtype on the
        engine's device: the override's, else the profile's."""
        w = self.weight_override if self.weight_override is not None else [w for _s, w in self.scores]
        return B.weight_row(w, dt, self.device)

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

    def _prep(
        self, nodes, all_pods, pending, namespaces, base_counter, start_index, volumes, nominated=None,
        prof_rec: "dict | None" = None,
    ) -> dict:
        """Encode (delta through the EncodeCache) + pad + lower the round's
        problem and place it on the device through the DevicePlacer (reuse,
        scatter, or one upload of what changed).  ``prof_rec``: an
        already-open wave-profiler record (the stream session opens one
        before its admission work); None opens a fresh one here."""
        prof = self.profiler
        rec = prof_rec if prof_rec is not None else prof.open()
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
        return dict(
            pr=pr, dp=dp, dims=dims, ws0=ws0, nodes=nodes, pending=pending, t0=t0, t1=t1, prof=rec,
            weights=self._round_weights(self.round_dtype), weight_override=self.weight_override,
        )

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
        fnw = B.build_batch_fn(self.cfg, dims, ws0=ws0, window=Wp, weights=ctx["weights"])
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
                    fr_shared=fr_shared, weight_override=ctx["weight_override"],
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
        out_dev = B.build_batch_fn(self.cfg, dims, ws0=ctx["ws0"], weights=ctx["weights"])(dp)
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
        res = BatchResult(self, ctx["pending"], out, pr, ctx["nodes"], weight_override=ctx["weight_override"])
        res.prof_rec = rec
        return res

    def schedule_async(
        self,
        nodes: list[Obj],
        all_pods: list[Obj],
        pending: list[Obj],
        namespaces: "list[Obj] | None" = None,
        base_counter: int = 0,
        start_index: int = 0,
        volumes: "dict[str, list[Obj]] | None" = None,
        nominated: "list[tuple[Obj, str]] | None" = None,
        prof_rec: "dict | None" = None,
    ) -> "PendingBatch":
        """Dispatch one round in one scan launch WITHOUT blocking on its
        results: the streaming pipeline's producer (scheduler/stream.py),
        so wave k+1's encode, upload and launch run while wave k's commit
        forms on the host.  Trace rounds only.  The returned
        ``PendingBatch`` is consumed in two blocking steps: ``decisions()``
        (the packed per-pod outputs; the compaction launched and its blob's
        copy enqueued), then ``result()`` (waits on that copy's event, then
        rebuilds the trace).  No plane ``bank``, unlike the reference: see
        ops/batch.DevicePlacer."""
        assert self.trace, "streamed rounds are trace rounds"
        ctx = self._prep(nodes, all_pods, pending, namespaces, base_counter, start_index, volumes, nominated,
                         prof_rec=prof_rec)
        t2 = time.perf_counter()
        dp = ctx.pop("dp")
        out_dev = B.build_batch_fn(self.cfg, ctx["dims"], ws0=ctx["ws0"], weights=ctx["weights"])(dp)
        self.profiler.note(ctx["prof"], "dispatch", time.perf_counter() - t2)
        return PendingBatch(self, ctx, out_dev, t2, dp.start0)

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


class PendingBatch:
    """One DISPATCHED round whose results have not been fetched: the
    streaming pipeline's in-flight wave (``BatchEngine.schedule_async``).

    Two blocking steps, split so the stream can interleave host and device
    work:

    - ``decisions()`` fetches the scan's packed per-pod outputs (one small
      [5, P] int32 copy: it waits for the scan), launches the trace
      compaction, and enqueues the blob's copy into pinned host memory with
      an event recorded after it.  The caller learns every selection, the
      round's ``final_start`` and the attempt-counter advance before a
      single annotation byte is formatted.
    - ``result()`` waits on THAT EVENT ONLY, rebuilds the compact trace and
      returns the ``BatchResult`` the commit path formats.  The next wave
      is launched between the two calls on the same stream: a plain
      ``blob.cpu()`` here would wait for its scan too, and the overlap
      would silently be zero.

    The device wait the host paid at both points lands in the engine's
    round timings at ``result()`` (``device_s``: blocked wait only)."""

    def __init__(self, engine: BatchEngine, ctx: dict, out_dev: dict, t2: float, start0: int):
        self._eng = engine
        self._ctx = ctx
        self._out_dev: "dict | None" = out_dev
        self._t2 = t2
        self._start0 = start0
        self._dev_wait = 0.0
        self._out: "dict | None" = None
        self._blob: "torch.Tensor | None" = None
        self._host_blob: "torch.Tensor | None" = None
        self._ready: "torch.cuda.Event | None" = None
        self._result: "BatchResult | None" = None
        self.pending: list[Obj] = ctx["pending"]
        # the round's exactness promotion, taken now: the engine's
        # last_promotion belongs to the next wave by the time this commits
        self.promotion: "str | None" = engine.last_promotion

    def decisions(self) -> dict:
        """Packed per-pod outputs (selected, feasible_count, sample_*,
        final_start), blocking on the scan only; the compaction is launched
        and its blob's copy enqueued (not waited for) before returning."""
        if self._out is None:
            assert self._out_dev is not None
            eng, ctx = self._eng, self._ctx
            prof, rec = eng.profiler, ctx["prof"]
            tw = time.perf_counter()
            packed = self._out_dev["packed_pod"].cpu().numpy()  # waits for the scan
            tb = time.perf_counter()
            self._dev_wait += tb - tw
            prof.note(rec, "device_blocked", tb - tw)
            out = eng._packed_out(packed)
            if not packed.shape[1]:
                out["final_start"] = np.int32(self._start0)
            self._blob, self._manifest, self._raw_dtypes, self._WS = eng._compact_dispatch(
                ctx["dims"], ctx["ws0"], self._out_dev, packed, ctx["pr"].N_true
            )
            self._host_blob, self._ready = _fetch_async(self._blob)
            prof.note(rec, "dispatch", time.perf_counter() - tb)
            self._out = out
        return self._out

    @property
    def selected(self) -> "np.ndarray":
        return np.asarray(self.decisions()["selected"])

    @property
    def final_start(self) -> int:
        return int(np.asarray(self.decisions()["final_start"]))

    @property
    def node_names(self) -> list[str]:
        return self._ctx["pr"].node_names

    def result(self) -> BatchResult:
        """Wait for the blob's copy, rebuild the compact trace and build the
        BatchResult (cached); the round's device tensors are dropped."""
        if self._result is None:
            out = dict(self.decisions())
            eng, ctx = self._eng, self._ctx
            tw = time.perf_counter()
            if self._ready is not None:
                self._ready.synchronize()
            self._dev_wait += time.perf_counter() - tw
            fetched = B.unpack_compact_blob(self._host_blob.numpy(), self._manifest)
            out["trace"] = B.reconstruct_trace(
                eng.cfg, fetched, out["sample_start"], out["sample_processed"],
                ctx["pr"].N_true, out["feasible_count"], self._raw_dtypes, len(ctx["pending"]), self._WS,
            )
            t3 = time.perf_counter()
            eng.profiler.note(ctx["prof"], "trace_fetch", t3 - tw)
            eng._note_round(
                {
                    "encode_s": ctx["t1"] - ctx["t0"],
                    "promoted_f64": float(self.promotion is not None),
                    "lower_s": self._t2 - ctx["t1"],
                    # blocked device wait only: device time hidden under
                    # host work never shows up here
                    "device_s": self._dev_wait,
                    "total_s": t3 - ctx["t0"],
                }
            )
            self._result = BatchResult(
                eng, ctx["pending"], out, ctx["pr"], ctx["nodes"], weight_override=ctx["weight_override"],
            )
            self._result.prof_rec = ctx["prof"]
            # release the round's device tensors
            self._out_dev = self._blob = self._host_blob = self._ready = None
        return self._result


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
