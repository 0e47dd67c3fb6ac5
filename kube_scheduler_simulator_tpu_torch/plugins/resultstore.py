"""Per-pod scheduling-result store → annotation formatter.

Python rebuild of the reference's result store (reference
simulator/scheduler/plugin/resultstore/store.go): holds every plugin's
filter/score/... outcome per pod and serializes each category to the exact
annotation JSON the Go golden tests pin (Go json.Marshal: compact, sorted
keys; scores as decimal strings; weights applied to normalized scores).

Thread-safe like the original (one mutex), though the batch path fills
it from whole result tensors in one call per pod instead of per
(pod, node, plugin) callback — that per-call mutex was the reference's
known hot-loop bottleneck (SURVEY.md section 6 cost shape).
"""

from __future__ import annotations

import threading
import time
from typing import Any

from kube_scheduler_simulator_tpu_torch.plugins import annotations as anno
from kube_scheduler_simulator_tpu_torch.utils.gojson import RawJSON, go_marshal

# Small flat result maps (plugin → status) repeat identically across
# thousands of pods in a batch round — marshal each distinct map once.
_MARSHAL_MEMO: dict = {}


def _pre_or_marshal(v: Any) -> str:
    """Filter/score/finalScore values: ``add_batch_results`` stores the
    pre-marshaled annotation document as a plain ``str`` or a
    ``(plain, history_escaped)`` pair (megabyte-scale; a marker-subclass
    wrapper would copy it), the sequential wrapped-plugin path stores
    dicts that marshal here."""
    if isinstance(v, tuple):
        return v[0]
    return v if isinstance(v, str) else go_marshal(v)


def _memo_marshal(d: Any) -> str:
    if isinstance(d, RawJSON):
        return d
    if isinstance(d, dict) and len(d) <= 32:
        try:
            # value types are part of the key: 1, True and 1.0 compare
            # equal but marshal differently
            key = tuple((k, v.__class__, v) for k, v in sorted(d.items()))
            v = _MARSHAL_MEMO.get(key)
        except TypeError:
            return go_marshal(d)  # non-hashable values (nested maps)
        if v is None:
            if len(_MARSHAL_MEMO) > 4096:
                _MARSHAL_MEMO.clear()
            v = _MARSHAL_MEMO[key] = go_marshal(d)
        return v
    return go_marshal(d)

Obj = dict[str, Any]

PASSED_FILTER_MESSAGE = "passed"
SUCCESS_MESSAGE = "success"
WAIT_MESSAGE = "wait"
POST_FILTER_NOMINATED_MESSAGE = "preemption victim"


def _merge_categories(e: dict, categories: dict) -> None:
    """The ONE category-merge rule both batch recorders share (per-pod
    ``add_batch_results`` and wave ``add_wave_results``): dict categories
    merge into the pod's own maps, pre-marshaled strings / pairs /
    scalars replace wholesale.  Callers hold the store mutex."""
    for cat, data in categories.items():
        if cat not in e:
            raise KeyError(f"unknown result category {cat!r}")
        if isinstance(e[cat], dict) and isinstance(data, dict):
            e[cat].update(data)
        else:
            # RawJSON (pre-marshaled), pair, or scalar: replace wholesale
            e[cat] = data


def _new_result() -> dict[str, Any]:
    return {
        "selectedNode": "",
        "preScore": {},
        "score": {},
        "finalScore": {},
        "preFilterStatus": {},
        "preFilterResult": {},
        "filter": {},
        "postFilter": {},
        "permit": {},
        "permitTimeout": {},
        "reserve": {},
        "prebind": {},
        "bind": {},
        "custom": {},
    }


class ResultStore:
    """Mirror of the reference Store (store.go:19-24) keyed by ns/pod."""

    def __init__(self, score_plugin_weight: "dict[str, int] | None" = None):
        self._mu = threading.Lock()
        self._results: dict[str, dict[str, Any]] = {}
        self._weights = dict(score_plugin_weight or {})
        # wave-stage profiler hook (ops/profile.py), installed by the
        # service's commit path; add_wave_results reports its merge time
        # into the ambient wave record as the "resultstore_s" sub-series
        self.profiler: Any = None

    def set_weights(self, score_plugin_weight: "dict[str, Any]") -> None:
        """Swap the finalScore weighting (the service's plugin-weight
        override path, tuning/) — floats allowed; integral products keep
        the integer path's exact bytes (format_weighted_score)."""
        with self._mu:
            self._weights = dict(score_plugin_weight)

    @staticmethod
    def _key(namespace: str, pod_name: str) -> str:
        return f"{namespace}/{pod_name}"

    def _entry(self, namespace: str, pod_name: str) -> dict[str, Any]:
        k = self._key(namespace, pod_name)
        if k not in self._results:
            self._results[k] = _new_result()
        return self._results[k]

    # ------------------------------------------------------------- recorders

    def add_filter_result(self, namespace: str, pod_name: str, node_name: str, plugin: str, reason: str) -> None:
        with self._mu:
            self._entry(namespace, pod_name)["filter"].setdefault(node_name, {})[plugin] = reason

    def add_post_filter_result(
        self, namespace: str, pod_name: str, nominated_node_name: str, plugin: str, node_names: list[str]
    ) -> None:
        with self._mu:
            e = self._entry(namespace, pod_name)
            for node_name in node_names:
                e["postFilter"].setdefault(node_name, {})
                if node_name == nominated_node_name:
                    e["postFilter"][node_name][plugin] = POST_FILTER_NOMINATED_MESSAGE

    def add_score_result(self, namespace: str, pod_name: str, node_name: str, plugin: str, score: int) -> None:
        with self._mu:
            self._entry(namespace, pod_name)["score"].setdefault(node_name, {})[plugin] = str(int(score))
            self._add_normalized_locked(namespace, pod_name, node_name, plugin, score)

    def add_normalized_score_result(
        self, namespace: str, pod_name: str, node_name: str, plugin: str, normalized_score: int
    ) -> None:
        with self._mu:
            self._add_normalized_locked(namespace, pod_name, node_name, plugin, normalized_score)

    def _add_normalized_locked(
        self, namespace: str, pod_name: str, node_name: str, plugin: str, normalized_score: int
    ) -> None:
        w = self._weights.get(plugin, 0)
        if isinstance(w, float) and not w.is_integer():
            # a tuned (float) weight override: the shared renderer, byte-
            # equal to the integer path whenever the product is integral
            from kube_scheduler_simulator_tpu_torch.tuning.validate import format_weighted_score

            final = format_weighted_score(int(normalized_score), w)
        else:
            final = str(int(normalized_score) * int(w))
        self._entry(namespace, pod_name)["finalScore"].setdefault(node_name, {})[plugin] = final

    def add_pre_filter_result(
        self,
        namespace: str,
        pod_name: str,
        plugin: str,
        reason: str,
        pre_filter_result: "Any | None" = None,
    ) -> None:
        with self._mu:
            e = self._entry(namespace, pod_name)
            e["preFilterStatus"][plugin] = reason
            if pre_filter_result is not None and getattr(pre_filter_result, "node_names", None) is not None:
                e["preFilterResult"][plugin] = sorted(pre_filter_result.node_names)

    def add_pre_score_result(self, namespace: str, pod_name: str, plugin: str, reason: str) -> None:
        with self._mu:
            self._entry(namespace, pod_name)["preScore"][plugin] = reason

    def add_permit_result(
        self, namespace: str, pod_name: str, plugin: str, status: str, timeout_seconds: float
    ) -> None:
        with self._mu:
            e = self._entry(namespace, pod_name)
            e["permit"][plugin] = status
            e["permitTimeout"][plugin] = _go_duration(timeout_seconds)

    def add_selected_node(self, namespace: str, pod_name: str, node_name: str) -> None:
        with self._mu:
            self._entry(namespace, pod_name)["selectedNode"] = node_name

    def add_reserve_result(self, namespace: str, pod_name: str, plugin: str, status: str) -> None:
        with self._mu:
            self._entry(namespace, pod_name)["reserve"][plugin] = status

    def add_bind_result(self, namespace: str, pod_name: str, plugin: str, status: str) -> None:
        with self._mu:
            self._entry(namespace, pod_name)["bind"][plugin] = status

    def add_pre_bind_result(self, namespace: str, pod_name: str, plugin: str, status: str) -> None:
        with self._mu:
            self._entry(namespace, pod_name)["prebind"][plugin] = status

    def add_custom_result(self, namespace: str, pod_name: str, annotation_key: str, result: str) -> None:
        with self._mu:
            self._entry(namespace, pod_name)["custom"][annotation_key] = result

    # -------------------------------------------------------------- batch fill

    def add_batch_results(self, namespace: str, pod_name: str, **categories: dict) -> None:
        """Bulk-merge whole category maps (used by the batch engine to
        avoid per-(node,plugin) lock round-trips).  A value may be a
        pre-marshaled ``str`` or a ``(plain, history_escaped)`` pair —
        the escaped twin rides along so the result-history writer embeds
        it by memcpy instead of re-escaping megabytes of quote-dense
        JSON (see ``get_stored_escs``)."""
        with self._mu:
            _merge_categories(self._entry(namespace, pod_name), categories)

    def add_wave_results(self, entries: "list[tuple[str, str, dict]]") -> None:
        """``add_batch_results`` for a whole commit wave under ONE lock
        acquisition: ``entries`` is [(namespace, pod_name, categories)].
        Category dicts may be SHARED across entries (the per-wave
        prefilter/reserve/bind status maps are identical for every pod)
        — dict categories are merged by ``update`` into each pod's own
        maps, so sharing never aliases mutable state between pods."""
        prof = self.profiler
        t0 = time.perf_counter() if prof is not None else 0.0
        with self._mu:
            for ns, pod_name, categories in entries:
                _merge_categories(self._entry(ns, pod_name), categories)
        if prof is not None:
            prof.note_current("resultstore_s", time.perf_counter() - t0)

    # ------------------------------------------------------------------ read

    @staticmethod
    def _result_locked(e: dict) -> dict[str, str]:
        # annotation keys are the shared ``anno`` constants and the
        # marshal memos return THE SAME str object for category maps
        # shared across a wave's pods — the per-pod dict here is fresh,
        # but everything inside it is interned
        out = {
            anno.PREFILTER_RESULT: _memo_marshal(e["preFilterResult"]),
            anno.PREFILTER_STATUS_RESULT: _memo_marshal(e["preFilterStatus"]),
            anno.FILTER_RESULT: _pre_or_marshal(e["filter"]),
            anno.POSTFILTER_RESULT: _memo_marshal(e["postFilter"]),
            anno.PRESCORE_RESULT: _memo_marshal(e["preScore"]),
            anno.SCORE_RESULT: _pre_or_marshal(e["score"]),
            anno.FINALSCORE_RESULT: _pre_or_marshal(e["finalScore"]),
            anno.RESERVE_RESULT: _memo_marshal(e["reserve"]),
            anno.PERMIT_TIMEOUT_RESULT: _memo_marshal(e["permitTimeout"]),
            anno.PERMIT_STATUS_RESULT: _memo_marshal(e["permit"]),
            anno.PREBIND_RESULT: _memo_marshal(e["prebind"]),
            anno.BIND_RESULT: _memo_marshal(e["bind"]),
        }
        for key, val in e["custom"].items():
            out.setdefault(key, val)
        out[anno.SELECTED_NODE] = e["selectedNode"]
        return out

    @staticmethod
    def _escs_locked(e: dict) -> dict[str, str]:
        out = {}
        for cat, key in (
            ("filter", anno.FILTER_RESULT),
            ("score", anno.SCORE_RESULT),
            ("finalScore", anno.FINALSCORE_RESULT),
        ):
            v = e[cat]
            if isinstance(v, tuple) and v[1] is not None:
                out[key] = v[1]
        return out

    def get_stored_result(self, pod: Obj) -> dict[str, str]:
        """The annotation map (reference GetStoredResult, store.go:133-198)."""
        with self._mu:
            k = self._key(pod["metadata"].get("namespace", "default"), pod["metadata"]["name"])
            e = self._results.get(k)
            return {} if e is None else self._result_locked(e)

    def get_stored_escs(self, pod: Obj) -> dict[str, str]:
        """History-escaped twins for the (pair-form) batch categories of
        this pod, keyed like ``get_stored_result`` — collected by the
        reflector right before the history write."""
        with self._mu:
            k = self._key(pod["metadata"].get("namespace", "default"), pod["metadata"]["name"])
            e = self._results.get(k)
            return {} if e is None else self._escs_locked(e)

    def drain_wave_results(self, pods: "list[Obj]") -> "list[tuple[dict, dict] | None]":
        """Columnar read-and-delete for a whole commit wave under ONE
        lock acquisition: a list aligned with ``pods`` whose cells are
        ``None`` (no results for that pod) or an owned ``(results,
        escs)`` pair — exactly ``get_stored_result`` +
        ``get_stored_escs`` + ``delete_data``, without the four per-pod
        lock round-trips each.  The reflector's wave flush consumes the
        cells in place (built fresh here, never aliased into the
        store)."""
        out: "list[tuple[dict, dict] | None]" = []
        with self._mu:
            for pod in pods:
                k = self._key(
                    pod["metadata"].get("namespace", "default"),
                    pod["metadata"]["name"],
                )
                e = self._results.pop(k, None)
                out.append(
                    None if e is None else (self._result_locked(e), self._escs_locked(e))
                )
        return out

    def has_result(self, pod: Obj) -> bool:
        with self._mu:
            return self._key(pod["metadata"].get("namespace", "default"), pod["metadata"]["name"]) in self._results

    def delete_data(self, pod: Obj) -> None:
        with self._mu:
            self._results.pop(
                self._key(pod["metadata"].get("namespace", "default"), pod["metadata"]["name"]), None
            )


def _go_duration(seconds: float) -> str:
    """Format like Go time.Duration.String() for the common cases."""
    if seconds == 0:
        return "0s"
    ns = int(round(seconds * 1e9))
    if ns < 1000:
        return f"{ns}ns"
    if ns < 10**6:
        us = ns / 1000
        return f"{us:g}µs"
    if ns < 10**9:
        ms = ns / 10**6
        return f"{ms:g}ms"
    out = ""
    total_seconds = ns / 1e9
    hours = int(total_seconds // 3600)
    if hours:
        out += f"{hours}h"
    minutes = int((total_seconds - hours * 3600) // 60)
    if minutes or hours:
        out += f"{minutes}m"
    secs = total_seconds - hours * 3600 - minutes * 60
    out += f"{secs:g}s"
    return out
