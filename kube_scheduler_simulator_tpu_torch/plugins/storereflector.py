"""Store reflector: copies scheduling results onto Pod annotations.

Rebuild of the reference's shared reflector (reference
simulator/scheduler/storereflector/storereflector.go:21-167): it holds N
ResultStores, hooks pod updates, and when a pod finishes a scheduling
attempt merges every store's results into the pod's annotations, appends
the merged map to the ``result-history`` annotation, then deletes the
stores' entries.  The reference needs informer goroutines + conflict-retry;
our store delivers update hooks synchronously, but the retry loop is kept
for the kube-backed adapter.
"""

from __future__ import annotations

import json
from sys import intern
from typing import Any

from kube_scheduler_simulator_tpu_torch.native import fastjson as _fastjson
from kube_scheduler_simulator_tpu_torch.plugins import annotations as anno
from kube_scheduler_simulator_tpu_torch.plugins.resultstore import ResultStore
from kube_scheduler_simulator_tpu_torch.utils.gojson import go_marshal, go_string, go_string_key
from kube_scheduler_simulator_tpu_torch.utils.retry import ConflictError, retry_on_conflict

Obj = dict[str, Any]

RESULT_STORE_KEY = "PluginResultStoreKey"
EXTENDER_STORE_KEY = "ExtenderResultStoreKey"


class StoreReflector:
    def __init__(self) -> None:
        self._stores: dict[str, Any] = {}
        self._in_flush: set[str] = set()
        self._pending: dict[str, Obj] = {}
        # pod key → (length, last-64-chars) of the result-history value
        # this reflector last wrote.  Trust for the byte-splice append
        # requires the CURRENT value to match both: a foreign write (user
        # PUT, import) of even the same length would have to reproduce the
        # exact tail of the last entry to be spliced onto unvalidated.
        # Entries are dropped when the pod is deleted (a recreated pod
        # must not inherit trust for an unrelated annotation value).
        self._history_written: dict[str, tuple[int, str]] = {}

    def add_result_store(self, store: Any, key: str) -> None:
        self._stores[key] = store

    def remove_result_store(self, key: str) -> None:
        """Drop a registered store (scheduler restarts rebuild per-profile
        stores; stale ones must not keep merging results)."""
        self._stores.pop(key, None)

    def get_result_store(self, key: str) -> "Any | None":
        return self._stores.get(key)

    def result_stores(self) -> list[Any]:
        return list(self._stores.values())

    # ------------------------------------------------------------------ hook

    def register_to_cluster_store(self, cluster_store: Any) -> None:
        """ResisterResultSavingToInformer analog (storereflector.go:55-72).

        The reference's informer handler runs asynchronously, after the
        scheduling cycle that triggered the update has finished recording
        (including the Bind result).  We reproduce that ordering by queueing
        the pod here and flushing from ``flush_all`` at cycle end.
        """
        cluster_store.on_update("pods", lambda old, new: self._on_pod_update(new))
        cluster_store.subscribe(["pods"], self._on_pod_event)

    def _on_pod_event(self, ev: Any) -> None:
        if ev.type == "DELETED":
            meta = ev.obj["metadata"]
            key = f"{meta.get('namespace', 'default')}/{meta['name']}"
            self._history_written.pop(key, None)
            self._pending.pop(key, None)

    def _on_pod_update(self, pod: Obj) -> None:
        ns = pod["metadata"].get("namespace", "default")
        name = pod["metadata"]["name"]
        self._pending[f"{ns}/{name}"] = pod

    def flush_all(self, cluster_store: Any, skip_keys: "set[str] | None" = None) -> None:
        """Flush every queued pod's results to its annotations.

        ``skip_keys`` (ns/name) stay queued WITH their stored results —
        pods parked at Permit must keep accumulating until the binding
        cycle finishes, exactly as the reference's reflector only fires on
        pod-update events (which a waiting pod hasn't produced yet)."""
        requeue: dict[str, Obj] = {}
        while self._pending:
            key, pod = self._pending.popitem()
            if skip_keys and key in skip_keys:
                requeue[key] = pod
                continue
            self.flush_pod(cluster_store, pod)
        self._pending.update(requeue)

    # ----------------------------------------------------------------- flush

    def flush_pod(self, cluster_store: Any, pod: Obj) -> None:
        """storeAllResultToPodFunc analog (storereflector.go:78-146).

        The annotation write itself fires another pod-update event; in the
        reference the (async) informer sees it after DeleteData so it
        no-ops, here the synchronous hook needs an explicit reentrancy
        guard plus delete-before-write.
        """
        ns = pod["metadata"].get("namespace", "default")
        name = pod["metadata"]["name"]
        key = f"{ns}/{name}"
        if key in self._in_flush:
            return

        merged: dict[str, str] = {}
        escs: dict[str, str] = {}
        had_any = False
        for store in self._stores.values():
            if not store.has_result(pod):
                continue
            result = store.get_stored_result(pod)
            if result:
                had_any = True
                merged.update(result)
                getter = getattr(store, "get_stored_escs", None)
                if getter is not None:
                    escs.update(getter(pod))
        if not had_any:
            return
        for store in self._stores.values():
            store.delete_data(pod)

        def apply() -> None:
            try:
                fresh = cluster_store.get("pods", name, ns)
            except KeyError:
                return
            annotations = dict(fresh["metadata"].get("annotations") or {})
            annotations.update(merged)
            existing = (fresh["metadata"].get("annotations") or {}).get(anno.RESULT_HISTORY)
            rec = self._history_written.get(key)
            trusted = (
                rec is not None
                and existing is not None
                and rec[0] == len(existing)
                and existing[-64:] == rec[1]
            )
            new_history = _updated_history(existing, merged, trusted=trusted, escs=escs)
            annotations[anno.RESULT_HISTORY] = new_history
            fresh["metadata"]["annotations"] = annotations
            cluster_store.update("pods", fresh, owned=True)
            self._history_written[key] = (len(new_history), new_history[-64:])

        self._in_flush.add(key)
        try:
            retry_on_conflict(apply, sleep=lambda _: None)
        except ConflictError:
            pass
        finally:
            self._in_flush.discard(key)

    def flush_wave(self, cluster_store: Any, pods: "list[Obj]") -> None:
        """``flush_pod`` for a whole commit wave in ONE store transaction.

        Byte-identical to flushing each pod individually — same store
        merge, same history splice, same trust bookkeeping — but the
        wave's annotation patches commit through the store's bulk-apply
        entry point: one lock acquisition and one batched watch-event
        dispatch instead of N get/update round-trips.  Each pod's
        read-modify-write runs atomically under the store lock, so a
        mid-wave conflict (the per-pod path's retry_on_conflict case)
        cannot occur; pods deleted since the kernel decided are skipped,
        exactly as flush_pod's vanished-pod path does."""
        wave: list[Obj] = []
        wave_keys: list[str] = []
        for pod in pods:
            ns = pod["metadata"].get("namespace", "default")
            name = pod["metadata"]["name"]
            # interned: the same pods retry across waves, and the key
            # doubles as the _history_written index — one str object
            # per pod for the store's whole lifetime
            key = intern(f"{ns}/{name}")
            if key in self._in_flush:
                continue
            wave.append(pod)
            wave_keys.append(key)
        if not wave:
            return
        # columnar drain: ONE lock round-trip per result store for the
        # whole wave (get_stored_result + escs + delete_data fused),
        # cells owned by this frame.  Foreign duck-typed stores without
        # the wave API keep the per-pod path, in registration order so
        # later stores still override earlier keys.
        stores = list(self._stores.values())
        cols: list[Any] = [
            drain(wave)
            if (drain := getattr(store, "drain_wave_results", None)) is not None
            else store
            for store in stores
        ]
        muts: list[tuple[str, str, Any]] = []
        keys: list[str] = []
        for i, pod in enumerate(wave):
            ns = pod["metadata"].get("namespace", "default")
            name = pod["metadata"]["name"]
            key = wave_keys[i]
            merged: "dict[str, str] | None" = None
            escs: "dict[str, str] | None" = None
            for col in cols:
                if isinstance(col, list):
                    cell = col[i]
                    if cell is None:
                        continue
                    if merged is None:
                        merged, escs = cell  # owned: adopt without copy
                    else:
                        merged.update(cell[0])
                        escs.update(cell[1])
                elif col.has_result(pod):
                    result = col.get_stored_result(pod)
                    if result:
                        if merged is None:
                            merged, escs = {}, {}
                        merged.update(result)
                        getter = getattr(col, "get_stored_escs", None)
                        if getter is not None:
                            escs.update(getter(pod))
            if merged is None:
                continue
            for col, store in zip(cols, stores):
                if col is store:  # drained cols already popped their data
                    store.delete_data(pod)

            def mutate(cur: Obj, key=key, merged=merged, escs=escs) -> Obj:
                # copy-on-write along the changed path only (bulk_update's
                # read-only contract): everything but metadata/annotations
                # is shared with the replaced object
                meta = cur["metadata"]
                annotations = dict(meta.get("annotations") or {})
                annotations.update(merged)
                existing = (meta.get("annotations") or {}).get(anno.RESULT_HISTORY)
                rec = self._history_written.get(key)
                trusted = (
                    rec is not None
                    and existing is not None
                    and rec[0] == len(existing)
                    and existing[-64:] == rec[1]
                )
                new_history = _updated_history(existing, merged, trusted=trusted, escs=escs)
                annotations[anno.RESULT_HISTORY] = new_history
                self._history_written[key] = (len(new_history), new_history[-64:])
                return {**cur, "metadata": {**meta, "annotations": annotations}}

            muts.append((name, ns, mutate))
            keys.append(key)
        if not muts:
            return
        self._in_flush.update(keys)
        try:
            cluster_store.bulk_update("pods", muts)
        finally:
            self._in_flush.difference_update(keys)


# annotation keys repeat per pod — marshal each key fragment once
_KEY_FRAGS: dict[str, str] = {}


def _entry_parts(new_results: dict[str, str], escs: "dict[str, str] | None" = None):
    """(key fragments, values, escaped twins) for a history entry, in
    go_marshal key order — the ONE place that decides which keys enter
    the entry.  ``escs`` maps annotation keys to pre-escaped bodies (the
    batch engine emits them alongside the plain values; escaping the
    quote-dense megabyte documents at this point would cost more than
    the whole splice)."""
    keys = sorted(k for k in new_results if k != anno.RESULT_HISTORY)
    frags = []
    for k in keys:
        frag = _KEY_FRAGS.get(k)
        if frag is None:
            frag = _KEY_FRAGS[k] = go_string_key(k)
        frags.append(frag)
    vals = [new_results[k] for k in keys]
    esc_list = [escs.get(k) if escs else None for k in keys]
    return frags, vals, esc_list


def _entry_json(new_results: dict[str, str], escs: "dict[str, str] | None" = None) -> str:
    """go_marshal of the history entry, assembled from fragments: the
    entry is a flat map whose VALUES are the (often megabyte) annotation
    bodies just built — the C renderer's one-pass escape (or ``go_string``'s
    replace chain) avoids re-scanning everything through json.dumps, and
    pre-escaped twins (``escs``) embed without any scan at all."""
    frags, vals, esc_list = _entry_parts(new_results, escs)
    if _fastjson is not None:
        try:
            return _fastjson.history_entry(frags, vals, [e if isinstance(e, str) else None for e in esc_list])
        except UnicodeEncodeError:  # lone surrogates: the Python path
            pass
    # deferred (tuple) twins cannot embed here: escape the plain value
    return "{" + ",".join(
        frag + ('"' + e + '"' if isinstance(e, str) else go_string(v))
        for frag, v, e in zip(frags, vals, esc_list)
    ) + "}"


def _updated_history(
    existing: "str | None",
    new_results: dict[str, str],
    trusted: bool = False,
    escs: "dict[str, str] | None" = None,
) -> str:
    """updateResultHistory analog (storereflector.go:148-167): history is a
    JSON array of annotation maps, one per scheduling attempt.

    With ``trusted`` (the reflector wrote this pod's history itself since
    boot and the stored value still carries its exact length + tail), the
    new attempt is SPLICED onto the existing array bytes instead of
    parse-append-re-marshal: prior attempts embed the full (often
    megabyte-scale) annotation set, and re-escaping them on every attempt
    makes history maintenance quadratic.  Splicing is byte-identical
    because the existing string is this function's own compact output.
    Untrusted values (imported snapshots, foreign annotations) are
    parse-validated; corrupt or non-array values reset to a fresh
    single-entry history, as before."""
    if _fastjson is not None and (
        not existing
        or (trusted and (existing == "[]" or (existing.startswith("[{") and existing.endswith("}]"))))
    ):
        # one C buffer builds the splice and the entry together; the
        # megabyte filter and score values embed from the batch engine's
        # deferred twin specs, whose escaped bytes are written here, once,
        # straight into the trail (or from pre-escaped str twins)
        frags, vals, esc_list = _entry_parts(new_results, escs)
        try:
            return _fastjson.history_append2(existing or None, frags, vals, esc_list)
        except UnicodeEncodeError:  # lone surrogates: the Python path
            pass
    entry_json = _entry_json(new_results, escs)
    if existing:
        if trusted:
            if existing == "[]":
                return "[" + entry_json + "]"
            if existing.startswith("[{") and existing.endswith("}]"):
                return existing[:-1] + "," + entry_json + "]"
        try:  # foreign/corrupt annotation: fall back to parse-append
            history = json.loads(existing)
        except json.JSONDecodeError:
            history = []
        if not isinstance(history, list):
            history = []
        if not history:
            return "[" + entry_json + "]"
        # re-marshal the validated prior attempts, splice the new entry
        return go_marshal(history)[:-1] + "," + entry_json + "]"
    return "[" + entry_json + "]"
