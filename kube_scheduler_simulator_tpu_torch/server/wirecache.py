"""Render-once wire-bytes cache: each object's serialized JSON is built
at most once per resourceVersion and shared verbatim across every
consumer — list documents, watch events (initial ADDED sweep, backlog
replay, live fan-out), single-object GETs, and each tenant session's
own plane (the cache hangs off the session's store, so isolation is
structural).

Why: the profiler's ``watch_render`` stage showed the same pod being
``json.dumps``-ed once PER list/watch consumer per mutation — with 256
watch clients (cfg15's fan-out leg) that is 256 identical renders of
identical bytes.  The cache keys on ``(kind, namespace, name)`` and
stores ``(resourceVersion, {(apiVersion, kind): json})`` — an object
serves under more than one groupVersion (e.g. events under core v1 and
events.k8s.io), and each variant renders lazily on first use.

Byte parity is the contract: a cached string must equal
``json.dumps(envelope(obj))`` of the uncached renderer EXACTLY
(tests/test_wirecache.py diffs both paths across mutations, patches,
SSA writes, sessions, and journal recovery).  Renders therefore use the
same default separators and the same ``dict(obj)`` + ``setdefault``
envelope the HTTP layer uses.

Invalidation is belt and braces:

- the LOOKUP compares the entry's resourceVersion against the live
  object's — a stale entry can never be served, even if an explicit
  invalidation were missed (correctness does not depend on hooks);
- the store still invalidates eagerly on every mutation/replay
  (``ClusterStore._emit``, ``replay_object``/``replay_event``,
  ``clear_for_replay``) so deleted objects don't pin bytes and the
  ``wirecache_invalidations_total`` counter means what it says.

DELETED events are rendered but never inserted: their delete-stamped
object has no future readers, and the entry was just purged — caching
it would leak one entry per churned object.

Knobs: ``KSS_WIRECACHE=0`` disables the cache entirely (the serving
layer falls back to the exact pre-cache render path, byte-for-byte);
``KSS_WIRECACHE_MAX`` caps entries (oldest-inserted evicted first).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

Obj = dict[str, Any]


def wirecache_enabled() -> bool:
    return os.environ.get("KSS_WIRECACHE", "1") != "0"


def max_entries_from_env() -> int:
    n = int(os.environ.get("KSS_WIRECACHE_MAX", "65536"))
    if n < 1:
        raise ValueError(f"KSS_WIRECACHE_MAX must be >= 1, got {n}")
    return n


class WireCache:
    """(kind, namespace, name) -> (resourceVersion, {(apiVersion,
    kindName): json_str}).  Thread-safe: HTTP handler threads and the
    scheduling thread share it; renders happen outside the lock (the
    rendered object is frozen by the store's replacement contract, so
    concurrent renders of the same version produce identical bytes)."""

    def __init__(self, max_entries: "int | None" = None, profiler: Any = None):
        self.max_entries = (
            max_entries_from_env() if max_entries is None else max_entries
        )
        # the wave profiler (ops/profile.py): miss renders stamp
        # ``watch_render`` ambiently; None = unprofiled
        self.profiler = profiler
        self._lock = threading.Lock()
        self._map: "dict[tuple, tuple[str, dict]]" = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    # ---------------------------------------------------------- rendering

    def _render(self, obj: Obj, api_version: str, kind_name: str) -> str:
        # EXACTLY the HTTP layer's envelope + json.dumps (default
        # separators, ensure_ascii) — the parity pin depends on it
        t0 = time.perf_counter()
        out = dict(obj)
        out.setdefault("apiVersion", api_version)
        out.setdefault("kind", kind_name)
        s = json.dumps(out)
        prof = self.profiler
        if prof is not None:
            prof.ambient("watch_render", time.perf_counter() - t0)
        return s

    def obj_json(
        self,
        kind: str,
        obj: Obj,
        api_version: str,
        kind_name: str,
        insert: bool = True,
    ) -> str:
        """The object's wire JSON (enveloped), served from cache when the
        entry matches the object's own resourceVersion, else rendered —
        and inserted unless ``insert=False`` (DELETED events)."""
        meta = obj.get("metadata") or {}
        key = (kind, meta.get("namespace"), meta.get("name"))
        rv = meta.get("resourceVersion")
        vkey = (api_version, kind_name)
        with self._lock:
            entry = self._map.get(key)
            if entry is not None and entry[0] == rv:
                s = entry[1].get(vkey)
                if s is not None:
                    self.hits += 1
                    return s
            self.misses += 1
        s = self._render(obj, api_version, kind_name)
        if insert and rv is not None:
            with self._lock:
                entry = self._map.get(key)
                if entry is not None and entry[0] == rv:
                    entry[1][vkey] = s
                elif entry is None or self._newer(rv, entry[0]):
                    # backlog replays render OLDER versions of a live
                    # object — never let one overwrite a newer entry
                    if entry is None and len(self._map) >= self.max_entries:
                        self._map.pop(next(iter(self._map)))
                    self._map[key] = (rv, {vkey: s})
        return s

    @staticmethod
    def _newer(rv: str, cur: "str | None") -> bool:
        try:
            return cur is None or int(rv) >= int(cur)
        except (TypeError, ValueError):
            return True

    def event_line(self, type_: str, obj_json: str) -> bytes:
        """One watch-stream line from already-rendered object bytes —
        byte-identical to ``json.dumps({"type": ..., "object": env})``
        (the type tags are plain ASCII literals)."""
        return ('{"type": "%s", "object": %s}\n' % (type_, obj_json)).encode()

    def list_doc(
        self,
        list_kind: str,
        api_version: str,
        resource_version: str,
        item_jsons: "list[str]",
    ) -> bytes:
        """Splice a kube List document from cached per-item bytes —
        byte-identical to ``json.dumps`` of the dict the uncached path
        builds (same key order, default separators)."""
        return (
            '{"kind": %s, "apiVersion": %s, "metadata": {"resourceVersion": %s}, '
            '"items": [%s]}'
            % (
                json.dumps(list_kind),
                json.dumps(api_version),
                json.dumps(resource_version),
                ", ".join(item_jsons),
            )
        ).encode()

    # -------------------------------------------------------- invalidation

    def invalidate(self, kind: str, meta: "dict | None", deleted: bool = False) -> None:
        """Drop the object's entry (called by the store on every
        mutation/replay, under the store lock).  ``deleted`` is
        informational — both cases purge; the flag keeps the call sites
        self-documenting."""
        meta = meta or {}
        key = (kind, meta.get("namespace"), meta.get("name"))
        with self._lock:
            if self._map.pop(key, None) is not None:
                self.invalidations += 1

    def clear(self) -> None:
        with self._lock:
            n = len(self._map)
            self._map.clear()
            self.invalidations += n

    # ------------------------------------------------------------ surfaces

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "entries": len(self._map),
                "max_entries": self.max_entries,
            }
