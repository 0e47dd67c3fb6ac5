"""Resource watcher: server-push of watch events with resume support.

Rebuild of the reference's resourcewatcher (reference
simulator/resourcewatcher/{resourcewatcher.go,eventproxy.go,streamwriter/}):
``list_watch(stream, last_resource_versions)`` streams newline-delimited
WatchEvent JSON objects — ``{"Kind": ..., "EventType": ..., "Obj": ...}``,
the Go struct's field casing (streamwriter.go:18-23) — for the seven
resource kinds.  Per kind: no lastResourceVersion → LIST first, emitted as
ADDED events (resourcewatcher.go:108-114); a version → resume from the
store's event log (RetryWatcher analog); an expired version → relist, like
a 410 Gone recovery.

The reference runs one goroutine per kind against client-go watches; here
a single subscription on the store's synchronous event bus feeds a queue,
and the caller's thread drains it into the stream (same mutex-guarded
single-writer discipline as the reference's StreamWriter).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Mapping

from kube_scheduler_simulator_tpu_torch.state.store import ResourceExpiredError

Obj = dict[str, Any]

# query-param prefix → store kind (reference watcher handler,
# server/handler/watcher.go:26-34)
PARAM_KINDS: tuple[tuple[str, str], ...] = (
    ("pods", "pods"),
    ("nodes", "nodes"),
    ("pvs", "persistentvolumes"),
    ("pvcs", "persistentvolumeclaims"),
    ("scs", "storageclasses"),
    ("pcs", "priorityclasses"),
    ("namespace", "namespaces"),
)

# The watcher covers exactly the reference's 7 kinds (resourcewatcher.go:
# 23-29) — workload kinds reconciled by the controllers are not streamed.
WATCH_KINDS: tuple[str, ...] = tuple(kind for _param, kind in PARAM_KINDS)


class StreamWriter:
    """Mutex-guarded JSON-lines writer (reference streamwriter.go:26-50).

    ``stream`` needs ``write(bytes)`` and optionally ``flush()``."""

    def __init__(self, stream: Any, dumps):
        self._stream = stream
        self._dumps = dumps
        self._mu = threading.Lock()

    def write(self, event: Obj) -> None:
        self.write_raw((self._dumps(event) + "\n").encode())

    def write_raw(self, data: bytes) -> None:
        with self._mu:
            self._stream.write(data)
            flush = getattr(self._stream, "flush", None)
            if flush is not None:
                flush()


class ResourceWatcherService:
    def __init__(self, cluster_store: Any):
        self.cluster_store = cluster_store

    def list_watch(
        self,
        stream: Any,
        last_resource_versions: "Mapping[str, str] | None" = None,
        stop: "threading.Event | None" = None,
        dumps=None,
        heartbeat_s: "float | None" = None,
    ) -> None:
        """Stream events until the client disconnects (write raises) or
        ``stop`` is set.  ``last_resource_versions`` maps store kind →
        resourceVersion string (empty/absent/non-numeric = list first).

        ``heartbeat_s`` is opt-in (default off): the reference's stream
        carries only WatchEvent JSON lines (streamwriter.go:41-50), so a
        probe must not be injected into streams strict clients parse.  When
        enabled, idle connections get a blank-line probe every
        ``heartbeat_s`` so dead sockets are detected (and the subscription
        released) even when no events flow; the per-client queue is
        bounded, so a stuck client can't hold unbounded event copies."""
        import json as _json

        lrv = dict(last_resource_versions or {})
        writer = StreamWriter(stream, dumps or (lambda o: _json.dumps(o, separators=(",", ":"))))
        events: "queue.Queue[Obj]" = queue.Queue(maxsize=8192)

        # Subscribe FIRST so nothing is lost between list and watch; the
        # initial list/backlog is emitted before the queue is drained, and
        # duplicates are impossible because the store's bus is synchronous
        # under its lock and we record the resourceVersion watermark.
        watermark: dict[str, int] = {}
        pending: list[Obj] = []

        def on_event(ev: Any) -> None:
            try:
                events.put_nowait({"Kind": ev.kind, "EventType": ev.type, "Obj": ev.obj})
            except queue.Full:
                # Stuck/dead client: drop.  A live-but-lagging client must
                # reconnect+relist (the same contract as an expired watch
                # resourceVersion); a dead socket is detected at the next
                # write — or by the opt-in heartbeat probe on idle streams.
                pass

        unsubscribe = self.cluster_store.subscribe(list(WATCH_KINDS), on_event)
        try:
            for kind in WATCH_KINDS:
                rv = lrv.get(kind, "")
                if not str(rv).isdigit():
                    rv = ""  # non-numeric (opaque-token misuse) → relist
                if rv == "":
                    for obj in self.cluster_store.list(kind):
                        pending.append({"Kind": kind, "EventType": "ADDED", "Obj": obj})
                        watermark[kind] = max(
                            watermark.get(kind, 0), int(obj["metadata"]["resourceVersion"])
                        )
                else:
                    try:
                        backlog = self.cluster_store.events_since(kind, int(rv))
                    except ResourceExpiredError:
                        # 410 Gone analog: relist (RetryWatcher recovery,
                        # reference resourcewatcher.go:128-134).  Raised
                        # both for COMPACTED versions (bounded log /
                        # checkpoint compaction) and for versions NEWER
                        # than the store's log — the crash-recovery case:
                        # a client that watched the previous incarnation
                        # holds a resourceVersion the re-numbered log
                        # never issued, and resuming it silently would
                        # let the client's dedup watermark drop real
                        # events (state/recovery.py).
                        backlog = None
                    if backlog is None:
                        for obj in self.cluster_store.list(kind):
                            pending.append({"Kind": kind, "EventType": "ADDED", "Obj": obj})
                            watermark[kind] = max(
                                watermark.get(kind, 0), int(obj["metadata"]["resourceVersion"])
                            )
                    else:
                        for ev in backlog:
                            pending.append({"Kind": ev.kind, "EventType": ev.type, "Obj": ev.obj})
                            watermark[kind] = max(watermark.get(kind, 0), ev.resource_version)

            for ev in pending:
                writer.write(ev)

            import time as _time

            last_write = _time.monotonic()
            while stop is None or not stop.is_set():
                try:
                    ev = events.get(timeout=0.25)
                except queue.Empty:
                    if heartbeat_s is not None and _time.monotonic() - last_write >= heartbeat_s:
                        writer.write_raw(b"\n")  # probes for a dead socket
                        last_write = _time.monotonic()
                    continue
                rv = int(ev["Obj"]["metadata"]["resourceVersion"])
                if rv <= watermark.get(ev["Kind"], 0):
                    continue  # already emitted via list/backlog
                writer.write(ev)
                last_write = _time.monotonic()
        except (BrokenPipeError, ConnectionError, OSError):
            return  # client went away — normal termination
        finally:
            unsubscribe()
