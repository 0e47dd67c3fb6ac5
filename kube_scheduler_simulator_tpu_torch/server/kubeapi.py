"""Kubernetes-API-compatible HTTP surface over the in-memory cluster store.

The reference boots a REAL kube-apiserver on its own port (:3131) next to
the simulator API (:1212) so kubectl/client-go and external schedulers can
talk to the simulated cluster directly (reference
simulator/k8sapiserver/k8sapiserver.go:34-88; the web UI's per-resource
clients hit it too, web/api/v1/*.ts).  This build replaces the apiserver
with the in-memory store (SURVEY.md §7 step 1); this module serves the
store through the kube REST conventions so generic clients keep working:

- discovery: ``GET /api``, ``GET /api/v1``, ``GET /apis``,
  ``GET /apis/{group}/{version}`` (APIVersions / APIResourceList /
  APIGroupList documents)
- collections: ``GET/POST`` on ``/api/v1/pods`` (all namespaces),
  ``/api/v1/namespaces/{ns}/pods``, ``/api/v1/nodes``, … and the grouped
  kinds under ``/apis/{group}/{version}/…`` (storageclasses, csinodes,
  priorityclasses, deployments, replicasets, poddisruptionbudgets)
- objects: ``GET/PUT/PATCH/DELETE`` on ``…/{name}`` (PATCH is
  strategic-merge-lite: JSON merge patch semantics, what the store's
  ``patch`` implements)
- ``?watch=true``: chunked watch stream of kube WatchEvents
  (``{"type":"ADDED","object":{…}}``), resuming from ``resourceVersion``
- the ``binding`` subresource: ``POST …/pods/{name}/binding`` — how a
  real (external) scheduler commits a placement

Served by ``KubeAPIServer`` on its own port, mirroring the reference's
two-port layout.
"""

from __future__ import annotations

import json
import queue
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlparse

from kube_scheduler_simulator_tpu_torch.state.store import (
    AlreadyExistsError,
    ConflictError,
    NAMESPACED_KINDS,
    NotFoundError,
)
from kube_scheduler_simulator_tpu_torch.utils.k8s_selectors import (
    SelectorError,
    compile_selectors,
)

Obj = dict[str, Any]

# session-scoped kube-API routing (tenancy/): /sessions/<id>/api/... —
# the un-prefixed surface keeps hitting the default session's store
_SESSION_PREFIX_RE = re.compile(r"^/sessions/([^/]+)(/.+)$")
# session containers never run the simulator operator — their CRD kinds
# 404 per session (see server.py _SESSION_DISABLED)
_SESSION_DISABLED = frozenset({"simulators", "schedulersimulations"})

# (group, version, resource, kind name, store kind)
CORE_RESOURCES = (
    ("", "v1", "pods", "Pod", "pods"),
    ("", "v1", "nodes", "Node", "nodes"),
    ("", "v1", "namespaces", "Namespace", "namespaces"),
    ("", "v1", "persistentvolumes", "PersistentVolume", "persistentvolumes"),
    ("", "v1", "persistentvolumeclaims", "PersistentVolumeClaim", "persistentvolumeclaims"),
    # client-go event recorders post here (older clients) …
    ("", "v1", "events", "Event", "events"),
)
GROUP_RESOURCES = (
    ("storage.k8s.io", "v1", "storageclasses", "StorageClass", "storageclasses"),
    ("storage.k8s.io", "v1", "csinodes", "CSINode", "csinodes"),
    ("scheduling.k8s.io", "v1", "priorityclasses", "PriorityClass", "priorityclasses"),
    ("apps", "v1", "deployments", "Deployment", "deployments"),
    ("apps", "v1", "replicasets", "ReplicaSet", "replicasets"),
    ("policy", "v1", "poddisruptionbudgets", "PodDisruptionBudget", "poddisruptionbudgets"),
    # KEP-140 Scenario CRD surface (reference scenario/api/v1alpha1);
    # reconciled by scenario/operator.py
    ("simulation.kube-scheduler-simulator.sigs.k8s.io", "v1alpha1", "scenarios", "Scenario", "scenarios"),
    # KEP-159 Simulator CRD surface (reference keps/159: design-only) —
    # reconciled by scenario/simulator_operator.py into isolated
    # in-process simulator instances
    ("simulation.kube-scheduler-simulator.sigs.k8s.io", "v1alpha1", "simulators", "Simulator", "simulators"),
    # KEP-184 SchedulerSimulation CRD surface (reference keps/184:
    # design-only) — one-shot Scenario × N-scheduler comparative runs,
    # reconciled by the same operator loop
    ("simulation.kube-scheduler-simulator.sigs.k8s.io", "v1alpha1", "schedulersimulations", "SchedulerSimulation", "schedulersimulations"),
    # … and newer clients use the events.k8s.io group; both serve the
    # same store bucket
    ("events.k8s.io", "v1", "events", "Event", "events"),
)
ALL_RESOURCES = CORE_RESOURCES + GROUP_RESOURCES
# a resource name can be served under several groupVersions (events)
_BY_RESOURCE: dict = {}
for _r in ALL_RESOURCES:
    _BY_RESOURCE.setdefault(_r[2], []).append(_r)


def _api_version(group: str, version: str) -> str:
    return version if not group else f"{group}/{version}"


class _Route:
    __slots__ = ("kind", "store_kind", "api_version", "namespace", "name", "subresource")

    def __init__(self, kind, store_kind, api_version, namespace, name, subresource):
        self.kind = kind
        self.store_kind = store_kind
        self.api_version = api_version
        self.namespace = namespace
        self.name = name
        self.subresource = subresource


def resolve(path: str) -> "_Route | None":
    """Map a kube REST path to (kind, namespace, name, subresource)."""
    parts = [p for p in path.split("/") if p]
    if not parts:
        return None
    if parts[0] == "api":
        if len(parts) < 3 or parts[1] != "v1":
            return None
        rest = parts[2:]
        group, version = "", "v1"
    elif parts[0] == "apis":
        if len(parts) < 4:
            return None
        group, version = parts[1], parts[2]
        rest = parts[3:]
    else:
        return None
    namespace = None
    if rest[0] == "namespaces" and len(rest) >= 3:
        # /namespaces/{ns}/{resource}... — /namespaces/{name} falls
        # through as an object route of the namespaces resource
        namespace, rest = rest[1], rest[2:]
    resource = rest[0]
    entry = next(
        (e for e in _BY_RESOURCE.get(resource, ()) if e[0] == group and e[1] == version),
        None,
    )
    if entry is None:
        return None
    name = rest[1] if len(rest) > 1 else None
    subresource = rest[2] if len(rest) > 2 else None
    return _Route(entry[3], entry[4], _api_version(group, version), namespace, name, subresource)


def discovery_document(path: str, disabled_kinds: "frozenset[str]" = frozenset()) -> "Obj | None":
    parts = [p for p in path.split("/") if p]
    group_versions: dict[str, str] = {g: v for g, v, *_ in GROUP_RESOURCES}
    if parts == ["api"]:
        return {"kind": "APIVersions", "versions": ["v1"]}
    if parts == ["apis"]:
        return {
            "kind": "APIGroupList",
            "apiVersion": "v1",
            "groups": [
                {
                    "name": g,
                    "versions": [{"groupVersion": f"{g}/{v}", "version": v}],
                    "preferredVersion": {"groupVersion": f"{g}/{v}", "version": v},
                }
                for g, v in sorted(group_versions.items())
            ],
        }
    if parts == ["api", "v1"] or (
        len(parts) == 3 and parts[0] == "apis" and group_versions.get(parts[1]) == parts[2]
    ):
        if parts[0] == "api":
            rows = [r for r in CORE_RESOURCES if r[4] not in disabled_kinds]
            gv = "v1"
        else:
            rows = [r for r in GROUP_RESOURCES if r[0] == parts[1] and r[4] not in disabled_kinds]
            gv = f"{parts[1]}/{parts[2]}"
        return {
            "kind": "APIResourceList",
            "groupVersion": gv,
            "resources": [
                {
                    "name": resource,
                    "singularName": kind.lower(),
                    "namespaced": store_kind in NAMESPACED_KINDS,
                    "kind": kind,
                    "verbs": ["create", "delete", "get", "list", "patch", "update", "watch"],
                }
                for _g, _v, resource, kind, store_kind in rows
            ]
            + (
                [{"name": "pods/binding", "singularName": "", "namespaced": True, "kind": "Binding", "verbs": ["create"]}]
                if parts[0] == "api"
                else []
            ),
        }
    return None


class KubeAPIServer:
    """The simulator's kube-API port (reference layout: kube API on its
    own port next to the simulator API)."""

    def __init__(
        self,
        cluster_store: Any,
        port: int = 3131,
        disabled_kinds: "frozenset[str]" = frozenset(),
        sessions: Any = None,
    ):
        # disabled_kinds: store kinds this apiserver does NOT serve —
        # e.g. a spawned KEP-159 simulator instance has no simulator
        # operator, so its apiserver must 404 the operator CRDs exactly
        # as a real apiserver without those CRDs installed would, rather
        # than accept objects nothing will ever reconcile
        # sessions: the SimulatorServer's SessionManager (tenancy/) —
        # enables /sessions/<id>/api/... and X-KSS-Session routing to
        # per-session stores; None (the default) serves one store only
        self.store = cluster_store
        self.port = port
        self.disabled_kinds = frozenset(disabled_kinds)
        self.sessions = sessions
        self._httpd: "ThreadingHTTPServer | None" = None
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()

    def start(self, background: bool = True) -> int:
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        if background:
            self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self.port

    def shutdown(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def _make_handler(server: KubeAPIServer):
    store = server.store

    def envelope(obj: Obj, api_version: str, kind: str) -> Obj:
        out = dict(obj)
        out.setdefault("apiVersion", api_version)
        out.setdefault("kind", kind)
        return out

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:  # quiet
            pass

        def _send_json(self, code: int, body: Obj) -> None:
            self._send_raw(code, json.dumps(body).encode())

        def _send_raw(self, code: int, data: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _status_err(self, code: int, reason: str, message: str) -> None:
            self._send_json(
                code,
                {
                    "kind": "Status",
                    "apiVersion": "v1",
                    "status": "Failure",
                    "reason": reason,
                    "message": message,
                    "code": code,
                },
            )

        def _raw_body(self) -> bytes:
            length = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(length) if length else b""

        def _body(self) -> Obj:
            raw = self._raw_body()
            return json.loads(raw) if raw else {}

        # --------------------------------------------------------- routing

        def _resolve_active(self, path: str) -> "_Route | None":
            """resolve(), minus this request's disabled kinds — a route
            to an uninstalled CRD must 404 like a real apiserver's
            would (session containers additionally hide the operator
            CRDs; see _route)."""
            rt = resolve(path)
            if rt is not None and rt.store_kind in self._disabled:
                return None
            return rt

        def _route(self):
            """Resolve this request's SESSION (tenancy/): the
            ``/sessions/<id>/api/...`` prefix or the ``X-KSS-Session``
            header select a per-session store; otherwise the default
            store, byte-for-byte as before.  Returns (store, url), or
            None when a 404 for an unknown session was already sent."""
            url = urlparse(self.path)
            self._disabled = server.disabled_kinds
            mgr = server.sessions
            if mgr is not None:
                m = _SESSION_PREFIX_RE.match(url.path)
                if m:
                    sid, rest = m.group(1), m.group(2)
                    url = url._replace(path=rest)
                else:
                    sid = (self.headers.get("X-KSS-Session") or "").strip() or None
                if sid and sid != "default":
                    from kube_scheduler_simulator_tpu_torch.tenancy import (
                        UnknownSessionError,
                    )

                    try:
                        sstore = mgr.resolve_store(sid)
                    except UnknownSessionError as e:
                        self._status_err(404, "NotFound", str(e))
                        return None
                    self._disabled = server.disabled_kinds | _SESSION_DISABLED
                    return sstore, url
            return store, url

        # ------------------------------------------------------------- GET

        def do_GET(self) -> None:
            r = self._route()
            if r is None:
                return
            store, url = r
            q = parse_qs(url.query)
            # the handshake endpoints kubectl/client-go probe first
            if url.path == "/version":
                self._send_json(
                    200,
                    {
                        "major": "1",
                        "minor": "26",
                        "gitVersion": "v1.26.0-simulator",
                        "platform": "tpu/simulator",
                    },
                )
                return
            if url.path in ("/healthz", "/readyz", "/livez"):
                data = b"ok"
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            doc = discovery_document(url.path, self._disabled)
            if doc is not None:
                self._send_json(200, doc)
                return
            rt = self._resolve_active(url.path)
            if rt is None:
                self._status_err(404, "NotFound", f"no handler for {url.path}")
                return
            try:
                if rt.name is None:
                    # labelSelector / fieldSelector, exactly as the
                    # reference's real kube-apiserver serves them to
                    # client-go informers and external schedulers
                    try:
                        sel = compile_selectors(
                            (q.get("labelSelector") or [None])[0],
                            (q.get("fieldSelector") or [None])[0],
                        )
                    except SelectorError as e:
                        self._status_err(400, "BadRequest", str(e))
                        return
                    if (q.get("watch") or ["false"])[0] == "true":
                        try:
                            rv = int((q.get("resourceVersion") or ["0"])[0] or 0)
                        except ValueError:
                            self._status_err(400, "BadRequest", "resourceVersion must be an integer")
                            return
                        self._watch(store, rt, rv, sel)
                    else:
                        wc = store.wirecache
                        if wc is not None:
                            # render-once path: live objects (no deep
                            # copies — they're frozen by the store's
                            # replacement contract), per-item bytes from
                            # the cache, the List document spliced —
                            # byte-identical to the json.dumps below
                            items = store.list(
                                rt.store_kind, rt.namespace, copy_objects=False
                            )
                            if sel is not None:
                                items = [o for o in items if sel(o)]
                            self._send_raw(
                                200,
                                wc.list_doc(
                                    f"{rt.kind}List",
                                    rt.api_version,
                                    str(store.resource_version),
                                    [
                                        wc.obj_json(
                                            rt.store_kind, o, rt.api_version, rt.kind
                                        )
                                        for o in items
                                    ],
                                ),
                            )
                            return
                        items = store.list(rt.store_kind, rt.namespace)
                        if sel is not None:
                            items = [o for o in items if sel(o)]
                        self._send_json(
                            200,
                            {
                                "kind": f"{rt.kind}List",
                                "apiVersion": rt.api_version,
                                "metadata": {"resourceVersion": str(store.resource_version)},
                                "items": [envelope(o, rt.api_version, rt.kind) for o in items],
                            },
                        )
                else:
                    wc = store.wirecache
                    if wc is not None:
                        with store.lock:
                            obj = store._get_internal(rt.store_kind, rt.name, rt.namespace)
                        self._send_raw(
                            200, wc.obj_json(rt.store_kind, obj, rt.api_version, rt.kind).encode()
                        )
                        return
                    obj = store.get(rt.store_kind, rt.name, rt.namespace)
                    self._send_json(200, envelope(obj, rt.api_version, rt.kind))
            except NotFoundError as e:
                self._status_err(404, "NotFound", str(e))

        def _watch(self, store: Any, rt: "_Route", rv: int, sel=None) -> None:
            """Chunked kube watch stream: {"type": ..., "object": ...}.

            With a selector, transitions are synthesized the way the real
            apiserver does: an update that starts matching streams ADDED,
            one that stops matching streams DELETED (client-go informers
            watching ``spec.nodeName=`` depend on this to drop pods the
            scheduler binds)."""

            def sel_event(ev) -> "tuple[str, Obj] | None":
                if sel is None:
                    return ev.type, ev.obj
                matches = sel(ev.obj)
                if ev.type == "MODIFIED":
                    old = ev.old_obj
                    old_matches = sel(old) if old is not None else matches
                    if matches and old_matches:
                        return "MODIFIED", ev.obj
                    if matches:
                        return "ADDED", ev.obj
                    if old_matches:
                        return "DELETED", ev.obj
                    return None
                return (ev.type, ev.obj) if matches else None

            events: "queue.Queue" = queue.Queue()
            unsubscribe = store.subscribe([rt.store_kind], events.put)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                wc = store.wirecache

                def write_event(type_: str, obj: Obj) -> None:
                    if wc is not None:
                        # shared render across every watcher of this
                        # object version; DELETED bytes are rendered but
                        # never cached (their entry was just purged and
                        # has no future readers)
                        line = wc.event_line(
                            type_,
                            wc.obj_json(
                                rt.store_kind, obj, rt.api_version, rt.kind,
                                insert=type_ != "DELETED",
                            ),
                        )
                    else:
                        line = (
                            json.dumps({"type": type_, "object": envelope(obj, rt.api_version, rt.kind)})
                            + "\n"
                        ).encode()
                    self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                    self.wfile.flush()

                if rv == 0:
                    # kube semantics: rv=0/absent → synthetic ADDED for the
                    # current state first; capture the state's rv ATOMICALLY
                    # with the list so queued events from the subscribe/list
                    # window aren't replayed twice out of order
                    with store.lock:
                        # with the wire cache on, render from the live
                        # (frozen) objects — the sweep's bytes seed the
                        # cache every later consumer shares
                        items = store.list(
                            rt.store_kind, rt.namespace, copy_objects=wc is None
                        )
                        rv = store.resource_version
                    for o in items:
                        if sel is None or sel(o):
                            write_event("ADDED", o)
                else:
                    # resume: replay the missed backlog from the event log
                    # (410 Gone when it was compacted away, kube-style)
                    from kube_scheduler_simulator_tpu_torch.state.store import (
                        ResourceExpiredError,
                    )

                    try:
                        backlog = store.events_since(rt.store_kind, rv)
                    except ResourceExpiredError as e:
                        write_event_raw = {
                            "type": "ERROR",
                            "object": {
                                "kind": "Status",
                                "apiVersion": "v1",
                                "status": "Failure",
                                "reason": "Expired",
                                "message": str(e),
                                "code": 410,
                            },
                        }
                        line = (json.dumps(write_event_raw) + "\n").encode()
                        self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                        self.wfile.flush()
                        return
                    for ev in backlog:
                        if rt.namespace and (ev.obj["metadata"].get("namespace") or "default") != rt.namespace:
                            continue
                        mapped = sel_event(ev)
                        if mapped is not None:
                            write_event(*mapped)
                        rv = max(rv, ev.resource_version)
                while not server._stop.is_set():
                    try:
                        ev = events.get(timeout=0.25)
                    except queue.Empty:
                        continue
                    if rt.namespace and (ev.obj["metadata"].get("namespace") or "default") != rt.namespace:
                        continue
                    if ev.resource_version <= rv:
                        continue
                    mapped = sel_event(ev)
                    if mapped is not None:
                        write_event(*mapped)
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                unsubscribe()

        # ------------------------------------------------------------ POST

        def do_POST(self) -> None:
            r = self._route()
            if r is None:
                return
            store, url = r
            rt = self._resolve_active(url.path)
            if rt is None:
                self._status_err(404, "NotFound", f"no handler for {url.path}")
                return
            try:
                body = self._body()
                if rt.subresource == "binding" and rt.store_kind == "pods":
                    # the scheduler's bind call: POST …/pods/{name}/binding
                    target = ((body.get("target") or {}).get("name")) or ""
                    if not target:
                        self._status_err(400, "BadRequest", "binding requires target.name")
                        return
                    store.bind_pod(rt.namespace or "default", rt.name, target)
                    self._send_json(
                        201,
                        {"kind": "Status", "apiVersion": "v1", "status": "Success", "code": 201},
                    )
                    return
                if rt.namespace:
                    body.setdefault("metadata", {}).setdefault("namespace", rt.namespace)
                created = store.create(rt.store_kind, body)
                self._send_json(201, envelope(created, rt.api_version, rt.kind))
            except AlreadyExistsError as e:
                self._status_err(409, "AlreadyExists", str(e))
            except NotFoundError as e:
                self._status_err(404, "NotFound", str(e))
            except Exception as e:
                self._status_err(400, "BadRequest", f"{type(e).__name__}: {e}")

        # ---------------------------------------------------- PUT / PATCH

        def do_PUT(self) -> None:
            r = self._route()
            if r is None:
                return
            store, url = r
            rt = self._resolve_active(url.path)
            if rt is None or rt.name is None:
                self._status_err(404, "NotFound", f"no handler for {url.path}")
                return
            try:
                body = self._body()
                body.setdefault("metadata", {}).setdefault("name", rt.name)
                if rt.namespace:
                    body["metadata"].setdefault("namespace", rt.namespace)
                if body["metadata"].get("resourceVersion"):
                    # PUT with a resourceVersion is an optimistic-
                    # concurrency replace: stale RV must 409 (client-go
                    # retry.RetryOnConflict depends on it); apply() would
                    # strip the RV and last-write-win instead
                    updated = store.update(rt.store_kind, body, owned=True)
                else:
                    # RV-less PUT is still a REPLACE: the apiserver keeps
                    # AllowCreateOnUpdate=false for these resources, so a
                    # missing object must 404 (errors.IsNotFound for
                    # delete-tolerant updaters) — never silently upsert.
                    # update() IS that atomic replace-or-404 (no RV on the
                    # body means no conflict check; stale uid overwritten)
                    body["metadata"].pop("uid", None)
                    updated = store.update(rt.store_kind, body, owned=True)
                self._send_json(200, envelope(updated, rt.api_version, rt.kind))
            except ConflictError as e:
                # client-go's retry.RetryOnConflict keys on 409 + reason
                # Conflict (a real apiserver never 400s a stale update)
                self._status_err(409, "Conflict", str(e))
            except NotFoundError as e:
                # replace of a concurrently-deleted object: 404, so
                # errors.IsNotFound() holds for delete-tolerant updaters
                self._status_err(404, "NotFound", str(e))
            except Exception as e:
                self._status_err(400, "BadRequest", f"{type(e).__name__}: {e}")

        def do_PATCH(self) -> None:
            r = self._route()
            if r is None:
                return
            store, url = r
            rt = self._resolve_active(url.path)
            if rt is None or rt.name is None:
                self._status_err(404, "NotFound", f"no handler for {url.path}")
                return
            from kube_scheduler_simulator_tpu_torch.server.patches import (
                ApplyConflictError,
                PatchApplyError,
                PatchError,
            )

            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()
            try:
                if ctype == "application/apply-patch+yaml":
                    self._apply_patch(store, rt, parse_qs(url.query))
                elif ctype == "application/json-patch+json":
                    self._json_patch(store, rt)
                else:
                    # default: merge-patch-lite (the store's patch —
                    # JSON merge semantics, strategic-merge-lite)
                    patched = store.patch(rt.store_kind, rt.name, self._body(), rt.namespace)
                    self._send_json(200, envelope(patched, rt.api_version, rt.kind))
            except ApplyConflictError as e:
                # the SSA conflict protocol: 409 Status naming the
                # owning manager(s); the client retries with force=true
                # to take ownership
                self._status_err(409, "Conflict", str(e))
            except PatchApplyError as e:
                # well-formed patch that cannot apply (missing path,
                # failed test op): 422, the apiserver's invalid-patch
                # classification
                self._status_err(422, "Invalid", str(e))
            except PatchError as e:
                self._status_err(400, "BadRequest", str(e))
            except NotFoundError as e:
                self._status_err(404, "NotFound", str(e))
            except ConflictError as e:
                self._status_err(409, "Conflict", str(e))
            except Exception as e:
                self._status_err(400, "BadRequest", f"{type(e).__name__}: {e}")

        def _apply_patch(self, store: Any, rt: "_Route", q: dict) -> None:
            """Server-side apply (application/apply-patch+yaml):
            field-manager-lite upsert — see server/patches.py for the
            ownership model and documented deviations."""
            import yaml

            from kube_scheduler_simulator_tpu_torch.server.patches import (
                PatchError,
                server_side_apply,
            )

            manager = (q.get("fieldManager") or [""])[0].strip()
            force = (q.get("force") or ["false"])[0].lower() in ("1", "true")
            try:
                patch = yaml.safe_load(self._raw_body().decode() or "{}")
            except yaml.YAMLError as e:
                raise PatchError(f"apply configuration is not valid YAML: {e}") from None
            if not isinstance(patch, dict):
                raise PatchError("an apply configuration must be an object")
            pmeta = patch.get("metadata") or {}
            pname = pmeta.get("name")
            if pname is not None and pname != rt.name:
                raise PatchError(
                    f"metadata.name {pname!r} does not match the URL name {rt.name!r}"
                )
            # atomic read-modify-write under the store lock: concurrent
            # appliers serialize, each seeing the other's managedFields
            with store.lock:
                try:
                    existing = store.get(rt.store_kind, rt.name, rt.namespace)
                except NotFoundError:
                    existing = None
                new, created = server_side_apply(
                    existing, patch, manager, force, api_version=rt.api_version
                )
                new.setdefault("metadata", {}).setdefault("name", rt.name)
                if rt.namespace:
                    new["metadata"].setdefault("namespace", rt.namespace)
                if created:
                    out = store.create(rt.store_kind, new)
                else:
                    new["metadata"]["resourceVersion"] = existing["metadata"].get(
                        "resourceVersion"
                    )
                    out = store.update(rt.store_kind, new, owned=True)
            self._send_json(201 if created else 200, envelope(out, rt.api_version, rt.kind))

        def _json_patch(self, store: Any, rt: "_Route") -> None:
            """RFC 6902 (application/json-patch+json): the ordered
            operation list applies atomically under the store lock."""
            from kube_scheduler_simulator_tpu_torch.server.patches import (
                PatchApplyError,
                PatchError,
                apply_json_patch,
            )

            try:
                ops = json.loads(self._raw_body() or b"[]")
            except ValueError as e:
                raise PatchError(f"patch is not valid JSON: {e}") from None
            with store.lock:
                obj = store.get(rt.store_kind, rt.name, rt.namespace)
                patched = apply_json_patch(obj, ops)
                pm = patched.get("metadata") or {}
                om = obj["metadata"]
                if pm.get("name") != om.get("name") or (
                    rt.store_kind in NAMESPACED_KINDS
                    and (pm.get("namespace") or "default") != (om.get("namespace") or "default")
                ):
                    raise PatchApplyError("a patch may not rename or move an object")
                # the patched doc carries the observed resourceVersion —
                # update()'s optimistic concurrency still applies
                out = store.update(rt.store_kind, patched, owned=True)
            self._send_json(200, envelope(out, rt.api_version, rt.kind))

        # ---------------------------------------------------------- DELETE

        def do_DELETE(self) -> None:
            r = self._route()
            if r is None:
                return
            store, url = r
            rt = self._resolve_active(url.path)
            if rt is None or rt.name is None:
                self._status_err(404, "NotFound", f"no handler for {url.path}")
                return
            try:
                store.delete(rt.store_kind, rt.name, rt.namespace)
                self._send_json(
                    200, {"kind": "Status", "apiVersion": "v1", "status": "Success", "code": 200}
                )
            except NotFoundError as e:
                self._status_err(404, "NotFound", str(e))

    return Handler
