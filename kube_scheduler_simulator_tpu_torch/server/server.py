"""The simulator HTTP server: the reference's exact REST surface.

Routes (reference simulator/server/server.go:42-57):

    GET  /api/v1/schedulerconfiguration      → 200 current config
    POST /api/v1/schedulerconfiguration      → 202 (only .profiles honored)
    PUT  /api/v1/reset                       → 202
    GET  /api/v1/export                      → 200 ResourcesForSnap
    POST /api/v1/import                      → 200
    GET  /api/v1/listwatchresources          → JSON-lines server push (SSE analog)
    POST /api/v1/extender/filter/:id | prioritize/:id | preempt/:id | bind/:id
    POST /api/v1/tpuscorer/filter | prioritize → extenderv1 endpoint backed by
                                               the batch kernel (point a
                                               real scheduler's extender here;
                                               scheduler/scorer_bridge.py)
    POST /api/v1/scenarios                   → run a KEP-140 Scenario, return it
                                               with status/timeline (the
                                               reference only scaffolds this)
    GET  /api/v1/metrics (also /metrics)     → Prometheus text metrics (the
                                               reference exposes upstream
                                               Prometheus metrics via blank
                                               imports)

Because this build replaces the in-process kube-apiserver with the
in-memory cluster store (SURVEY.md §7 step 1), the direct kube-API CRUD
the reference's web UI performs is exposed here too:

    GET    /api/v1/resources/{kind}?namespace=        → list
    POST   /api/v1/resources/{kind}                   → create
    GET    /api/v1/resources/{kind}/{name}?namespace= → get
    PUT    /api/v1/resources/{kind}/{name}            → apply (upsert)
    DELETE /api/v1/resources/{kind}/{name}?namespace= → delete

Implementation: stdlib ThreadingHTTPServer — one thread per connection,
matching the store's synchronous, lock-guarded semantics; the watch
endpoint writes newline-delimited WatchEvent JSON with per-event flush
(what the reference's echo ResponseStream does, streamwriter.go:41-50).

The port's copy of the JAX package's ``server/server.py``: the same routes,
status codes and bodies, on the container's device.  A request thread
starts on CUDA device 0, so every request makes the container's card its
thread's current device before it routes: the tuning run (K9, K2g), the
PodGroup preview (K7, K5), a scenario's rounds and the scorer bridge launch
in the request thread.  A kernel that fails to build or launch answers 500
with its error; no route falls back to the CPU or a plain version.
"""

from __future__ import annotations

import copy
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlparse

import torch

from kube_scheduler_simulator_tpu_torch import tenancy
from kube_scheduler_simulator_tpu_torch.server.di import DIContainer
from kube_scheduler_simulator_tpu_torch.services.resourcewatcher import PARAM_KINDS
from kube_scheduler_simulator_tpu_torch.state.store import KINDS, AlreadyExistsError, NotFoundError
from kube_scheduler_simulator_tpu_torch.tuning.validate import WeightValidationError

Obj = dict[str, Any]

_EXTENDER_RE = re.compile(r"^/api/v1/extender/(filter|prioritize|preempt|bind)/(\d+)$")
_RESOURCE_RE = re.compile(r"^/api/v1/resources/([a-z]+)(?:/([^/]+))?$")
_NODEGROUP_RE = re.compile(r"^/api/v1/nodegroups(?:/([^/]+))?$")
_PODGROUP_RE = re.compile(r"^/api/v1/podgroups(?:/([^/]+))?$")
# the session plane (tenancy/): CRUD at /api/v1/sessions[/<id>], every
# other simulator route session-scoped at /api/v1/sessions/<id>/<rest>
_SESSION_RE = re.compile(r"^/api/v1/sessions(?:/([^/]+))?(/.+)?$")
# session containers run without the simulator operator (a tenant
# spawning tenants is recursion bait) — their CRD kinds 404 per session,
# exactly as KEP-159 spawned instances already do
_SESSION_DISABLED = frozenset({"simulators", "schedulersimulations"})


def _run_tuning_request(svc: Any, body: Obj) -> Obj:
    """POST /api/v1/tuning: run the weight tuner on one or more scenario
    families against the live profile's plugin set and return the
    default-vs-tuned comparison.  Sizes/steps are capped — this runs
    synchronously in the request thread."""
    from kube_scheduler_simulator_tpu_torch.tuning import run_tuning
    from kube_scheduler_simulator_tpu_torch.tuning.scenario import FAMILIES

    families = body.get("families")
    if families is None:
        families = [body.get("family") or "imbalance"]
    if not isinstance(families, list) or not families:
        raise ValueError("families must be a non-empty list of scenario family names")
    for f in families:
        if f not in FAMILIES:
            raise ValueError(f"unknown scenario family {f!r}; choose from {sorted(FAMILIES)}")
    tuner = body.get("tuner") or "cem"
    clamp = lambda v, lo, hi, d: max(lo, min(int(v if v is not None else d), hi))
    kw = dict(
        objective=body.get("objective"),
        tuner=tuner,
        n_nodes=clamp(body.get("nodes"), 2, 64, 12),
        n_pods=clamp(body.get("pods"), 4, 512, 96),
        steps=clamp(body.get("steps"), 1, 64, 4),
        pop=clamp(body.get("pop"), 2, 64, 8),
        seed=clamp(body.get("seed"), 0, 1 << 30, 0),
        weights=body.get("weights"),
        svc=svc,
    )
    report = {
        "tuner": tuner,
        "results": [run_tuning(family=f, **kw) for f in families],
    }
    svc._last_tuning_report = report
    return report


def _bind_card(di: Any) -> None:
    """Make the container's card the calling thread's current device."""
    dev = getattr(di, "device", None)
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.set_device(torch.device(dev))


class SimulatorServer:
    """NewSimulatorServer analog (reference server/server.go:26-66)."""

    def __init__(
        self,
        di: DIContainer,
        port: int = 1212,
        cors_allowed_origins: "list[str] | None" = None,
        kube_api_port: "int | None" = None,
    ):
        """``kube_api_port``: also serve the kube-API-compatible surface
        (server/kubeapi.py) on this port — the reference's two-port layout
        (kube API :3131 next to the simulator API :1212).  None disables
        it; 0 binds an ephemeral port (tests)."""
        self.di = di
        self.port = port
        self.cors = cors_allowed_origins or []
        self.kube_api_port = kube_api_port
        self.kube_api_server: Any = None
        # a container without the simulator operator (the isolated
        # instances KEP-159/184 spawn) must NOT serve the operator CRDs:
        # objects nothing reconciles would sit status-less forever —
        # a real apiserver without those CRDs installed 404s them, and
        # the KEP applies them to the USER cluster, not the simulator's
        self.disabled_kinds: "frozenset[str]" = (
            frozenset()
            if di.simulator_operator() is not None
            else frozenset({"simulators", "schedulersimulations"})
        )
        # The session plane (tenancy/): a read replica stays single-
        # surface (its store is FED by journal shipping — per-session
        # stores would have no feeder), every primary gets a manager.
        # Sessions created over HTTP schedule continuously like the
        # default container (start_background=True).
        self.sessions: Any = None
        if not getattr(di, "read_only", False):
            from kube_scheduler_simulator_tpu_torch.tenancy import SessionManager

            self.sessions = SessionManager(di, start_background=True)
        self._httpd: "ThreadingHTTPServer | None" = None
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()  # ends open watch streams on shutdown

    # --------------------------------------------------------------- serve

    def start(self, background: bool = True) -> int:
        """Start serving; returns the bound port (0 requests an ephemeral
        port, handy for tests)."""
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        if self.kube_api_port is not None:
            from kube_scheduler_simulator_tpu_torch.server.kubeapi import KubeAPIServer

            self.kube_api_server = KubeAPIServer(
                self.di.cluster_store,
                port=self.kube_api_port,
                disabled_kinds=self.disabled_kinds,
                sessions=self.sessions,
            )
            self.kube_api_port = self.kube_api_server.start(background=True)
        # The scheduler runs continuously like the reference's
        # `go sched.Run(ctx)` (scheduler.go:183).  A read replica
        # (replication/replica.py) has no scheduler to run — its store
        # is FED by journal shipping, not driven — until promotion
        # starts one itself.
        if not getattr(self.di, "read_only", False):
            self.di.scheduler_service().start_background()
        if background:
            self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self.port

    def shutdown(self) -> None:
        self._stop.set()
        if self.kube_api_server is not None:
            self.kube_api_server.shutdown()
            self.kube_api_server = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        try:
            if self.sessions is not None:
                # containers down, journal namespaces KEPT — a restarted
                # server recovers every session (tenancy/manager.py)
                self.sessions.close()
        finally:
            # stops the scheduler loop, re-raising the exception it died
            # of, if it did
            self.di.close()


def _make_handler(server: SimulatorServer):
    di = server.di

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # silence default request logging (echo's logger is opt-in)
        def log_message(self, fmt: str, *args: Any) -> None:
            pass

        # ----------------------------------------------------------- utils

        def _send_json(self, code: int, obj: Any) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self._cors_headers()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_bytes(self, content_type: str, data: bytes, code: int = 200) -> None:
            """Raw asset response (the UI page and its JS)."""
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_yaml(self, code: int, obj: Any, raw: bool = False) -> None:
            """YAML response (``?format=yaml`` / templates) — the
            reference UI's editors and templates speak YAML."""
            import yaml

            text = obj if raw else yaml.safe_dump(obj, sort_keys=False, default_flow_style=False)
            data = text.encode()
            self.send_response(code)
            self._cors_headers()
            self.send_header("Content-Type", "application/yaml; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_empty(self, code: int) -> None:
            self.send_response(code)
            self._cors_headers()
            self.send_header("Content-Length", "0")
            self.end_headers()

        def _cors_headers(self) -> None:
            origin = self.headers.get("Origin")
            if origin and (origin in server.cors or "*" in server.cors):
                self.send_header("Access-Control-Allow-Origin", origin)
                self.send_header("Access-Control-Allow-Methods", "GET, POST, PUT, DELETE, OPTIONS")
                self.send_header("Access-Control-Allow-Headers", "Content-Type")

        def _body(self) -> Any:
            """Request body as an object.  JSON by default; YAML when the
            Content-Type says so (the reference web UI is YAML-first —
            its monaco editor and creation templates speak YAML,
            web/components/lib/templates/*.yaml)."""
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            if not raw:
                return None
            ctype = (self.headers.get("Content-Type") or "").lower()
            if "yaml" in ctype:
                import yaml

                return yaml.safe_load(raw.decode())
            return json.loads(raw.decode())

        # --------------------------------------------------------- routing

        def _route(self, method: str):
            """Resolve this request's SESSION (tenancy/): the
            ``/api/v1/sessions/<id>/<rest>`` prefix (rewritten to the
            plain route) or the ``X-KSS-Session`` header select a
            session's container; no session → the default container,
            every route byte-for-byte as before the session plane
            existed.  Returns (di, url, q), or None when the response
            was already sent (sessions CRUD, unknown session)."""
            url = urlparse(self.path)
            q = parse_qs(url.query)
            self._disabled = server.disabled_kinds
            self._session = None
            mgr = server.sessions
            sid = None
            if mgr is not None:
                m = _SESSION_RE.match(url.path)
                if m:
                    sid, rest = m.group(1), m.group(2)
                    if not rest:
                        self._sessions_crud(method, sid, q)
                        return None
                    url = url._replace(path="/api/v1" + rest)
                else:
                    sid = (self.headers.get("X-KSS-Session") or "").strip() or None
                if sid and sid != tenancy.DEFAULT_SESSION:
                    try:
                        sdi = mgr.resolve_di(sid)
                    except tenancy.UnknownSessionError as e:
                        self._send_json(404, {"message": str(e)})
                        return None
                    self._disabled = server.disabled_kinds | _SESSION_DISABLED
                    self._session = sid
                    _bind_card(sdi)
                    return sdi, url, q
            _bind_card(di)
            return di, url, q

        def _sessions_crud(self, method: str, sid: "str | None", q: dict) -> None:
            """/api/v1/sessions[/<id>]: the session plane's own CRUD."""
            mgr = server.sessions
            try:
                if method == "GET":
                    if sid is None:
                        self._send_json(200, {"items": mgr.list(), **mgr.stats()})
                    elif sid == tenancy.DEFAULT_SESSION:
                        self._send_json(200, {"id": sid, "default": True})
                    else:
                        self._send_json(200, mgr.info(mgr.get(sid)))
                elif method == "POST" and sid is None:
                    if self._reject_read_only():
                        return
                    body = self._body() or {}
                    info = mgr.create(
                        body.get("id"),
                        use_batch=body.get("useBatch"),
                        seed=int(body.get("seed") or 0),
                        scheduler_cfg=body.get("schedulerConfig"),
                    )
                    self._send_json(201, info)
                elif method == "DELETE" and sid is not None:
                    if self._reject_read_only():
                        return
                    mgr.destroy(sid)
                    self._send_empty(200)
                else:
                    self._send_json(404, {"message": "not found"})
            except tenancy.TooManySessionsError as e:
                self._send_json(429, {"message": str(e)})
            except tenancy.SessionExistsError as e:
                self._send_json(409, {"message": str(e)})
            except tenancy.InvalidSessionError as e:
                self._send_json(400, {"message": str(e)})
            except tenancy.UnknownSessionError as e:
                self._send_json(404, {"message": str(e)})
            except (ValueError, TypeError) as e:
                self._send_json(400, {"message": str(e)})
            except Exception as e:  # pragma: no cover - defensive 500
                self._send_json(500, {"message": f"{type(e).__name__}: {e}"})

        # --------------------------------------------------------- methods

        def _group_with_status(self, di: Any, group: Obj) -> Obj:
            """NodeGroup + live status (current size from the ownership
            label — the store is the source of truth, not a counter)."""
            from kube_scheduler_simulator_tpu_torch.autoscaler.nodegroups import group_nodes

            nodes = sorted(
                n["metadata"]["name"]
                for n in group_nodes(di.cluster_store, group["metadata"]["name"])
            )
            out = dict(group)
            out["status"] = {"currentSize": len(nodes), "nodes": nodes}
            return out

        def do_OPTIONS(self) -> None:  # CORS preflight
            self._send_empty(204)

        def _reject_read_only(self) -> bool:
            """405 every write when the container is a read replica
            (replication/replica.py): the replica's store is owned by
            the journal-shipping applier, and a local mutation would
            fork it from the primary's record stream."""
            if not getattr(di, "read_only", False):
                return False
            data = json.dumps(
                {"message": "read-only replica: writes go to the primary (or promote)"}
            ).encode()
            self.send_response(405)
            self._cors_headers()
            self.send_header("Content-Type", "application/json")
            self.send_header("Allow", "GET, OPTIONS")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return True

        def do_GET(self) -> None:
            r = self._route("GET")
            if r is None:
                return
            di, url, q = r
            note = getattr(di, "note_replica_read", None)
            if note is not None:
                note()
            try:
                if url.path == "/api/v1/replication":
                    status = getattr(di, "replication_status", None)
                    if status is None:
                        self._send_json(404, {"message": "not a replica"})
                    else:
                        self._send_json(200, status())
                    return
                if url.path in ("/", "/index.html"):
                    from kube_scheduler_simulator_tpu_torch.server.webui import HTML

                    self._send_bytes("text/html; charset=utf-8", HTML.encode())
                elif url.path == "/webui.js":
                    from kube_scheduler_simulator_tpu_torch.server.webui import JS

                    self._send_bytes("application/javascript; charset=utf-8", JS.encode())
                elif url.path.startswith("/webui/"):
                    # individual component assets (the page loads the
                    # concatenated /webui.js; these serve component-level
                    # inspection and tests)
                    from kube_scheduler_simulator_tpu_torch.server.webui import MODULES

                    mod = MODULES.get(url.path[len("/webui/") :])
                    if mod is None:
                        self._send_json(404, {"message": "no such UI module"})
                    else:
                        self._send_bytes("application/javascript; charset=utf-8", mod.encode())
                elif url.path == "/api/v1/schedulerconfiguration":
                    self._send_json(200, di.scheduler_service().get_scheduler_config())
                elif url.path in ("/api/v1/metrics", "/metrics"):
                    from kube_scheduler_simulator_tpu_torch.server.metrics import render_metrics

                    data = render_metrics(
                        di, session=self._session, sessions=server.sessions
                    ).encode()
                    self.send_response(200)
                    self._cors_headers()
                    self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif url.path == "/api/v1/autoscaler":
                    svc = di.scheduler_service()
                    asc = svc.autoscaler
                    if asc is None:
                        self._send_json(200, {"mode": "off"})
                    else:
                        self._send_json(200, {"mode": svc.autoscale, **asc.status()})
                elif url.path == "/api/v1/tuning":
                    # the learned scoring head's state: active override,
                    # tunable families/objectives, and the last run's
                    # default-vs-tuned comparison (POST /api/v1/tuning runs one)
                    from kube_scheduler_simulator_tpu_torch.tuning.objective import OBJECTIVES
                    from kube_scheduler_simulator_tpu_torch.tuning.scenario import FAMILIES

                    svc = di.scheduler_service()
                    self._send_json(
                        200,
                        {
                            "pluginWeights": svc.plugin_weights(),
                            "scorePlugins": (
                                svc.score_plugin_names()
                                if svc.framework is not None
                                else []
                            ),
                            "families": sorted(FAMILIES),
                            "objectives": list(OBJECTIVES),
                            "lastReport": svc._last_tuning_report,
                        },
                    )
                elif m := _NODEGROUP_RE.match(url.path):
                    name = m.group(1)
                    if name is None:
                        items = [
                            self._group_with_status(di, g)
                            for g in di.cluster_store.list("nodegroups")
                        ]
                        self._send_json(200, {"items": items})
                    else:
                        g = di.cluster_store.get("nodegroups", name)
                        self._send_json(200, self._group_with_status(di, g))
                elif m := _PODGROUP_RE.match(url.path):
                    from kube_scheduler_simulator_tpu_torch.gang import group_status

                    name = m.group(1)
                    ns = (q.get("namespace") or [None])[0]
                    fw = di.scheduler_service().framework
                    if name is None:
                        items = []
                        for g in di.cluster_store.list("podgroups", ns):
                            out = dict(g)
                            out["status"] = group_status(di.cluster_store, fw, g)
                            items.append(out)
                        self._send_json(200, {"items": items})
                    else:
                        g = di.cluster_store.get("podgroups", name, ns)
                        out = dict(g)
                        out["status"] = group_status(di.cluster_store, fw, g)
                        if (q.get("preview") or [""])[0] in ("1", "true"):
                            # gang-kernel feasibility + victim-search
                            # preview (estimation only) on the container's
                            # device
                            from kube_scheduler_simulator_tpu_torch.gang.engine import (
                                group_preview,
                            )

                            out["status"]["preview"] = group_preview(
                                di.cluster_store, g, device=di.device
                            )
                        self._send_json(200, out)
                elif url.path == "/api/v1/export":
                    self._send_json(200, di.snapshot_service().snap())
                elif url.path == "/api/v1/listwatchresources":
                    self._list_watch(di, q)
                elif url.path.startswith("/api/v1/templates/"):
                    # YAML creation templates per kind (the reference web
                    # UI ships web/components/lib/templates/*.yaml)
                    from kube_scheduler_simulator_tpu_torch.server.webui import TEMPLATES_YAML

                    kind = url.path.rsplit("/", 1)[1]
                    if kind in TEMPLATES_YAML:
                        self._send_yaml(200, TEMPLATES_YAML[kind], raw=True)
                    else:
                        self._send_json(404, {"message": f"no template for {kind}"})
                elif m := _RESOURCE_RE.match(url.path):
                    kind, name = m.group(1), m.group(2)
                    ns = (q.get("namespace") or [None])[0]
                    as_yaml = (q.get("format") or [""])[0] == "yaml"
                    if kind not in KINDS or kind in self._disabled:
                        self._send_json(404, {"message": f"unknown resource kind {kind}"})
                    elif name is None:
                        obj = {"items": di.cluster_store.list(kind, ns)}
                        self._send_yaml(200, obj) if as_yaml else self._send_json(200, obj)
                    else:
                        obj = di.cluster_store.get(kind, name, ns)
                        self._send_yaml(200, obj) if as_yaml else self._send_json(200, obj)
                else:
                    self._send_json(404, {"message": "not found"})
            except NotFoundError as e:
                self._send_json(404, {"message": str(e)})
            except Exception as e:  # pragma: no cover - defensive 500
                self._send_json(500, {"message": f"{type(e).__name__}: {e}"})

        def do_POST(self) -> None:
            r = self._route("POST")
            if r is None:
                return
            di, url, q = r
            if url.path == "/api/v1/replication/promote":
                # the ONE write a replica accepts: failover. 201 with the
                # promotion stats; idempotent (a repeat returns the first
                # promotion's report).
                promote = getattr(di, "promote", None)
                if promote is None:
                    self._send_json(404, {"message": "not a replica"})
                    return
                try:
                    self._send_json(201, promote().stats())
                except Exception as e:
                    self._send_json(500, {"message": f"{type(e).__name__}: {e}"})
                return
            if self._reject_read_only():
                return
            try:
                if url.path == "/api/v1/schedulerconfiguration":
                    body = self._body() or {}
                    # only .Profiles is honored (reference
                    # handler/schedulerconfig.go:39-60)
                    svc = di.scheduler_service()
                    cfg = svc.get_scheduler_config()
                    cfg["profiles"] = copy.deepcopy(body.get("profiles") or [])
                    svc.restart_scheduler(cfg)
                    self._send_empty(202)
                elif url.path == "/api/v1/import":
                    di.snapshot_service().load(self._body() or {})
                    self._send_empty(200)
                elif url.path == "/api/v1/scenarios":
                    from kube_scheduler_simulator_tpu_torch.scenario import ScenarioEngine

                    body = self._body() or {}
                    svc = di.scheduler_service()
                    pw = (body.get("spec") or {}).get("pluginWeights")
                    if pw is not None and svc.framework is not None:
                        # reject a bad weight vector HERE with a 422 —
                        # not as a Failed scenario status deep in the
                        # run; the dry-run checks EVERY profile, exactly
                        # as applying will
                        svc.check_plugin_weights(pw)
                    engine = ScenarioEngine(
                        di.cluster_store, svc, di.controller_manager()
                    )
                    self._send_json(200, engine.run(body))
                elif url.path == "/api/v1/tuning":
                    # run/compare the learned scoring head: tune plugin
                    # weights on scenario families, report default-vs-
                    # tuned objectives (tuning/tuner.run_tuning)
                    self._send_json(
                        200, _run_tuning_request(di.scheduler_service(), self._body() or {})
                    )
                elif url.path == "/api/v1/schedulersimulations":
                    # KEP-184 one-shot runner: one Scenario × N isolated
                    # simulator instances, comparative report in status
                    from kube_scheduler_simulator_tpu_torch.scenario.simulation import (
                        run_scheduler_simulation,
                    )

                    self._send_json(200, run_scheduler_simulation(self._body() or {}, device=di.device))
                elif m := _EXTENDER_RE.match(url.path):
                    verb, id_ = m.group(1), int(m.group(2))
                    ext = di.extender_service()
                    result = getattr(ext, verb)(id_, self._body() or {})
                    self._send_json(200, result)
                elif url.path in ("/api/v1/tpuscorer/filter", "/api/v1/tpuscorer/prioritize"):
                    # extenderv1 endpoint backed by the batch kernel: a
                    # REAL scheduler's extender stanza can point here
                    bridge = di.tpu_scorer_bridge()
                    verb = url.path.rsplit("/", 1)[1]
                    self._send_json(200, getattr(bridge, verb)(self._body() or {}))
                elif (m := _NODEGROUP_RE.match(url.path)) and not m.group(1):
                    # collection URL only (POST to an item URL is 404, not
                    # a silent create of a differently-named group); the
                    # dedicated route ADMITS (validates) node groups — the
                    # generic resources route stores them raw
                    from kube_scheduler_simulator_tpu_torch.autoscaler.nodegroups import (
                        validate_node_group,
                    )

                    body = self._body() or {}
                    validate_node_group(body)
                    self._send_json(201, di.cluster_store.create("nodegroups", body))
                elif (m := _PODGROUP_RE.match(url.path)) and not m.group(1):
                    # the dedicated route ADMITS (validates) pod groups —
                    # the generic resources route stores them raw
                    from kube_scheduler_simulator_tpu_torch.gang import validate_pod_group

                    body = self._body() or {}
                    validate_pod_group(body)
                    self._send_json(201, di.cluster_store.create("podgroups", body))
                elif m := _RESOURCE_RE.match(url.path):
                    kind = m.group(1)
                    if kind not in KINDS or kind in self._disabled:
                        self._send_json(404, {"message": f"unknown resource kind {kind}"})
                    else:
                        self._send_json(201, di.cluster_store.create(kind, self._body() or {}))
                else:
                    self._send_json(404, {"message": "not found"})
            except AlreadyExistsError as e:
                self._send_json(409, {"message": str(e)})
            except NotFoundError as e:
                self._send_json(404, {"message": str(e)})
            except WeightValidationError as e:
                # a malformed plugin-weight vector is a semantic error in
                # an otherwise well-formed request: 422, named clearly
                self._send_json(422, {"message": str(e)})
            except ValueError as e:
                self._send_json(400, {"message": str(e)})
            except IndexError:
                self._send_json(400, {"message": "unknown extender id"})
            except Exception as e:
                self._send_json(500, {"message": f"{type(e).__name__}: {e}"})

        def do_PUT(self) -> None:
            r = self._route("PUT")
            if r is None:
                return
            di, url, q = r
            if self._reject_read_only():
                return
            try:
                if url.path == "/api/v1/reset":
                    di.reset_service().reset()
                    self._send_empty(202)
                elif m := _RESOURCE_RE.match(url.path):
                    kind, name = m.group(1), m.group(2)
                    if kind not in KINDS or kind in self._disabled or name is None:
                        self._send_json(404, {"message": "not found"})
                    else:
                        body = self._body() or {}
                        body.setdefault("metadata", {}).setdefault("name", name)
                        self._send_json(200, di.cluster_store.apply(kind, body))
                else:
                    self._send_json(404, {"message": "not found"})
            except Exception as e:
                self._send_json(500, {"message": f"{type(e).__name__}: {e}"})

        def do_DELETE(self) -> None:
            r = self._route("DELETE")
            if r is None:
                return
            di, url, q = r
            if self._reject_read_only():
                return
            try:
                if (m := _NODEGROUP_RE.match(url.path)) and m.group(1):
                    # deleting a group stops future scaling; its nodes stay
                    # (drain them first via scale-down, or delete directly)
                    di.cluster_store.delete("nodegroups", m.group(1))
                    self._send_empty(200)
                elif (m := _PODGROUP_RE.match(url.path)) and m.group(1):
                    # deleting a PodGroup orphans its member pods — they
                    # fail the PreFilter gate until the group is recreated
                    ns = (q.get("namespace") or [None])[0]
                    di.cluster_store.delete("podgroups", m.group(1), ns)
                    self._send_empty(200)
                elif m := _RESOURCE_RE.match(url.path):
                    kind, name = m.group(1), m.group(2)
                    ns = (q.get("namespace") or [None])[0]
                    if kind not in KINDS or kind in self._disabled or name is None:
                        self._send_json(404, {"message": "not found"})
                    else:
                        di.cluster_store.delete(kind, name, ns)
                        self._send_empty(200)
                else:
                    self._send_json(404, {"message": "not found"})
            except NotFoundError as e:
                self._send_json(404, {"message": str(e)})
            except Exception as e:
                self._send_json(500, {"message": f"{type(e).__name__}: {e}"})

        # ----------------------------------------------------------- watch

        def _list_watch(self, di: Any, q: dict) -> None:
            lrv = {}
            for param, kind in PARAM_KINDS:
                v = (q.get(f"{param}LastResourceVersion") or [""])[0]
                # docs also show the all-lowercase variant (api.md:118-130)
                v = v or (q.get(f"{param}lastResourceVersion") or [""])[0]
                if v:
                    lrv[kind] = v
            self.send_response(200)
            self._cors_headers()
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            handler = self

            class ChunkedStream:
                def write(self, data: bytes) -> None:
                    handler.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

                def flush(self) -> None:
                    handler.wfile.flush()

            try:
                # No heartbeat: this endpoint carries the reference's exact
                # wire format (WatchEvent JSON lines only, streamwriter.go:
                # 41-50), so probe bytes must not be injected.  Like the
                # reference, a dead idle client is only detected at the
                # next event write (or at server stop).
                di.resource_watcher_service().list_watch(ChunkedStream(), lrv, stop=server._stop)
            finally:
                try:
                    handler.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass

    return Handler
