"""Run a JAX-package test file's checks against the port.

``exec_on_port(name, namespace)`` compiles ``tests/<name>.py`` with the
package name changed to the port's and every ``DIContainer(...)`` and
``run_scheduler_simulation(...)`` call given ``device="cpu"`` (the port's
entry points run on the card unless the caller asks for the CPU), and
executes it into ``namespace``: the calling test module then holds the
reference's fixtures and tests, each one a check of the port that the
reference passes."""

from __future__ import annotations

import contextlib
import functools
import importlib
import re
from pathlib import Path

import pytest

ON_CPU = ("DIContainer", "run_scheduler_simulation")


def on_cpu(fn):
    return functools.partial(fn, device="cpu")


def port_source(name: str, on_cpu_calls: "tuple[str, ...]" = ()) -> str:
    src = (Path(__file__).resolve().parent / f"{name}.py").read_text()
    src = re.sub(r"\bkube_scheduler_simulator_tpu\b", "kube_scheduler_simulator_tpu_torch", src)
    for fn in ON_CPU + tuple(on_cpu_calls):
        src = re.sub(rf"(?<![\w.]){fn}\(", f"_on_cpu({fn})(", src)
    return src


def exec_on_port(name: str, namespace: dict, on_cpu_calls: "tuple[str, ...]" = ()) -> None:
    """``on_cpu_calls`` names more callables of the file that take
    ``device=`` in the port and get ``device="cpu"``."""
    namespace["_on_cpu"] = on_cpu
    namespace["_port_substrate_reset"] = _port_substrate_reset
    exec(compile(port_source(name, on_cpu_calls), f"tests/{name}.py, on the port", "exec"), namespace)


@contextlib.contextmanager
def retry_tables(empty: bool):
    """Both packages' per-seam retry tables (``resilience.retry_stats``) are
    process-wide and outlive a test file in a pytest-xdist worker: within
    the block they are empty when ``empty`` says so, and after it they are
    as they were before it."""
    mods = [importlib.import_module(f"{pkg}.resilience")
            for pkg in ("kube_scheduler_simulator_tpu", "kube_scheduler_simulator_tpu_torch")]
    before = [m.retry_stats() for m in mods]
    if empty:
        for m in mods:
            m.reset_retry_stats()
    try:
        yield
    finally:
        for m, table in zip(mods, before):
            m.reset_retry_stats()
            for seam, n in table.items():
                m.note_retry(seam, n)


@pytest.fixture(autouse=True)
def _port_substrate_reset():
    """The port's twin of tests/conftest.py's substrate reset: the port's
    process-wide substrate is dropped after each test of the module."""
    yield
    from kube_scheduler_simulator_tpu_torch.tenancy.substrate import SUBSTRATE

    SUBSTRATE.clear()


# ------------------------------------------------- both packages' servers

CLOCK = 1_700_000_000.0


def http(port: int, method: str, path: str, body=None, headers: "dict | None" = None, timeout: float = 60.0,
         raw: bool = False):
    """(status, parsed JSON body or, with ``raw``, the bytes, content type)
    of one request."""
    import json
    import urllib.error
    import urllib.request

    payload = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=payload, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, data, ctype = resp.status, resp.read(), resp.headers.get("Content-Type") or ""
    except urllib.error.HTTPError as e:
        code, data, ctype = e.code, e.read(), e.headers.get("Content-Type") or ""
    if data and "json" in ctype and not raw:
        return code, json.loads(data), ctype
    return code, data, ctype


class Booted:
    """One package's DIContainer and SimulatorServer on ephemeral ports
    (both APIs), its store on a fixed clock."""

    def __init__(self, pkg: str, **kw):
        import importlib

        server = importlib.import_module(f"{pkg}.server")
        store = importlib.import_module(f"{pkg}.state.store")
        if pkg.endswith("_torch"):
            kw.setdefault("device", "cpu")
        self.di = server.DIContainer(cluster_store=store.ClusterStore(clock=lambda: CLOCK), **kw)
        self.srv = server.SimulatorServer(self.di, port=0, kube_api_port=0)
        self.port = self.srv.start(background=True)
        self.kube = self.srv.kube_api_port

    def req(self, method: str, path: str, body=None, kube: bool = False, headers=None, raw: bool = False):
        return http(self.kube if kube else self.port, method, path, body, headers, raw=raw)

    def wait_bound(self, n: int, timeout: float = 120.0, di=None) -> None:
        import time

        store = (di or self.di).cluster_store
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if sum(1 for p in store.list("pods", copy_objects=False) if p["spec"].get("nodeName")) >= n:
                # a round writes annotations after its binds: wait until
                # the store is quiet
                rv = store.resource_version
                time.sleep(0.3)
                if store.resource_version == rv:
                    return
                continue
            time.sleep(0.05)
        raise AssertionError(f"fewer than {n} pods bound within {timeout} s")

    def close(self) -> None:
        self.srv.shutdown()


def normalized(obj):
    """Drop what differs between two runs of the same requests: wall-clock
    stamps (a session's store reads the wall clock) and the per-process
    values of session listings."""
    if isinstance(obj, dict):
        return {k: normalized(v) for k, v in obj.items() if k not in ("createdAt", "idleSeconds", "startTime",
                                                                        "completionTime", "lastTransitionTime",
                                                                        "creationTimestamp")}
    if isinstance(obj, list):
        return [normalized(v) for v in obj]
    return obj


def metric_families(text: bytes) -> "dict[str, str]":
    """Prometheus text → {metric name: type}."""
    out = {}
    for line in text.decode().splitlines():
        if line.startswith("# TYPE "):
            _h, _t, name, typ = line.split(" ", 3)
            out[name] = typ
    return out


def both_servers(**kw) -> "list[Booted]":
    """The JAX package's server and the port's (in that order)."""
    return [Booted("kube_scheduler_simulator_tpu", **kw), Booted("kube_scheduler_simulator_tpu_torch", **kw)]


def answer_alike(servers, steps) -> list:
    """Send each (method, path, body, kube API?) step to both servers; the
    statuses, content types and normalized bodies must be equal.  Returns
    the port's answers."""
    out = []
    for method, path, body, kube in steps:
        (rc, rb, rt), (pc, pb, pt) = (s.req(method, path, body, kube=kube) for s in servers)
        assert (pc, pt) == (rc, rt), (method, path, pc, rc, pb, rb)
        assert normalized(pb) == normalized(rb), (method, path, pb, rb)
        out.append((pc, pb))
    return out
