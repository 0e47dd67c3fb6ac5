import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_reference_checks import exec_on_port  # noqa: E402

exec_on_port("test_server", globals())


# ------------------------------------------------------- both packages

import http.client  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402

from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils.keys import pod_key  # noqa: E402
from torch_reference_checks import Booted, metric_families, normalized, retry_tables  # noqa: E402

PACKAGES = ("kube_scheduler_simulator_tpu", "kube_scheduler_simulator_tpu_torch")


@pytest.fixture()
def both(monkeypatch):
    """The JAX package's server and the port's, each with both APIs on
    ephemeral ports and its background loop running.  float64 everywhere:
    the JAX server's loop and handler threads read the global setting.
    Both packages' retry tables start empty: ``/metrics`` renders the
    process-wide retries, so the two servers' metric families agree only
    where the tables do."""
    monkeypatch.delenv("KSS_AOT_CACHE_DIR", raising=False)
    monkeypatch.delenv("KSS_JOURNAL_DIR", raising=False)
    jax.config.update("jax_enable_x64", True)
    servers = []
    with retry_tables(empty=True):
        try:
            for pkg in PACKAGES:
                servers.append(Booted(pkg, use_batch="auto"))
            yield servers
        finally:
            for s in servers:
                s.close()
        jax.config.update("jax_enable_x64", False)


def idle(server) -> bool:
    """Has the server's loop attempted every pod it was given?  Every
    pending pod of its service is parked in the queue's unschedulableQ: a
    pod in activeQ or backoffQ, or one the queue has not seen yet, is still
    to be attempted.  Both packages' services expose ``pending_pods`` and
    the queue's ``state_snapshot``."""
    svc = server.di.scheduler_service()
    parked = set(svc.queue.state_snapshot()["unschedulable"])
    return all(pod_key(p) in parked for p in svc.pending_pods())


def settle(servers, quiet: float = 0.6, timeout: float = 120.0) -> None:
    """Wait until both loops are idle (``idle``) and no store has changed
    for ``quiet`` seconds since (a round writes its annotations after its
    binds).  Quiet time alone does not show a round is over: a round's
    first launch can take longer than ``quiet`` without writing anything
    (a JAX compile on the reference's side, under a loaded run)."""
    def versions():
        return [s.di.cluster_store.resource_version for s in servers]

    end = time.monotonic() + timeout
    last, since = versions(), time.monotonic()
    while time.monotonic() < end:
        time.sleep(0.1)
        now = versions()
        if now != last or not all(idle(s) for s in servers):
            last, since = now, time.monotonic()
        elif time.monotonic() - since >= quiet:
            return
    raise AssertionError("the loops did not settle: " + json.dumps(
        [{"idle": idle(s), "pending": len(s.di.scheduler_service().pending_pods())} for s in servers]))


def same(servers, method, path, body=None, kube=False):
    """Send one request to both servers; their statuses and bodies must be
    equal (normalized).  Returns the port's answer."""
    got = [s.req(method, path, body, kube=kube) for s in servers]
    (rc, rb, rt), (pc, pb, pt) = got
    assert (pc, pt) == (rc, rt), (method, path, got)
    assert normalized(pb) == normalized(rb), (method, path, first_difference(normalized(pb), normalized(rb)))
    return pc, pb


def first_difference(a, b, at=""):
    """The path and values of the first place two JSON values differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                return first_difference(a.get(k), b.get(k), f"{at}.{k}")
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{at}[{i}]")
    return at, str(a)[:300], str(b)[:300]


def watch_events(port: int, quiet: float = 1.0) -> list:
    """The listwatch stream's events until it is quiet for ``quiet`` s."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=quiet)
    conn.request("GET", "/api/v1/listwatchresources")
    resp = conn.getresponse()
    events, buf = [], b""
    try:
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if line.strip():
                    events.append(json.loads(line))
    except (TimeoutError, OSError):
        pass
    finally:
        conn.close()
    return events


def seeded_cluster():
    nodes, _all, pending = workloads.cluster(40, 16, seed=21)
    return nodes, pending


SCENARIO = {"spec": {"operations": [
    {"id": "n", "step": {"major": 1}, "createOperation": {"typeMeta": {"kind": "Node", "apiVersion": "v1"},
                                                         "object": workloads.mk_node(90)}},
    *({"id": f"p{i}", "step": {"major": 2}, "createOperation": {
        "typeMeta": {"kind": "Pod", "apiVersion": "v1"},
        "object": {"metadata": {"name": f"scn-{i}", "namespace": "default"},
                   "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}]}}}}
      for i in range(3)),
    {"id": "done", "step": {"major": 3}, "doneOperation": {}},
]}}


def test_both_servers_answer_a_seeded_request_sequence_alike(both):
    nodes, pending = seeded_cluster()
    # the snapshot binds one of its pods (spec.nodeName).  The port's loop
    # runs through the import and takes no round before it has landed; the
    # reference's loop could take one over part of it, so it waits
    ref = both[0].di.scheduler_service()
    ref.stop_background()
    same(both, "POST", "/api/v1/import", {"nodes": nodes, "pods": pending[:30]})
    ref.start_background()
    settle(both)
    code, pods = same(both, "GET", "/api/v1/resources/pods")
    assert code == 200 and sum(1 for p in pods["items"] if p["spec"].get("nodeName")) > 20
    # the kube API: create, list and get.  Each write lands on idle loops:
    # its answer carries the store's resourceVersion, which counts what each
    # loop has written since the last write
    for p in pending[30:36]:
        same(both, "POST", "/api/v1/namespaces/default/pods", p, kube=True)
        settle(both)
    same(both, "GET", "/api/v1/namespaces/default/pods", kube=True)
    same(both, "GET", f"/api/v1/namespaces/default/pods/{pending[31]['metadata']['name']}", kube=True)
    same(both, "GET", f"/api/v1/nodes/{nodes[2]['metadata']['name']}", kube=True)
    # the watch stream's initial events
    ev = [watch_events(s.port) for s in both]
    assert ev[1] == ev[0] and len(ev[1]) >= len(nodes) + 36
    same(both, "GET", "/api/v1/export")
    # the scorer bridge: Filter as the reference's; Prioritize as the
    # reference's ORACLE, where the port's kernel pass sees the cluster and
    # the reference's only the candidates (tests/test_torch_scorer_bridge.py)
    names = [n["metadata"]["name"] for n in nodes[:9]]
    _c, passed = same(both, "POST", "/api/v1/tpuscorer/filter", {"pod": pending[37], "nodenames": names})
    code, got, _t = both[1].req("POST", "/api/v1/tpuscorer/prioritize", {"pod": pending[37], "nodenames": passed["nodenames"]})
    by = {n["metadata"]["name"]: n for n in both[0].di.cluster_store.list("nodes")}
    oracle = both[0].di.tpu_scorer_bridge()._prioritize_fallback(pending[37], [by[n] for n in passed["nodenames"]])
    assert code == 200 and got == oracle and len(got) > 2
    # node groups and a PodGroup preview (K7 + K5)
    group = {"metadata": {"name": "pool"}, "spec": {"minSize": 0, "maxSize": 3, "template": {
        "metadata": {"labels": {}}, "status": {"allocatable": {"cpu": "4000m", "memory": "8Gi", "pods": "20"}}}}}
    same(both, "POST", "/api/v1/nodegroups", group)
    same(both, "GET", "/api/v1/nodegroups")
    same(both, "POST", "/api/v1/podgroups", {"metadata": {"name": "train", "namespace": "default"},
                                              "spec": {"minMember": 2}})
    for i in range(2):
        member = json.loads(json.dumps(pending[38 + i]))
        member["metadata"].setdefault("labels", {})["scheduling.x-k8s.io/pod-group"] = "train"
        member["metadata"]["name"] = f"train-{i}"
        same(both, "POST", "/api/v1/resources/pods", member)
        settle(both)
    same(both, "GET", "/api/v1/podgroups/train?namespace=default&preview=1")
    # the tuner at a capped size (K9; K2g with tuner grad), and a scenario
    same(both, "POST", "/api/v1/tuning", {"family": "imbalance", "nodes": 4, "pods": 12, "steps": 1, "pop": 2})
    same(both, "GET", "/api/v1/tuning")
    same(both, "POST", "/api/v1/scenarios", SCENARIO)
    settle(both)
    # the configuration, a restart, metrics and reset
    same(both, "GET", "/api/v1/schedulerconfiguration")
    cfg = both[1].req("GET", "/api/v1/schedulerconfiguration")[1]
    cfg["profiles"][0]["pluginConfig"] = [{"name": "NodeResourcesFit", "args": {"scoringStrategy": {
        "type": "MostAllocated", "resources": [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1}]}}}]
    same(both, "POST", "/api/v1/schedulerconfiguration", cfg)
    same(both, "GET", "/api/v1/schedulerconfiguration")
    for p in pending[30:34]:
        same(both, "PUT", f"/api/v1/resources/pods/{p['metadata']['name']}-again",
             dict(p, metadata=dict(p["metadata"], name=p["metadata"]["name"] + "-again")))
        settle(both)
    same(both, "GET", "/api/v1/resources/pods")
    m = [s.req("GET", "/api/v1/metrics") for s in both]
    assert m[1][0] == m[0][0] == 200 and metric_families(m[1][1]) == metric_families(m[0][1])
    same(both, "PUT", "/api/v1/reset")
    same(both, "GET", "/api/v1/resources/pods")
    same(both, "GET", "/api/v1/resources/nodes")


def test_the_web_ui_bytes_are_the_references(monkeypatch):
    from pathlib import Path

    import kube_scheduler_simulator_tpu.server.webui as ref_ui
    import kube_scheduler_simulator_tpu_torch.server.webui as port_ui

    ref_dir, port_dir = Path(ref_ui._ASSET_DIR), Path(port_ui._ASSET_DIR)
    assert port_dir != ref_dir and port_dir.parent == Path(port_ui.__file__).parent
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in ref_dir.iterdir())
    for p in ref_dir.iterdir():
        assert (port_dir / p.name).read_bytes() == p.read_bytes(), p.name
    servers = [Booted(pkg, use_batch="off") for pkg in PACKAGES]
    try:
        paths = ["/", "/index.html", "/webui.js", "/webui/nope.js", "/api/v1/templates/pods",
                 "/api/v1/templates/nope", *(f"/webui/{m}" for m in ref_ui.MODULE_ORDER)]
        for path in paths:
            got = [s.req("GET", path, raw=True) for s in servers]
            assert got[1] == got[0], path
    finally:
        for s in servers:
            s.close()


def test_a_kernel_error_on_a_route_answers_with_the_error(monkeypatch):
    import kube_scheduler_simulator_tpu_torch.tuning as tuning

    def broken(**_kw):
        raise RuntimeError("kss_scan_cluster_f32 launch failed: invalid argument")

    monkeypatch.setattr(tuning, "run_tuning", broken)
    s = Booted("kube_scheduler_simulator_tpu_torch", use_batch="off")
    try:
        code, body, _t = s.req("POST", "/api/v1/tuning", {"family": "imbalance"})
        assert code == 500 and body == {"message": "RuntimeError: kss_scan_cluster_f32 launch failed: invalid argument"}
    finally:
        s.close()


def test_the_loops_first_exception_surfaces_at_shutdown():
    s = Booted("kube_scheduler_simulator_tpu_torch", use_batch="off")
    svc = s.di.scheduler_service()

    def broken(*_a, **_kw):
        raise RuntimeError("scan launch failed")

    svc.schedule_pending = broken
    s.di.cluster_store.create("nodes", {"metadata": {"name": "n"}, "status": {"allocatable": {"cpu": "1", "pods": "9"}}})
    s.di.cluster_store.create("pods", {"metadata": {"name": "p", "namespace": "default"}, "spec": {"containers": []}})
    end = time.monotonic() + 30
    while svc.is_background_running() and time.monotonic() < end:
        time.sleep(0.02)
    assert not svc.is_background_running()
    with pytest.raises(RuntimeError, match="scan launch failed"):
        s.close()


def test_a_route_that_launches_beside_the_loops_rounds_answers_as_the_reference(both):
    """The tuner's request (K9 in the request thread) runs while the loop
    schedules pods arriving over the kube API; the service takes no lock
    of its own around either.  The tuner's report and the loop's binds are
    the reference's."""
    nodes, pending = seeded_cluster()
    for s in both:
        for n in nodes:
            s.di.cluster_store.create("nodes", n)
    reports: dict = {}

    def tune(i):
        reports[i] = both[i].req("POST", "/api/v1/tuning", {"family": "consolidate", "nodes": 5, "pods": 16,
                                                            "steps": 2, "pop": 3})

    threads = [threading.Thread(target=tune, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    # sent in name order: both stores stamp one creationTimestamp, so the
    # queue orders a round's pods by name, and rounds cut anywhere then
    # replay the same sequence
    for p in sorted(pending[:24], key=lambda p: p["metadata"]["name"]):
        if p["spec"].get("nodeName"):
            continue
        for s in both:
            assert s.req("POST", "/api/v1/namespaces/default/pods", p, kube=True)[0] == 201
    for t in threads:
        t.join()
    settle(both)
    assert reports[1][0] == reports[0][0] == 200
    assert normalized(reports[1][1]) == normalized(reports[0][1])
    same(both, "GET", "/api/v1/resources/pods")


def test_an_import_lands_whole_before_the_loops_next_round():
    """The port's loop holds the quiesce gate a tick: with a fast loop and
    a shortened switch interval, every round the loop takes during and
    after a snapshot load sees the whole snapshot's pending pods."""
    import sys

    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.services.snapshot import SnapshotService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    nodes, pending = seeded_cluster()
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            store = ClusterStore(clock=lambda: 1.7e9)
            svc = SchedulerService(store, use_batch="auto", device="cpu")
            svc.start_scheduler(None)
            seen: list = []
            rounds = svc.schedule_pending

            def counted(*a, **kw):
                seen.append(len(svc.pending_pods()))
                return rounds(*a, **kw)

            svc.schedule_pending = counted
            svc.start_background(poll_interval=0.001)
            try:
                loader = threading.Thread(target=SnapshotService(store, svc).load,
                                          args=({"nodes": nodes, "pods": pending},))
                loader.start()
                loader.join(timeout=60)
                assert not loader.is_alive()
                end = time.monotonic() + 60
                while not seen and time.monotonic() < end:
                    time.sleep(0.01)
            finally:
                svc.stop_background()
            # the snapshot binds one of its pods by spec.nodeName
            assert seen and seen[0] == len(pending) - 1, seen
    finally:
        sys.setswitchinterval(saved)
