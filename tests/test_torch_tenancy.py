import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_reference_checks import exec_on_port  # noqa: E402

exec_on_port("test_tenancy", globals())


# ------------------------------------------------------- both packages

from torch_reference_checks import answer_alike, both_servers, normalized  # noqa: E402


def _pod(name: str) -> dict:
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}]}}


SESSION_STEPS = [
    ("GET", "/api/v1/sessions", None, False),
    ("POST", "/api/v1/sessions", {"id": "t1", "seed": 3}, False),
    ("POST", "/api/v1/sessions", {"id": "t1"}, False),
    ("POST", "/api/v1/sessions", {"id": "Bad_Id"}, False),
    ("POST", "/api/v1/sessions", {"id": "default"}, False),
    ("POST", "/api/v1/sessions", {"useBatch": "sometimes"}, False),
    ("GET", "/api/v1/sessions/t1", None, False),
    ("GET", "/api/v1/sessions/default", None, False),
    ("GET", "/api/v1/sessions/nope", None, False),
    ("POST", "/api/v1/sessions/t1/resources/nodes", {"metadata": {"name": "n1"}}, False),
    ("POST", "/api/v1/sessions/t1/resources/pods", _pod("p1"), False),
    ("GET", "/api/v1/sessions/t1/resources/nodes", None, False),
    ("GET", "/api/v1/resources/nodes", None, False),
    ("GET", "/api/v1/sessions/t1/resources/simulators", None, False),
    ("GET", "/api/v1/sessions/nope/resources/pods", None, False),
    ("GET", "/sessions/t1/api/v1/nodes", None, True),
    ("DELETE", "/api/v1/sessions/t1", None, False),
    ("DELETE", "/api/v1/sessions/t1", None, False),
    ("GET", "/api/v1/sessions", None, False),
]


def test_both_session_planes_answer_alike(monkeypatch):
    monkeypatch.delenv("KSS_JOURNAL_DIR", raising=False)
    servers = both_servers(use_batch="off")
    try:
        answer_alike(servers, SESSION_STEPS)
    finally:
        for s in servers:
            s.close()


def test_a_session_schedules_on_its_own_loop_as_the_reference_does(monkeypatch):
    monkeypatch.delenv("KSS_JOURNAL_DIR", raising=False)
    servers = both_servers(use_batch="off")
    try:
        steps = [("POST", "/api/v1/sessions", {"id": "t2"}, False)]
        steps += [("POST", "/api/v1/sessions/t2/resources/nodes",
                   {"metadata": {"name": f"n{i}"}, "status": {"allocatable": {"cpu": "1", "pods": "10"}}}, False)
                  for i in range(3)]
        steps += [("POST", "/api/v1/sessions/t2/resources/pods", _pod(f"p{i}"), False) for i in range(7)]
        answer_alike(servers, steps)
        for s in servers:
            s.wait_bound(7, di=s.srv.sessions.resolve_di("t2"))
        answer_alike(servers, [("GET", "/api/v1/sessions/t2/resources/pods", None, False)])
    finally:
        for s in servers:
            s.close()


def test_a_journaled_container_recovers_a_crashed_store_as_the_reference_does(tmp_path, monkeypatch):
    """KSS_JOURNAL_DIR: a container's store and scheduler state, abandoned
    without a close (a crash), come back in a fresh container on the same
    directory exactly as the reference's container brings them back."""
    import importlib

    stores = []
    for pkg in ("kube_scheduler_simulator_tpu", "kube_scheduler_simulator_tpu_torch"):
        monkeypatch.setenv("KSS_JOURNAL_DIR", str(tmp_path / pkg))
        di_mod = importlib.import_module(f"{pkg}.server.di")
        store_mod = importlib.import_module(f"{pkg}.state.store")
        kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
        di = di_mod.DIContainer(cluster_store=store_mod.ClusterStore(clock=lambda: 1.7e9), use_batch="off", **kw)
        st = di.cluster_store
        for i in range(4):
            st.create("nodes", {"metadata": {"name": f"n{i}"}, "status": {"allocatable": {"cpu": "2", "pods": "10"}}})
        for i in range(9):
            st.create("pods", _pod(f"p{i}"))
        di.scheduler_service().schedule_pending()
        st.delete("pods", "p3", "default")
        di.scheduler_service().stop_background()
        # crash: nothing closes the journal; a fresh container recovers it
        di2 = di_mod.DIContainer(cluster_store=store_mod.ClusterStore(clock=lambda: 1.7e9), use_batch="off", **kw)
        try:
            stores.append({k: normalized(di2.cluster_store.list(k)) for k in ("nodes", "pods", "namespaces")})
            stores[-1]["config"] = di2.scheduler_service().get_scheduler_config()
        finally:
            di2.close()
    assert stores[1] == stores[0]
    assert sum(1 for p in stores[1]["pods"] if p["spec"].get("nodeName")) == 8
