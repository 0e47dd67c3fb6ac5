import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_reference_checks import exec_on_port  # noqa: E402

exec_on_port("test_wirecache", globals())


# ------------------------------------------------------- both packages

from torch_reference_checks import both_servers  # noqa: E402


@pytest.mark.parametrize("wirecache", ["1", "0"])
def test_both_servers_serve_the_same_bytes(wirecache, monkeypatch):
    """Gets and lists over both APIs, with the render-once cache on and
    off: the port's bytes are the reference's."""
    monkeypatch.setenv("KSS_WIRECACHE", wirecache)
    servers = both_servers(use_batch="off")
    try:
        for s in servers:
            st = s.di.cluster_store
            for i in range(6):
                st.create("nodes", {"metadata": {"name": f"n{i}", "labels": {"i": str(i)}}})
                st.create("pods", {"metadata": {"name": f"p{i}", "namespace": "default"},
                                   "spec": {"nodeName": f"n{i % 3}", "containers": [{"name": "c"}]}})
            st.patch("pods", "p2", {"metadata": {"labels": {"touched": "yes"}}}, "default")
        for path, kube in (("/api/v1/resources/pods", False), ("/api/v1/resources/nodes/n3", False),
                           ("/api/v1/pods", True), ("/api/v1/namespaces/default/pods/p2", True),
                           ("/api/v1/nodes?labelSelector=i%3D4", True)):
            got = [s.req("GET", path, kube=kube, raw=True) for s in servers]
            assert got[1][0] == got[0][0] == 200
            assert got[1][1] == got[0][1], path
    finally:
        for s in servers:
            s.close()
