import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_reference_checks import exec_on_port  # noqa: E402

exec_on_port("test_kubeapi", globals())


# ------------------------------------------------------- both packages

from torch_reference_checks import answer_alike, both_servers  # noqa: E402


def node(name: str) -> dict:
    return {"metadata": {"name": name, "labels": {"zone": name[-1]}},
            "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "110"}}}


def pod(name: str, **meta) -> dict:
    return {"metadata": {"name": name, "namespace": "default", **meta},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}]}}


K = True
SCRIPTS = {
    "discovery": [("GET", p, None, K) for p in ("/api", "/api/v1", "/apis", "/apis/storage.k8s.io/v1", "/version")],
    "crud": [
        ("POST", "/api/v1/nodes", node("n-a"), K),
        ("POST", "/api/v1/namespaces/default/pods", pod("p-1", labels={"app": "web"}), K),
        ("POST", "/api/v1/namespaces/default/pods", pod("p-1"), K),
        ("GET", "/api/v1/pods", None, K),
        ("GET", "/api/v1/namespaces/default/pods/p-1", None, K),
        ("POST", "/api/v1/namespaces/default/pods/p-1/binding", {"target": {"kind": "Node", "name": "n-a"}}, K),
        ("PATCH", "/api/v1/namespaces/default/pods/p-1", {"metadata": {"labels": {"tier": "fe"}}}, K),
        ("PUT", "/api/v1/namespaces/default/pods/p-1", pod("p-1", labels={"app": "db"}), K),
        ("GET", "/api/v1/namespaces/default/pods?labelSelector=app%3Ddb", None, K),
        ("GET", "/api/v1/pods?fieldSelector=spec.nodeName%3Dn-a", None, K),
        ("DELETE", "/api/v1/namespaces/default/pods/p-1", None, K),
        ("GET", "/api/v1/namespaces/default/pods/p-1", None, K),
    ],
    "a PUT of a missing object without a resourceVersion is 404": [
        ("PUT", "/api/v1/namespaces/default/pods/ghost", pod("ghost"), K),
        ("PUT", "/api/v1/nodes/ghost-node", node("ghost-node"), K),
        ("GET", "/api/v1/pods", None, K),
    ],
    "groups": [
        ("POST", "/apis/storage.k8s.io/v1/storageclasses", {"metadata": {"name": "fast"}, "provisioner": "x"}, K),
        ("GET", "/apis/storage.k8s.io/v1/storageclasses", None, K),
        ("POST", "/apis/policy/v1/namespaces/default/poddisruptionbudgets",
         {"metadata": {"name": "pdb"}, "spec": {"minAvailable": 1}}, K),
        ("GET", "/apis/policy/v1/namespaces/default/poddisruptionbudgets/pdb", None, K),
        ("GET", "/apis/no.such.group/v1/things", None, K),
    ],
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_both_kube_apis_answer_alike(script):
    servers = both_servers(use_batch="off")
    try:
        answer_alike(servers, SCRIPTS[script])
    finally:
        for s in servers:
            s.close()
