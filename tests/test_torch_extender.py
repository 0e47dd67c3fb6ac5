"""The port's extender webhooks (scheduler/extender.py) against the JAX
package's: with the same stub extender (the pattern of
tests/test_extender.py) both services give equal binds, equal extender
and scheduling annotation bytes and equal fallback-reason counters, for
the filter, prioritize, bind and preempt verbs and for an extender that is
down, ignorable or not."""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.scheduler import extender as RX  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler import extender as TX  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


class StubExtender(BaseHTTPRequestHandler):
    """A user extender webhook: filters out nodes named *-banned,
    prioritizes node-preferred, keeps only preemption candidates not named
    *-vetoed, accepts binds; answers nodenames callers in kind."""

    seen: list = []

    def log_message(self, fmt, *args):
        pass

    def do_POST(self):
        args = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
        type(self).seen.append(self.path)
        if self.path.endswith("/filter"):
            if args.get("nodenames") is not None:
                names = args["nodenames"]
                out = {"nodenames": [n for n in names if not n.endswith("-banned")],
                       "failedNodes": {n: "banned by extender" for n in names if n.endswith("-banned")}}
            else:
                items = (args.get("nodes") or {}).get("items") or []
                out = {"nodes": {"items": [n for n in items if not n["metadata"]["name"].endswith("-banned")]},
                       "failedNodes": {n["metadata"]["name"]: "banned by extender" for n in items
                                       if n["metadata"]["name"].endswith("-banned")}}
        elif self.path.endswith("/prioritize"):
            names = args.get("nodenames")
            if names is None:
                names = [n["metadata"]["name"] for n in (args.get("nodes") or {}).get("items") or []]
            out = [{"host": n, "score": 10 if n == "node-preferred" else 0} for n in names]
        elif self.path.endswith("/preempt"):
            key = "nodeNameToMetaVictims" if "nodeNameToMetaVictims" in args else "nodeNameToVictims"
            out = {key: {nm: e for nm, e in (args.get(key) or {}).items() if not nm.endswith("-vetoed")}}
        else:
            out = {}
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture(scope="module")
def stub():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), StubExtender)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def node(name: str, cpu: str = "4") -> dict:
    return {"metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": cpu, "memory": "8Gi", "pods": "110"}}}


def pod(name: str, cpu: str = "100m", priority: "int | None" = None, node_name: "str | None" = None) -> dict:
    spec: dict = {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]}
    if priority is not None:
        spec["priority"] = priority
    if node_name:
        spec["nodeName"] = node_name
    return {"metadata": {"name": name, "namespace": "default"}, "spec": spec}


def spread_cluster(store) -> None:
    for nm in ("node-banned", "node-ok", "node-preferred"):
        store.create("nodes", node(nm))
    for i in range(4):
        store.create("pods", pod(f"p{i}"))


def preempt_cluster(names):
    def build(store) -> None:
        for nm in names:
            store.create("nodes", node(nm, cpu="1000m"))
            store.create("pods", pod(f"victim-{nm}", cpu="900m", priority=0, node_name=nm))
        store.create("pods", pod("urgent", cpu="900m", priority=100))
    return build


# case: (the cluster, the extender stanza (urlPrefix filled in), use_batch)
CASES = {
    "filter and prioritize, nodes": (spread_cluster, {"filterVerb": "filter", "prioritizeVerb": "prioritize",
                                                      "weight": 1}, "auto"),
    "filter and prioritize, nodeCacheCapable": (spread_cluster, {"filterVerb": "filter",
                                                                 "prioritizeVerb": "prioritize", "weight": 2,
                                                                 "nodeCacheCapable": True}, "auto"),
    "filter and prioritize, sequential": (spread_cluster, {"filterVerb": "filter", "prioritizeVerb": "prioritize",
                                                           "weight": 1}, "off"),
    "bind verb": (spread_cluster, {"bindVerb": "bind"}, "auto"),
    "preempt verb narrows the candidates": (preempt_cluster(("node-a-vetoed", "node-b")),
                                            {"preemptVerb": "preempt"}, "auto"),
    "preempt verb vetoes every candidate": (preempt_cluster(("node-x-vetoed", "node-y-vetoed")),
                                            {"preemptVerb": "preempt", "nodeCacheCapable": True}, "auto"),
    "down, not ignorable": (spread_cluster, {"urlPrefix": "http://127.0.0.1:1", "filterVerb": "filter"}, "auto"),
    "down, ignorable": (spread_cluster, {"urlPrefix": "http://127.0.0.1:1", "filterVerb": "filter",
                                         "prioritizeVerb": "prioritize", "ignorable": True}, "auto"),
}


def pod_bytes(store) -> dict:
    return {p["metadata"]["name"]: ((p.get("spec") or {}).get("nodeName"), p["metadata"].get("annotations") or {},
                                    (p.get("status") or {}).get("nominatedNodeName"))
            for p in store.list("pods")}


@pytest.mark.parametrize("case", list(CASES))
def test_both_services_give_equal_bytes_binds_and_counters(case, stub):
    build, stanza, use_batch = CASES[case]
    out = []
    for Svc, Store, extra in ((JaxService, JaxStore, {}), (SchedulerService, ClusterStore, {"device": "cpu"})):
        StubExtender.seen = []
        store = Store(clock=lambda: 0.0)
        build(store)
        svc = Svc(store, tie_break="first", use_batch=use_batch, batch_min_work=0, **extra)
        svc.start_scheduler({"extenders": [{"urlPrefix": stub, **stanza}]})
        results = svc.schedule_pending(max_rounds=1)
        out.append((pod_bytes(store), {k: (r.success, r.selected_node, r.nominated_node)
                                       for k, r in results.items()},
                    dict(svc.stats["batch_fallbacks"]), dict(svc.stats["preempt_fallbacks"]),
                    svc.stats["sequential_pods"], sorted(StubExtender.seen)))
    assert out[1] == out[0]
    ext_keys = {k for _n, annos, _nn in out[1][0].values() for k in annos if k.startswith("scheduler-simulator/ext")}
    if "down" not in case:
        assert ext_keys, "no extender result was recorded"
    if use_batch == "auto":
        assert out[1][2] == {"extender webhooks configured": 1}


def test_the_cycle_reads_the_extender_as_the_reference_does(stub):
    """Spot values behind the byte equality: the extender's score decides,
    its failures reach the diagnosis, and the annotation records the
    webhook's raw response."""
    store = ClusterStore(clock=lambda: 0.0)
    spread_cluster(store)
    svc = SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0, device="cpu")
    svc.start_scheduler({"extenders": [{"urlPrefix": stub, "filterVerb": "filter", "prioritizeVerb": "prioritize",
                                        "weight": 1}]})
    svc.schedule_pending(max_rounds=1)
    p0 = store.get("pods", "p0")
    assert p0["spec"]["nodeName"] == "node-preferred"
    annos = p0["metadata"]["annotations"]
    assert json.loads(annos[TX.EXTENDER_FILTER_RESULT])[stub]["failedNodes"] == {"node-banned": "banned by extender"}
    scores = {e["host"]: e["score"] for e in json.loads(annos[TX.EXTENDER_PRIORITIZE_RESULT])[stub]}
    assert scores["node-preferred"] == 10 and svc.extender_service is svc.framework.extender_service


def test_the_batched_post_filter_declines_preempt_verb_extenders(stub):
    from kube_scheduler_simulator_tpu_torch.preemption.engine import prepare_round

    store = ClusterStore(clock=lambda: 0.0)
    svc = SchedulerService(store, device="cpu")
    svc.start_scheduler({"extenders": [{"urlPrefix": stub, "preemptVerb": "preempt"}]})
    assert prepare_round(svc.framework, None, None, store, [], []) == (None, "preempt-verb extenders configured")


@pytest.mark.parametrize("timeout", [None, "100ms", "2s", "1m", 2_500_000_000, "bogus"])
def test_extender_configs_parse_alike(timeout):
    cfg = {"urlPrefix": "http://x/", "filterVerb": "f", "weight": 3, "managedResources": [{"name": "gpu"}],
           "ignorable": True}
    if timeout is not None:
        cfg["httpTimeout"] = timeout
    a, b = RX.HTTPExtender(cfg), TX.HTTPExtender(cfg)
    assert vars(a) == vars(b)
    gpu_pod = {"spec": {"containers": [{"resources": {"limits": {"gpu": "1"}}}]}}
    assert (a.is_interested(gpu_pod), a.is_interested(pod("p"))) == (b.is_interested(gpu_pod),
                                                                      b.is_interested(pod("p")))


def test_the_simulator_override_rewrites_alike():
    cfg = {"extenders": [
        {"urlPrefix": "https://user-ext:8443/scheduler", "filterVerb": "filter", "bindVerb": "bind",
         "enableHTTPS": True, "tlsConfig": {"insecure": True}},
        {"urlPrefix": "http://other/x", "prioritizeVerb": "prio", "preemptVerb": "p"},
    ]}
    a, b = json.loads(json.dumps(cfg)), json.loads(json.dumps(cfg))
    RX.override_extenders_cfg_to_simulator(a, 1212)
    TX.override_extenders_cfg_to_simulator(b, 1212)
    assert a == b and b["extenders"][0]["filterVerb"] == "filter/0"
