"""The port's snapshot, reset, watcher and importer services against the
JAX package's.

Each case of tests/test_services.py (:38-238) runs through both packages
with the store clocks pinned (``SimClock``): the JAX package in float64,
scoped per test, the port on the CPU (``device="cpu"``).  The case's own
assertions hold on each, and the stores' ``dump()``, the pods' states and
the snapshots or watch streams must be byte-equal.  Then the port's own
contract at a scheduled store: a ``snap()`` loaded into a fresh store and
service (batch rounds on the plain versions) gives the same dump modulo
uid and resourceVersion, ``ResetService.reset()`` restores the boot state
and configuration, and a load parks a running stream session through
``pause_streams``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import types
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tests.test_services import _MemStream, _node, _pod  # noqa: E402
from tests.test_torch_scenario import JAX, PORT, T0, assert_same_bytes, dumped  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def services(P) -> types.SimpleNamespace:
    if P is PORT:
        from kube_scheduler_simulator_tpu_torch.services import importer, reset, resourcewatcher, snapshot
    else:
        from kube_scheduler_simulator_tpu.services import importer, reset, resourcewatcher, snapshot
    return types.SimpleNamespace(
        Snapshot=snapshot.SnapshotService, Reset=reset.ResetService, Watcher=resourcewatcher.ResourceWatcherService,
        Importer=importer.ClusterResourceImporter, KubeSource=importer.KubeClusterSnapSource,
    )


def build(P, **svc_kw):
    store = P.Store(clock=P.Clock(T0))
    svc = P.Service(store, **svc_kw)
    svc.start_scheduler(None)
    return store, svc, services(P).Snapshot(store, svc)


def assert_same_stores(port_store, ref_store) -> None:
    assert_same_bytes("store dump", dumped(port_store.dump()), dumped(ref_store.dump()))
    assert_same_bytes("pod states", dumped(pod_parity_state(port_store)), dumped(pod_parity_state(ref_store)))


# ------------------------------------------------------------- the cases
# each returns (what the case exported or streamed, the store it leaves)

def snap_shape_and_filters(P):
    store, _svc, snap = build(P)
    store.create("nodes", _node("n1"))
    store.create("pods", _pod("p1"))
    store.create("priorityclasses", {"metadata": {"name": "user-pc"}, "value": 100})
    store.create("priorityclasses", {"metadata": {"name": "system-node-critical"}, "value": 2000001000})
    for ns in ("team-a", "kube-system", "default"):
        store.create("namespaces", {"metadata": {"name": ns}})
    out = snap.snap()
    assert set(out) == {"pods", "nodes", "pvs", "pvcs", "storageClasses", "priorityClasses", "namespaces",
                        "schedulerConfig"}
    assert [p["metadata"]["name"] for p in out["priorityClasses"]] == ["user-pc"]
    assert [n["metadata"]["name"] for n in out["namespaces"]] == ["team-a"]
    assert out["schedulerConfig"]["kind"] == "KubeSchedulerConfiguration"
    return out, store


def load_applies_and_rebinds_pv_claimrefs(P):
    store, _svc, snap = build(P)
    snap.load({
        "namespaces": [{"metadata": {"name": "team-a"}}],
        "nodes": [_node("n1")],
        "pods": [_pod("p1", "team-a")],
        "pvcs": [{"metadata": {"name": "claim", "namespace": "team-a", "uid": "stale-uid"}, "spec": {}}],
        "pvs": [{"metadata": {"name": "pv1", "uid": "stale-pv-uid"},
                 "spec": {"claimRef": {"name": "claim", "namespace": "team-a", "uid": "stale-uid"}},
                 "status": {"phase": "Bound"}}],
        "storageClasses": [{"metadata": {"name": "fast"}, "provisioner": "x"}],
        "priorityClasses": [{"metadata": {"name": "high"}, "value": 999}],
        "schedulerConfig": None,
    }, ignore_scheduler_configuration=True)
    pvc = store.get("persistentvolumeclaims", "claim", "team-a")
    pv = store.get("persistentvolumes", "pv1")
    assert pv["spec"]["claimRef"]["uid"] == pvc["metadata"]["uid"] != "stale-uid"
    return None, store


def snap_load_round_trip(P):
    store, _svc, snap = build(P)
    store.create("nodes", _node("n1"))
    store.create("pods", _pod("p1"))
    exported = snap.snap()
    store2, svc2, snap2 = build(P)
    snap2.load(exported)
    assert [n["metadata"]["name"] for n in store2.list("nodes")] == ["n1"]
    assert [p["metadata"]["name"] for p in store2.list("pods")] == ["p1"]
    assert svc2.get_scheduler_config()["kind"] == "KubeSchedulerConfiguration"
    return exported, store2


def reset_restores_boot_state_and_config(P):
    store, svc, _snap = build(P)
    store.create("nodes", _node("boot-node"))
    reset = services(P).Reset(store, svc)
    store.create("nodes", _node("later-node"))
    store.create("pods", _pod("later-pod"))
    svc.restart_scheduler({"profiles": [{"schedulerName": "custom", "plugins": {"multiPoint": {
        "enabled": [{"name": "NodeResourcesFit"}], "disabled": [{"name": "*"}]}}}]})
    assert svc.get_scheduler_config()["profiles"][0]["schedulerName"] == "custom"
    reset.reset()
    assert [n["metadata"]["name"] for n in store.list("nodes")] == ["boot-node"]
    assert store.list("pods") == []
    assert svc.get_scheduler_config()["profiles"][0]["schedulerName"] == "default-scheduler"
    return svc.get_scheduler_config(), store


def watcher_lists_then_watches(P):
    store = P.Store(clock=P.Clock(T0))
    store.create("nodes", _node("n1"))
    stream, stop = _MemStream(), threading.Event()
    t = threading.Thread(target=services(P).Watcher(store).list_watch, args=(stream, {}, stop), daemon=True)
    t.start()
    time.sleep(0.3)
    store.create("pods", _pod("p1"))
    deadline = time.time() + 3
    while time.time() < deadline and not any(e["Kind"] == "pods" for e in stream.lines()):
        time.sleep(0.05)
    stop.set()
    t.join(timeout=3)
    events = stream.lines()
    assert events[0]["Kind"] == "nodes" and events[0]["EventType"] == "ADDED"
    assert any(e["Kind"] == "pods" and e["Obj"]["metadata"]["name"] == "p1" for e in events)
    return events, store


def watcher_resumes_from_resource_version(P):
    store = P.Store(clock=P.Clock(T0))
    rv = store.create("nodes", _node("n1"))["metadata"]["resourceVersion"]
    store.create("nodes", _node("n2"))
    stream, stop = _MemStream(), threading.Event()
    t = threading.Thread(target=services(P).Watcher(store).list_watch, args=(stream, {"nodes": rv}, stop),
                         daemon=True)
    t.start()
    time.sleep(0.3)
    stop.set()
    t.join(timeout=3)
    events = stream.lines()
    assert [e["Obj"]["metadata"]["name"] for e in events if e["Kind"] == "nodes"] == ["n2"]
    return events, store


def import_cluster_resources(P):
    src_store, _src_svc, src_snap = build(P)
    src_store.create("nodes", _node("external-node"))
    src_store.create("pods", _pod("external-pod"))
    dst_store, _dst_svc, dst_snap = build(P)
    services(P).Importer(src_snap, dst_snap).import_cluster_resources()
    assert [n["metadata"]["name"] for n in dst_store.list("nodes")] == ["external-node"]
    assert [p["metadata"]["name"] for p in dst_store.list("pods")] == ["external-pod"]
    return None, dst_store


def import_live_cluster_via_stubbed_kube_client(P):
    listed: list = []

    class StubClient:
        def list_kind(self, path: str) -> dict:
            listed.append(path)
            if path.endswith("/nodes"):
                return {"items": [_node("live-node")]}
            if path.endswith("/pods"):
                pod = _pod("live-pod")
                pod["metadata"]["managedFields"] = [{"manager": "kubelet"}]
                return {"items": [pod]}
            if path.endswith("/namespaces"):
                return {"items": [{"metadata": {"name": "team-a"}}]}
            return {"items": []}

    S = services(P)
    dst_store, _dst_svc, dst_snap = build(P)
    S.Importer(S.KubeSource(client=StubClient()), dst_snap).import_cluster_resources()
    assert len(listed) == 7 and any("storage.k8s.io" in p for p in listed)
    pods = dst_store.list("pods")
    assert [p["metadata"]["name"] for p in pods] == ["live-pod"] and "managedFields" not in pods[0]["metadata"]
    return listed, dst_store


CASES = {f.__name__: f for f in (
    snap_shape_and_filters, load_applies_and_rebinds_pv_claimrefs, snap_load_round_trip,
    reset_restores_boot_state_and_config, watcher_lists_then_watches, watcher_resumes_from_resource_version,
    import_cluster_resources, import_live_cluster_via_stubbed_kube_client,
)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_service_case_matches_the_reference(case):
    (out_p, store_p), (out_j, store_j) = CASES[case](PORT), CASES[case](JAX)
    assert_same_bytes("exported", dumped(out_p), dumped(out_j))
    assert_same_stores(store_p, store_j)


# ------------------------------------------------------------ port contract

def strip_ids(dump: dict) -> str:
    """A store dump without uids and resourceVersions (a load re-applies
    every object, so both are the new store's own)."""
    out = {}
    for kind, objs in dump.items():
        rows = []
        for o in objs:
            meta = {k: v for k, v in o["metadata"].items() if k not in ("uid", "resourceVersion")}
            rows.append({**o, "metadata": meta})
        out[kind] = rows
    return dumped(out)


def scheduled_store(P):
    """cfg11-scenario at a cut, replayed through batch rounds."""
    store = P.Store(clock=P.Clock(T0))
    svc = P.Service(store, tie_break="first", use_batch="auto", batch_min_work=0, clock=P.Clock(0.0))
    svc.start_scheduler({"percentageOfNodesToScore": 100})
    out = P.Engine(store, svc, P.CM(store)).run(workloads.scenario_churn(24, 60, 3, web=4, cordon=2))
    assert out["status"]["phase"] == "Succeeded"
    return store, svc


def test_snapshot_load_into_a_fresh_service_and_reset():
    """A scheduled store's ``snap()`` loaded into a fresh store and service
    gives the same objects (the snapshot's kinds) modulo uid and
    resourceVersion, the configuration included; the fresh service's
    ``ResetService`` (captured at its boot) then restores the empty boot
    state and the boot configuration.  Both packages load the same bytes."""
    loaded = {}
    for P in (PORT, JAX):
        store, _svc = scheduled_store(P)
        S = services(P)
        exported = S.Snapshot(store, _svc).snap()
        fresh = P.Store(clock=P.Clock(T0))
        svc2 = P.Service(fresh, tie_break="first", use_batch="auto", batch_min_work=0)
        svc2.start_scheduler(None)
        boot_dump, boot_cfg = dumped(fresh.dump()), svc2.get_scheduler_config()
        reset = S.Reset(fresh, svc2)
        S.Snapshot(fresh, svc2).load(exported)
        assert svc2.get_scheduler_config() == exported["schedulerConfig"] != boot_cfg
        kinds = ("pods", "nodes", "persistentvolumes", "persistentvolumeclaims", "storageclasses",
                 "priorityclasses")
        want = {k: v for k, v in store.dump().items() if k in kinds}
        got = {k: v for k, v in fresh.dump().items() if k in kinds}
        assert_same_bytes("loaded store", strip_ids(got), strip_ids(want))
        assert not svc2.pending_pods() and svc2.schedule_pending() == {}
        loaded[P.name] = dumped(fresh.dump())
        reset.reset()
        assert dumped(fresh.dump()) == boot_dump and svc2.get_scheduler_config() == boot_cfg
    assert_same_bytes("port load vs reference load", loaded["port"], loaded["jax"])


def test_a_load_parks_a_running_stream_session():
    """``SnapshotService.load`` runs under ``pause_streams("snapshot
    load")``: a session streaming beside it parks at a wave boundary (one
    drain counted under that reason) and resumes after the load."""
    from tests.test_stream import churn_feed, mk_node as stream_node

    store = PORT.Store(clock=lambda: T0)
    for i in range(24):
        store.create("nodes", stream_node(i))
    svc = PORT.Service(store, tie_break="first", use_batch="force", batch_min_work=1)
    svc.start_scheduler(None)
    snap = services(PORT).Snapshot(store, svc)
    feed = churn_feed(store, 12, seed=11)
    started = threading.Event()

    def slow_feed(tick: int) -> bool:
        started.set()
        time.sleep(0.02)
        return feed(tick)

    t = threading.Thread(target=svc.schedule_stream, kwargs=dict(feed=slow_feed), daemon=True)
    t.start()
    assert started.wait(10)
    snap.load({"nodes": [_node("loaded-node")], "schedulerConfig": None}, ignore_scheduler_configuration=True)
    t.join(timeout=60)
    assert not t.is_alive()
    assert svc.stats["stream_drains"].get("snapshot load", 0) == 1
    assert store.get("nodes", "loaded-node")
    assert json.loads(json.dumps(svc.metrics()["stream_drains_by_reason"]))["snapshot load"] == 1
