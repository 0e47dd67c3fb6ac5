"""The port's streaming wave pipeline against the JAX package's.

The same seeded feed (tests/test_stream.py's makers and churn, or
cfg9-stream's ``workloads.steady_feed`` at a cut) goes through the JAX
service's ``schedule_stream`` (float64, scoped per test) and the port's on
the CPU (``device="cpu"``: the plain versions stand in for the kernels).
Every pod's ``pod_parity_state`` (binding, annotation trail, failure
conditions) must be equal, and the port's streamed store must equal its own
``streaming=False`` store; the stream counters (``svc.stats``) must agree
with the reference's.  The cases follow tests/test_stream.py; its mesh case
and its ``metrics()`` render case have no port counterpart (the port
refuses a mesh and has no ``metrics()``).  Then the port's own contract: a
launch error propagates out of ``schedule_stream`` with nothing of the
dying wave committed, ``pause_streams`` parks a running session, and a
``PendingBatch`` equals ``schedule()``.  The twin on the card is in
tests/test_torch_stream_gpu.py (a file that does not import JAX).
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.stream import StreamSession as JaxSession  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from test_stream import churn_feed, mk_node, mk_pod  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.stream import StreamSession  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils.parity import parity_digest, pod_parity_state  # noqa: E402

T0 = 1_700_000_000.0
STREAM_KEYS = ("stream_waves", "stream_pods", "stream_drains")


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def new_service(pkg: str, n_nodes: int = 24, use_batch: str = "force", cfg=None, batch_min_work: int = 1,
                tie: str = "first"):
    """A store of ``n_nodes`` test_stream nodes and a started service of the
    port (``pkg="port"``, on the CPU) or of the reference (``"jax"``)."""
    if pkg == "port":
        store, svc_cls, extra = ClusterStore(clock=lambda: T0), SchedulerService, {"device": "cpu"}
    else:
        store, svc_cls, extra = JaxStore(clock=lambda: T0), JaxService, {}
    for i in range(n_nodes):
        store.create("nodes", mk_node(i))
    svc = svc_cls(store, tie_break=tie, use_batch=use_batch, batch_min_work=batch_min_work, **extra)
    svc.start_scheduler(cfg)
    return store, svc


def run_session(pkg: str, streaming: bool, use_batch: str = "force", seed: int = 11, ticks: int = 4,
                giants_at=None, add_node_at=None, n_nodes: int = 24, tie: str = "first", cfg=None):
    store, svc = new_service(pkg, n_nodes=n_nodes, use_batch=use_batch, cfg=cfg, tie=tie)
    svc.schedule_stream(
        feed=churn_feed(store, ticks, seed=seed, giants_at=giants_at, add_node_at=add_node_at),
        streaming=streaming,
    )
    return store, svc


def assert_same(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    bad = [k for k in a if a[k] != b[k]]
    assert not bad, f"{what}: {len(bad)} pods differ, first {bad[:1]}"


def stream_stats(svc) -> dict:
    return {k: svc.stats[k] for k in STREAM_KEYS}


# ---------------------------------------------------------------- parity

# tests/test_stream.py's parity and drain cases over its churn: (run_session
# arguments, drains each streamed run must count at least once, drains it
# must not count, the least number of streamed waves)
CHURN_CASES = {
    "randomized-churn-seed-11": (dict(seed=11), (), (), 3),
    "randomized-churn-seed-29": (dict(seed=29), (), (), 3),
    "force-mode-failure-traces": (dict(giants_at={1}), ("kernel failures",), ("kernel failures (preemption path)",), 3),
    "kernel-failures-preemption-path": (
        dict(use_batch="auto", giants_at={1}), ("kernel failures (preemption path)",), (), 1,
    ),
    "node-change-mid-stream": (dict(add_node_at=2), ("node/config change",), (), 3),
    # 150 nodes sampled at 50 % (100 a pod): the next wave's rotation start
    # is wave k's final_start and its reservoir draws key on the attempt
    # counter wave k reaches
    "sampled-rotation-reservoir": (
        dict(n_nodes=150, tie="reservoir", cfg={"percentageOfNodesToScore": 50}), (), (), 3,
    ),
}


@pytest.mark.parametrize("case", sorted(CHURN_CASES))
def test_streamed_churn_matches_the_reference_and_the_serial_path(case):
    """The port's streamed store equals the JAX service's streamed store
    and the port's own serial store, byte for byte; the stream counters
    equal the reference's."""
    kw, must, must_not, min_waves = CHURN_CASES[case]
    s_port, svc_port = run_session("port", True, **kw)
    s_serial, svc_serial = run_session("port", False, **kw)
    s_jax, svc_jax = run_session("jax", True, **kw)
    got = pod_parity_state(s_port)
    assert_same(got, pod_parity_state(s_jax), "port streamed vs JAX streamed")
    assert_same(got, pod_parity_state(s_serial), "port streamed vs port serial")
    assert stream_stats(svc_port) == stream_stats(svc_jax)
    drains = svc_port.stats["stream_drains"]
    assert all(drains.get(r, 0) >= 1 for r in must), drains
    assert not any(r in drains for r in must_not), drains
    assert svc_port.stats["stream_waves"] >= min_waves and svc_port.stats["stream_pods"] > 0
    # serial mode never overlaps; the streamed run did where nothing gated
    assert svc_serial.stats["stream_overlap_s"] == 0.0
    if not must:
        assert svc_port.stats["stream_overlap_s"] > 0.0
        assert svc_port._batch_engine.encode_stats()["encode_delta_total"] >= 1
    if "giants_at" in kw:
        giant = s_port.get("pods", "pod-36", "default")
        assert not (giant.get("spec") or {}).get("nodeName")
        if kw.get("use_batch", "force") == "force":
            conds = (giant.get("status") or {}).get("conditions") or []
            assert conds and conds[0]["reason"] == "Unschedulable"


def test_streamed_run_matches_schedule_pending_ticks():
    """The streamed run against one ``schedule_pending`` round per feed
    tick, the reference's and the port's."""
    s1, _svc = run_session("port", True, seed=17)
    want = None
    for pkg in ("jax", "port"):
        store, svc = new_service(pkg)
        feed = churn_feed(store, 4, seed=17)
        t = 0
        while feed(t):
            svc.schedule_pending(max_rounds=1)
            t += 1
        state = pod_parity_state(store)
        want = want or state
        assert_same(state, want, f"{pkg} ticks vs JAX ticks")
    assert_same(pod_parity_state(s1), want, "port streamed vs schedule_pending ticks")


def test_cfg9_stream_cut_matches_the_reference():
    """cfg9-stream's shape (``workloads.stream_cluster`` / ``steady_feed``,
    the bench's force mode and first tie-break) at a cut: 40 nodes, 300
    bound pods, 20 arrivals and 20 deletions a tick, a priming tick then 5;
    the three modes of ``time_stream.py`` on the port and the reference's
    streamed run leave equal stores."""
    cut = dict(n_nodes=40, seed_bound=300)
    states, digests = {}, {}
    for pkg, mode in (("port", "sequential"), ("port", "stream_off"), ("port", "streamed"), ("jax", "streamed")):
        if pkg == "port":
            store, svc_cls, extra = ClusterStore(clock=lambda: T0), SchedulerService, {"device": "cpu"}
        else:
            store, svc_cls, extra = JaxStore(clock=lambda: T0), JaxService, {}
        settled = workloads.stream_cluster(store, **cut)
        svc = svc_cls(store, tie_break="first", use_batch="force", **extra)
        svc.start_scheduler(None)
        for n_ticks, start in ((1, 0), (5, 20)):
            feed = workloads.steady_feed(store, settled, n_ticks, start, per_tick=20, seed_bound=cut["seed_bound"])
            if mode == "sequential":
                t = 0
                while feed(t):
                    svc.schedule_pending()
                    t += 1
            else:
                svc.schedule_stream(feed=feed, streaming=mode == "streamed")
        states[(pkg, mode)] = pod_parity_state(store)
        digests[(pkg, mode)] = parity_digest(store)
        if mode == "streamed":
            assert svc.stats["stream_waves"] == 6 and svc.stats["stream_drains"] == {}
            assert svc.stats["stream_overlap_s"] > 0.0
    want = states[("jax", "streamed")]
    assert len(want) == cut["seed_bound"]
    for k, got in states.items():
        assert_same(got, want, f"{k} vs JAX streamed")
    assert len(set(digests.values())) == 1
    # the digest sees one annotation byte
    name = next(k for k, row in want.items() if row[1]).split("/")[1]
    pod = store.get("pods", name, "default")
    ann = dict(pod["metadata"]["annotations"])
    key = sorted(ann)[0]
    ann[key] = ann[key][:-1] + ("x" if ann[key][-1:] != "x" else "y")
    store.patch("pods", name, {"metadata": {"annotations": ann}}, "default")
    assert parity_digest(store) != digests[("jax", "streamed")]


# ---------------------------------------------------------------- drains

def test_gang_waves_never_stream():
    """With the Coscheduling profile every wave drains ("gang"), no streamed
    commit ever interleaves with a parked member, the gang binds whole, and
    the stores equal the reference's."""
    from kube_scheduler_simulator_tpu.gang import gang_scheduler_config as jax_gang_config

    from kube_scheduler_simulator_tpu_torch.gang import POD_GROUP_LABEL, gang_scheduler_config, partially_bound_groups

    def run(pkg: str, streaming: bool = True):
        cfg = gang_scheduler_config() if pkg == "port" else jax_gang_config()
        store, svc = new_service(pkg, n_nodes=12, cfg=cfg, batch_min_work=0)
        store.create("podgroups", {"metadata": {"name": "g"}, "spec": {"minMember": 3, "scheduleTimeoutSeconds": 120}})

        def feed(tick: int) -> bool:
            if tick >= 3:
                return False
            for i in range(tick * 8, (tick + 1) * 8):
                store.create("pods", mk_pod(i))
            if tick == 1:
                for j in range(3):
                    m = mk_pod(600 + j)
                    m["metadata"]["labels"][POD_GROUP_LABEL] = "g"
                    store.create("pods", m)
            return True

        svc.schedule_stream(feed=feed, streaming=streaming)
        return store, svc

    committed_with_parked: list[int] = []
    orig_commit = StreamSession._commit

    def spying_commit(self, flight, overlapped):
        committed_with_parked.append(len(self.svc._all_waiting_keys()))
        return orig_commit(self, flight, overlapped)

    StreamSession._commit = spying_commit
    try:
        store, svc = run("port")
    finally:
        StreamSession._commit = orig_commit
    jstore, jsvc = run("jax")
    serial, _svc0 = run("port", streaming=False)
    assert_same(pod_parity_state(store), pod_parity_state(jstore), "port vs JAX")
    assert_same(pod_parity_state(store), pod_parity_state(serial), "streamed vs serial")
    assert stream_stats(svc) == stream_stats(jsvc)
    assert svc.stats["stream_drains"].get("gang", 0) >= 3 and svc.stats["stream_waves"] == 0
    assert all(n == 0 for n in committed_with_parked)
    assert partially_bound_groups(store) == []
    members = [p for p in store.list("pods") if (p["metadata"].get("labels") or {}).get(POD_GROUP_LABEL)]
    assert len(members) == 3 and all((p.get("spec") or {}).get("nodeName") for p in members)


def test_nominated_pods_drain():
    def run(pkg: str, streaming: bool = True):
        store, svc = new_service(pkg)

        def feed(tick: int) -> bool:
            if tick >= 3:
                return False
            for i in range(tick * 10, (tick + 1) * 10):
                store.create("pods", mk_pod(i))
            if tick == 1:
                nom = mk_pod(700)
                nom["status"] = {"nominatedNodeName": "node-1"}
                store.create("pods", nom)
            return True

        svc.schedule_stream(feed=feed, streaming=streaming)
        return store, svc

    store, svc = run("port")
    jstore, jsvc = run("jax")
    serial, _svc0 = run("port", streaming=False)
    assert_same(pod_parity_state(store), pod_parity_state(jstore), "port vs JAX")
    assert_same(pod_parity_state(store), pod_parity_state(serial), "streamed vs serial")
    assert stream_stats(svc) == stream_stats(jsvc)
    assert svc.stats["stream_drains"].get("nominated pods", 0) >= 1
    assert svc.stats["stream_waves"] >= 1  # resumed after the drain
    assert (store.get("pods", "pod-700", "default").get("spec") or {}).get("nodeName")


def test_unschedulable_requeue_boundary_serializes():
    """A pod parked in unschedulableQ rejoins the stream exactly when the
    serial cadence readmits it: the overlap admission waits for wave k's
    commit (its binds fire move_all)."""
    def run(pkg: str, streaming: bool):
        store, svc = new_service(pkg, n_nodes=4)
        for i in range(6):
            store.create("pods", mk_pod(100 + i))

        def feed(tick: int) -> bool:
            if tick:
                return False
            store.create("pods", mk_pod(0, giant=True))
            return True

        svc.schedule_stream(feed=feed, streaming=streaming, wave_pods=1)
        return store, svc

    store, svc = run("port", True)
    serial, _svc0 = run("port", False)
    jstore, jsvc = run("jax", True)
    assert_same(pod_parity_state(store), pod_parity_state(jstore), "port vs JAX")
    assert_same(pod_parity_state(store), pod_parity_state(serial), "streamed vs serial")
    assert stream_stats(svc) == stream_stats(jsvc)
    assert svc.stats["stream_drains"].get("unschedulable requeue", 0) >= 1
    assert svc.stats["stream_waves"] >= 3
    assert not (store.get("pods", "pod-0", "default").get("spec") or {}).get("nodeName")


# ----------------------------------------------------------------- knobs

def test_env_knob_disables_overlap(monkeypatch):
    monkeypatch.setenv("KSS_STREAM_PIPELINE", "0")
    store, svc = new_service("port")
    sess = StreamSession(svc, feed=churn_feed(store, 2))
    assert sess.streaming is False
    sess.run()
    assert svc.stats["stream_overlap_s"] == 0.0 and svc.stats["stream_waves"] >= 1
    jstore, jsvc = new_service("jax")
    JaxSession(jsvc, feed=churn_feed(jstore, 2)).run()
    assert_same(pod_parity_state(store), pod_parity_state(jstore), "port vs JAX, overlap off")
    monkeypatch.setenv("KSS_STREAM_PIPELINE", "1")
    assert StreamSession(svc).streaming is True
    # the explicit argument wins over the knob
    monkeypatch.setenv("KSS_STREAM_PIPELINE", "0")
    assert StreamSession(svc, streaming=True).streaming is True


@pytest.mark.parametrize("budget", ["in-flight-counted", "per-session"])
def test_max_waves(budget):
    """``max_waves`` counts the in-flight (uncommitted) wave: a cap of 1 is
    ONE streamed wave; and it bounds each session, not the service's
    lifetime counter.  Counters equal the reference's."""
    def run(pkg: str):
        store, svc = new_service(pkg)
        if budget == "in-flight-counted":
            svc.schedule_stream(feed=churn_feed(store, 4), max_waves=1, streaming=True)
            assert svc.stats["stream_waves"] == 1
            return store, svc

        def feed(base):
            def f(tick: int) -> bool:
                if tick >= 2:
                    return False
                for j in range(6):
                    store.create("pods", mk_pod(base + tick * 6 + j))
                return True
            return f

        res1 = svc.schedule_stream(feed=feed(10000), max_waves=2, streaming=True)
        assert len(res1) == 12 and svc.stats["stream_waves"] == 2
        res2 = svc.schedule_stream(feed=feed(20000), max_waves=2, streaming=True)
        assert len(res2) == 12, "the second session never admitted its feed"
        assert svc.stats["stream_waves"] == 4
        return store, svc

    store, svc = run("port")
    jstore, jsvc = run("jax")
    assert_same(pod_parity_state(store), pod_parity_state(jstore), "port vs JAX")
    assert stream_stats(svc) == stream_stats(jsvc)


# ------------------------------------------------- the port's own contract

@pytest.mark.parametrize("failing_launch", [1, 2], ids=["pipeline-empty-launch", "overlap-launch"])
def test_a_launch_error_propagates_and_commits_nothing_of_the_dying_wave(monkeypatch, failing_launch):
    """A launch error inside a streamed wave propagates out of
    ``schedule_stream`` (the reference drains such a wave to the sequential
    path; the port does not hide a kernel).  Launch 2 is the overlap launch
    of wave 2 while wave 1 awaits its commit: neither wave has committed, so
    every pod stays pending, unbound and unannotated.  The session handed
    back its busy slot: ``pause_streams`` does not wait, and a later session
    schedules the same pods."""
    store, svc = new_service("port")
    calls = {"n": 0}
    orig = TB.build_batch_fn

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == failing_launch:
            raise RuntimeError("scan launch failed")
        return orig(*a, **kw)

    monkeypatch.setattr(TB, "build_batch_fn", flaky)
    with pytest.raises(RuntimeError, match="scan launch failed"):
        svc.schedule_stream(feed=churn_feed(store, 4), streaming=True)
    pods = store.list("pods")
    assert len(pods) == 36 * failing_launch
    assert not any((p.get("spec") or {}).get("nodeName") or p["metadata"].get("annotations") for p in pods)
    assert len(svc.pending_pods()) == len(pods)
    assert svc.stats["stream_waves"] == 0 and svc.stats["stream_drains"] == {}
    assert svc._stream_busy == 0
    t0 = time.perf_counter()
    with svc.pause_streams("snapshot load"):
        pass
    assert time.perf_counter() - t0 < 1.0 and "pause timeout" not in svc.stats["stream_drains"]
    monkeypatch.setattr(TB, "build_batch_fn", orig)
    svc.schedule_stream(streaming=True)
    assert not svc.pending_pods() and svc.stats["stream_waves"] == 1


def test_pause_streams_parks_a_running_session_at_a_wave_boundary():
    """``pause_streams`` from a second thread, asked while the feed's second
    tick runs: the session parks at the next empty-pipeline boundary (busy
    slot handed back), counts ONE drain under the reason, and resumes; the
    bytes equal an unpaused serial run's."""
    store, svc = new_service("port")
    base = churn_feed(store, 4)
    asked, inside = threading.Event(), {}

    def pauser():
        with svc.pause_streams("snapshot load"):
            inside["busy"] = svc._stream_busy
            inside["waves"] = svc.stats["stream_waves"]

    thread = threading.Thread(target=pauser)

    def feed(tick: int) -> bool:
        if tick == 1:
            thread.start()
            # the reason is set before this tick's wave can launch
            deadline = time.perf_counter() + 10.0
            while svc._stream_pause_reason is None and time.perf_counter() < deadline:
                time.sleep(0.001)
            asked.set()
        return base(tick)

    svc.schedule_stream(feed=feed, streaming=True)
    thread.join(timeout=30.0)
    assert asked.is_set() and not thread.is_alive()
    assert inside["busy"] == 0 and 1 <= inside["waves"] < svc.stats["stream_waves"]
    assert svc.stats["stream_drains"] == {"snapshot load": 1}
    serial, _svc0 = run_session("port", False)
    assert_same(pod_parity_state(store), pod_parity_state(serial), "paused streamed vs serial")


@pytest.mark.parametrize("n_pending", [40, 0], ids=["wave", "empty-wave"])
def test_pending_batch_equals_schedule(n_pending):
    """``schedule_async`` then ``decisions()`` then ``result()`` on the CPU
    equals ``schedule()`` on the same inputs: selections, the rotation's
    final start (an empty wave's is the start index), every trace array and
    every pod's annotation documents."""
    nodes, all_pods, pending = workloads.cluster(n_pending, 30, seed=5, n_bound=20, spread=lambda i: i % 3 == 0)
    scores = [("NodeResourcesFit", 1), ("PodTopologySpread", 2), ("TaintToleration", 3)]
    kw = dict(base_counter=7, start_index=11)

    def engine():
        return BatchEngine(device="cpu", trace=True, scores=scores, percentage_of_nodes_to_score=50)

    want = engine().schedule(nodes, all_pods, pending, **kw)
    eng = engine()
    pb = eng.schedule_async(nodes, all_pods, pending, **kw)
    dec = pb.decisions()
    assert np.array_equal(pb.selected, want.selected) and pb.final_start == want.final_start
    assert int(dec["final_start"]) == (want.final_start if n_pending else 11)
    got = pb.result()
    assert got is pb.result() and pb._out_dev is None and pb._blob is None
    assert np.array_equal(got.selected, want.selected) and got.final_start == want.final_start
    for k in ("feasible_count", "sample_start", "sample_processed"):
        assert np.array_equal(got.out[k], want.out[k]), k
    for k, v in want.out["trace"].items():
        g = got.out["trace"][k]
        if isinstance(v, list):
            assert len(g) == len(v) and all(np.array_equal(a, b) for a, b in zip(g, v)), k
        else:
            assert np.array_equal(g, v), k
    for i in range(len(pending)):
        assert got.filter_annotation_json(i) == want.filter_annotation_json(i)
        assert got.score_annotations_json(i) == want.score_annotations_json(i)
    lt = eng.last_timings
    assert set(lt) == {"encode_s", "promoted_f64", "lower_s", "device_s", "total_s"} and lt["promoted_f64"] == 0.0
