"""The port's service lifecycle against the JAX package's: restart with
rollback, reset, shutdown, ``metrics()`` and the background loop.

Byte cases run the same objects through both packages (the JAX package in
float64, scoped per test; the port on the CPU, ``device="cpu"``, with
``use_batch`` "off" or "auto" and ``batch_min_work=0``, so the plain
versions run) and require equal store dumps and pod states.  ``metrics()``
must return exactly the reference's keys, and the counters both packages
count (``COUNTERS``) must be equal after a batch round, a gang round
(tests/test_gang.py:558), streamed runs (tests/test_stream.py's cases), a
tuning run (tests/test_tuning.py:512) and the queue sequences of
tests/test_scheduling_queue.py.  The loop: the bounded-attempts case of
tests/test_soak.py:195 through both packages, its first round equal to
``schedule_pending(max_rounds=1, respect_backoff=True)`` on a twin store and
to the reference loop's, ``autoscale="scenario"`` against "on" in the
loop, an idle tick launching no scan, and the port's one deliberate
difference: the loop stops at its first exception and ``stop_background()``
re-raises it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tests.test_autoscaler import mk_group, mk_pod as asc_pod  # noqa: E402
from tests.test_gang import mk_group as gang_group, mk_member, mk_node as gang_node  # noqa: E402
from tests.test_schedule_e2e import make_node, make_pod  # noqa: E402
from tests.test_scheduling_queue import FakeClock, mk_node as q_node, mk_pod as q_pod  # noqa: E402
from tests.test_stream import churn_feed, mk_node as stream_node  # noqa: E402
from tests.test_torch_scenario import JAX, PORT, T0, assert_same_bytes, dumped  # noqa: E402
from tests.test_tuning import PLUGINS, _cluster  # noqa: E402
from tests.test_batch_parity import profile_with  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops.kernels import KernelBuildError  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state  # noqa: E402

# the metrics() counters both packages count in the same meaning
COUNTERS = (
    "batch_commits", "batch_pods", "batch_restarts", "sequential_pods", "batch_fallbacks", "commit_waves",
    "preempt_attempts", "preempt_nominations", "preempt_victims", "preempt_dispatches", "preempt_fallbacks",
    "gang_rounds", "gang_parked", "gang_released_groups", "gang_released_pods", "gang_kernel_dispatches",
    "gang_verdict_mismatch", "gang_fallbacks", "stream_waves_total", "stream_pods_total",
    "stream_drains_by_reason", "tuning_runs_total", "tuning_rollouts_total", "tuning_grad_dispatches_total",
    "plugin_weights_overridden", "waiting_pods", "permit_wait_expired", "queue_active", "queue_backoff",
    "queue_unschedulable", "queue_moves", "queue_flushes", "engine_rounds", "encode_full_total",
    "encode_delta_total", "encode_fallbacks_by_reason",
)
# keys of subsystems the port has not ported: the reference's value with
# the subsystem off
OFF = {
    "journal_enabled": 0, "journal_records_total": 0, "journal_bytes_written_total": 0, "journal_fsyncs_total": 0,
    "journal_wedges_total": 0, "journal_records_dropped_total": 0, "journal_degraded_by_errno": {},
    "checkpoint_compactions_total": 0, "recovery_replayed_records_total": 0, "recovery_truncated_records_total": 0,
    "recovery_partial_gangs_total": 0, "shard_devices": 0, "sharded_dispatches_total": 0,
    "plane_shard_bytes_per_device": 0, "placer_bank_rotations_total": 0, "placer_banks": {},
    "aot_cache_hits_total": 0, "aot_cache_misses_total": 0, "aot_cache_saves_total": 0,
    "aot_cache_fallbacks_by_reason": {}, "fuzz_scenarios_total": 0, "fuzz_divergences_by_kind": {},
    "fuzz_shrink_steps_total": 0, "procmesh": None, "retry_by_seam": {},
}


@pytest.fixture(autouse=True)
def _x64(monkeypatch):
    # both packages' AOT caches stay off
    monkeypatch.delenv("KSS_AOT_CACHE_DIR", raising=False)
    with jax.enable_x64(True):
        yield


@pytest.fixture(autouse=True)
def _empty_process_tables():
    """``OFF`` reads two process-wide tables of the port: the retries by
    seam (resilience/) and the kernel-library cache's counters (ops/aot.py).
    Another test file of the same process may have counted in them, so each
    test starts from empty ones: ``retry_by_seam == {}`` then means that
    this test retried nothing."""
    from kube_scheduler_simulator_tpu_torch import resilience
    from kube_scheduler_simulator_tpu_torch.ops import aot

    resilience.reset_retry_stats()
    aot.reset_stats()
    yield


def assert_same_metrics(port_svc, ref_svc) -> dict:
    got, want = port_svc.metrics(), ref_svc.metrics()
    assert set(got) == set(want), (set(got) ^ set(want))
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert {k: got[k] for k in OFF} == OFF
    # the reference's own subsystems stay off here, but for its plane banks
    # (always on) and its process-wide retry and procmesh tables
    ref_off = {k: v for k, v in OFF.items() if not k.startswith(("placer_bank", "retry_by_seam", "procmesh"))}
    assert {k: want[k] for k in ref_off} == ref_off
    return got


def assert_same_stores(port_store, ref_store) -> None:
    assert_same_bytes("store dump", dumped(port_store.dump()), dumped(ref_store.dump()))
    assert_same_bytes("pod states", dumped(pod_parity_state(port_store)), dumped(pod_parity_state(ref_store)))


# ------------------------------------------------------------ lifecycle

@pytest.mark.parametrize("use_batch", ["off", "auto"])
def test_restart_rolls_back_a_bad_configuration(use_batch):
    """tests/test_schedule_e2e.py's rollback: a configuration naming an
    unknown plugin raises and leaves the previous one running; a valid one
    replaces it, and the reset returns to the first one started."""
    bad = {"profiles": [{"schedulerName": "default-scheduler",
                         "plugins": {"multiPoint": {"enabled": [{"name": "NoSuchPlugin"}]}}}]}
    custom = {"profiles": [{"schedulerName": "default-scheduler", "plugins": {
        "multiPoint": {"enabled": [{"name": "NodeResourcesFit"}], "disabled": [{"name": "*"}]}}}]}
    runs = []
    for P in (PORT, JAX):
        store = P.Store(clock=P.Clock(T0))
        store.create("nodes", make_node("node-0"))
        store.create("nodes", make_node("node-1", cpu="8"))
        svc = P.Service(store, tie_break="first", use_batch=use_batch, batch_min_work=0)
        svc.start_scheduler(None)
        boot = svc.get_scheduler_config()
        with pytest.raises(KeyError):
            svc.restart_scheduler(bad)
        assert svc.get_scheduler_config() == boot
        store.create("pods", make_pod("p1"))
        assert svc.schedule_pending()["default/p1"].success
        svc.restart_scheduler(custom)
        assert svc.get_scheduler_config()["profiles"][0]["plugins"]["multiPoint"]["disabled"] == [{"name": "*"}]
        store.create("pods", make_pod("p2"))
        svc.schedule_pending()
        svc.reset_scheduler_configuration()
        assert svc.get_scheduler_config() == boot
        store.create("pods", make_pod("p3"))
        svc.schedule_pending()
        runs.append((store, svc))
    assert_same_stores(runs[0][0], runs[1][0])
    assert_same_metrics(runs[0][1], runs[1][1])


def test_shutdown_stops_the_loop_and_drops_the_frameworks():
    store = PORT.Store(clock=PORT.Clock(T0))
    svc = PORT.Service(store, tie_break="first")
    svc.start_scheduler(None)
    svc.start_background(poll_interval=0.02)
    assert svc.is_background_running()
    svc.shutdown_scheduler()
    assert not svc.is_background_running() and svc.framework is None and svc.frameworks == {}
    svc.start_scheduler(None)  # a new start after shutdown
    assert svc.framework is not None


# -------------------------------------------------------------- metrics

def churn_run(P, use_batch: str):
    store = P.Store(clock=lambda: 0.0)
    svc = None
    for _w in workloads.churn(store, 90, 24, 3, cordon=3):
        if svc is None:
            svc = P.Service(store, tie_break="first", use_batch=use_batch, batch_min_work=0)
            svc.start_scheduler(None)
        svc.schedule_pending(max_rounds=1)
    return store, svc


@pytest.mark.parametrize("use_batch", ["off", "auto"])
def test_metrics_after_batch_rounds_match_the_reference(use_batch):
    """A fresh service's keys, then BASELINE cfg5's churn at a cut (three
    waves, deletes, a rolling cordon): the key set is the reference's and
    the counters equal."""
    fresh = PORT.Service(PORT.Store(), device="cpu").metrics()
    assert set(fresh) == set(JAX.Service(JAX.Store()).metrics())
    assert fresh["engine_rounds"] == 0 and fresh["engine_compiles"] == 0 and fresh["engine_cache_entries"] == 0
    (s_p, svc_p), (s_j, svc_j) = churn_run(PORT, use_batch), churn_run(JAX, use_batch)
    assert_same_stores(s_p, s_j)
    m = assert_same_metrics(svc_p, svc_j)
    if use_batch == "auto":
        assert m["batch_pods"] == 90 and m["engine_rounds"] >= 3 and m["commit_s"] > 0
        assert m["encode_full_total"] >= 1 and m["engine_last_timings"] and m["engine_cum_timings"]
        # the CPU runs the plain versions: no kernel library, no launch plan
        assert m["engine_compiles"] == 0 and m["engine_cache_entries"] == 0
    else:
        assert m["sequential_pods"] == 90 and m["engine_rounds"] == 0
    assert "f64_promotions" not in m and "f64_promotions" in svc_p.stats


def test_metrics_after_a_gang_round_match_the_reference():
    from kube_scheduler_simulator_tpu.gang import gang_scheduler_config as jax_gang_config
    from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config

    svcs, stores = [], []
    for P, cfg in ((PORT, gang_scheduler_config()), (JAX, jax_gang_config())):
        store = P.Store(clock=P.Clock(0.0))
        store.create("namespaces", {"metadata": {"name": "default"}})
        for i in range(3):
            store.create("nodes", gang_node(f"node-{i}"))
        store.create("podgroups", gang_group("g", 2))
        store.create("pods", mk_member("m0", "g"))
        store.create("pods", mk_member("m1", "g"))
        svc = P.Service(store, tie_break="first", use_batch="auto", batch_min_work=0)
        svc.start_scheduler(cfg)
        svc.schedule_pending()
        svcs.append(svc)
        stores.append(store)
    assert_same_stores(*stores)
    m = assert_same_metrics(*svcs)
    assert m["gang_released_groups"] == 1 and m["gang_kernel_dispatches"] >= 1
    assert m["waiting_pods"] == 0 and m["permit_wait_expired"] == 0


STREAM_CASES = {
    "randomized-churn": dict(seed=11),
    "failure-traces": dict(giants_at={1}),
    "kernel-failures-preemption-path": dict(use_batch="auto", giants_at={1}),
    "serial": dict(seed=11, streaming=False),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_metrics_after_a_stream_match_the_reference(case):
    """tests/test_stream.py's metrics cases: the stream counters (waves,
    pods, drains by reason) and every other shared counter equal."""
    kw = dict(STREAM_CASES[case])
    streaming = kw.pop("streaming", True)
    use_batch = kw.pop("use_batch", "force")
    runs = []
    for P in (PORT, JAX):
        store = P.Store(clock=lambda: T0)
        for i in range(24):
            store.create("nodes", stream_node(i))
        svc = P.Service(store, tie_break="first", use_batch=use_batch, batch_min_work=1)
        svc.start_scheduler(None)
        svc.schedule_stream(feed=churn_feed(store, 4, **kw), streaming=streaming)
        runs.append((store, svc))
    assert_same_stores(runs[0][0], runs[1][0])
    m = assert_same_metrics(runs[0][1], runs[1][1])
    if streaming:
        assert m["stream_waves_total"] >= 1 and m["stream_pods_total"] > 0
    else:
        assert m["stream_overlap_s"] == 0.0


def test_metrics_after_a_tuning_run_match_the_reference():
    from kube_scheduler_simulator_tpu.tuning import run_tuning as jax_run_tuning
    from kube_scheduler_simulator_tpu_torch.tuning import run_tuning

    svcs, reports = [], []
    for P, run in ((PORT, run_tuning), (JAX, jax_run_tuning)):
        store = P.Store(clock=P.Clock(T0))
        for n in _cluster(4):
            store.create("nodes", n)
        svc = P.Service(store, tie_break="first", use_batch="off", batch_min_work=0)
        svc.start_scheduler({"profiles": [profile_with(PLUGINS)], "percentageOfNodesToScore": 100})
        kw = {"device": "cpu"} if P is PORT else {}
        reports.append(run(family="imbalance", tuner="cem", n_nodes=5, n_pods=16, steps=2, pop=4, svc=svc, **kw))
        svcs.append(svc)
    m = assert_same_metrics(*svcs)
    assert m["tuning_runs_total"] == 1 and m["tuning_rollouts_total"] == reports[0]["rollouts"]
    assert m["tuning_objective"] == svcs[1].metrics()["tuning_objective"]
    assert m["tuning_objective"]["fragmentation"] == pytest.approx(reports[0]["tunedObjective"])


def queue_not_refiltered(P, clock):
    store = P.Store(clock=P.Clock(T0))
    store.create("nodes", q_node("n0", cpu="1000m"))
    svc = P.Service(store, tie_break="first", clock=clock)
    svc.start_scheduler(None)
    store.create("pods", q_pod("huge", cpu="64000m"))
    svc.schedule_pending(max_rounds=3, respect_backoff=True)
    assert svc.stats["sequential_pods"] == 1
    for _ in range(5):
        svc.schedule_pending(max_rounds=3, respect_backoff=True)
    assert svc.stats["sequential_pods"] == 1 and svc.metrics()["queue_unschedulable"] == 1
    return store, svc


def queue_node_event_requeues_after_backoff(P, clock):
    store = P.Store(clock=P.Clock(T0))
    store.create("nodes", q_node("n0", cpu="1000m"))
    svc = P.Service(store, tie_break="first", clock=clock)
    svc.start_scheduler(None)
    store.create("pods", q_pod("big", cpu="8000m"))
    svc.schedule_pending(max_rounds=1, respect_backoff=True)
    store.create("nodes", q_node("n1", cpu="16000m"))
    svc.schedule_pending(max_rounds=1, respect_backoff=True)
    assert not store.get("pods", "big")["spec"].get("nodeName")
    clock.t = 1.5
    svc.schedule_pending(max_rounds=1, respect_backoff=True)
    assert store.get("pods", "big")["spec"].get("nodeName") == "n1"
    return store, svc


def queue_bulk_wave_node_events(P, clock):
    store = P.Store(clock=P.Clock(T0))
    store.create("nodes", q_node("n0", cpu="1000m"))
    svc = P.Service(store, tie_break="first", clock=clock)
    svc.start_scheduler(None)
    store.create("pods", q_pod("big", cpu="8000m"))
    svc.schedule_pending(max_rounds=1, respect_backoff=True)
    assert svc.metrics()["queue_unschedulable"] == 1
    new = {name: {"metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
                  "status": {"allocatable": {"cpu": "16000m", "memory": "8Gi", "pods": "10"}}}
           for name in ("bulk-a", "bulk-b")}
    store.bulk_update("nodes", [(nm, None, lambda cur, nm=nm: new[nm] if cur is None else None) for nm in new],
                      allow_create=True)
    assert svc.metrics()["queue_unschedulable"] == 0
    clock.t = 1.5
    svc.schedule_pending(max_rounds=1, respect_backoff=True)
    store.create("pods", q_pod("gone", cpu="64000m"))
    svc.schedule_pending(max_rounds=1, respect_backoff=True)
    assert svc.metrics()["queue_unschedulable"] == 1
    store.delete("pods", "gone")
    assert svc.metrics()["queue_unschedulable"] == 0
    return store, svc


QUEUE_CASES = {f.__name__: f for f in (queue_not_refiltered, queue_node_event_requeues_after_backoff,
                                       queue_bulk_wave_node_events)}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_metrics_after_a_queue_sequence_match_the_reference(case):
    (s_p, svc_p), (s_j, svc_j) = QUEUE_CASES[case](PORT, FakeClock()), QUEUE_CASES[case](JAX, FakeClock())
    assert_same_stores(s_p, s_j)
    assert_same_metrics(svc_p, svc_j)


# ------------------------------------------------------------------ loop

def wait_for(cond, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("P", [PORT, JAX], ids=["port", "jax"])
def test_background_queue_absorbs_unschedulable_churn(P):
    """tests/test_soak.py:195: a permanently unschedulable pod is attempted
    a bounded number of times while schedulable churn flows around it."""
    store = P.Store()
    for i in range(8):
        store.create("nodes", {"metadata": {"name": f"n{i}", "labels": {"kubernetes.io/hostname": f"n{i}"}},
                               "status": {"allocatable": {"cpu": "4000m", "memory": "8Gi", "pods": "50"}}})
    svc = P.Service(store, tie_break="first")
    svc.start_scheduler(None)
    svc.start_background(poll_interval=0.02)
    try:
        store.create("pods", {"metadata": {"name": "impossible"},
                              "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "64"}}}]}})
        for i in range(40):
            store.create("pods", {"metadata": {"name": f"churn-{i}"},
                                  "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "50m"}}}]}})
            time.sleep(0.005)

        def bound() -> int:
            return sum(1 for p in store.list("pods", copy_objects=False) if (p.get("spec") or {}).get("nodeName"))

        assert wait_for(lambda: bound() == 40, 20), f"only {bound()}/40 churn pods bound"
        assert not store.get("pods", "impossible")["spec"].get("nodeName")
    finally:
        svc.stop_background()
    m = svc.metrics()
    assert m["sequential_pods"] + m["batch_pods"] <= 40 + 8
    assert m["queue_unschedulable"] + m["queue_backoff"] + m["queue_active"] >= 1


def stream_store(P):
    """cfg9-stream's cluster at a cut (40 nodes, 300 bound pods) with one
    tick of 20 arrivals, and its feed."""
    store = P.Store(clock=lambda: T0)
    settled = workloads.stream_cluster(store, 40, 300)
    feed = workloads.steady_feed(store, settled, 4, 0, per_tick=20, seed_bound=300)
    feed(0)
    return store, feed


@pytest.mark.parametrize("use_batch", ["off", "auto"])
def test_the_loops_first_round_equals_one_round_of_schedule_pending(use_batch):
    """The loop's first round over a filled store gives the bytes of
    ``schedule_pending(max_rounds=1, respect_backoff=True)`` on a twin store,
    and the reference loop's; the three more ticks fed while the loop runs
    bind every arrival exactly once."""
    states = {}
    for P in (PORT, JAX):
        store, feed = stream_store(P)
        svc = P.Service(store, tie_break="first", use_batch=use_batch, batch_min_work=0)
        svc.start_scheduler(None)
        svc.start_background(poll_interval=0.02)
        try:
            assert wait_for(lambda: not svc.pending_pods())
        finally:
            # joins the tick in flight: a pod is bound before its
            # annotations are flushed
            svc.stop_background()
        states[P.name] = pod_parity_state(store)
        svc.start_background(poll_interval=0.02)
        try:
            for t in range(1, 4):
                feed(t)
            assert wait_for(lambda: not svc.pending_pods())
        finally:
            svc.stop_background()
        events = [e for e in store.list("events") if e["reason"] == "Scheduled"]
        arrivals = [p["metadata"]["name"] for p in store.list("pods") if p["metadata"]["name"].startswith("pod-")]
        assert len(arrivals) == 80 and all(store.get("pods", n, "default")["spec"]["nodeName"] for n in arrivals)
        assert sorted(e["involvedObject"]["name"] for e in events) == sorted(arrivals)
    twin, _feed = stream_store(PORT)
    svc = PORT.Service(twin, tie_break="first", use_batch=use_batch, batch_min_work=0)
    svc.start_scheduler(None)
    svc.schedule_pending(max_rounds=1, respect_backoff=True)
    want = dumped(pod_parity_state(twin))
    assert_same_bytes("loop's first round vs schedule_pending", dumped(states["port"]), want)
    assert_same_bytes("port loop vs reference loop", dumped(states["port"]), dumped(states["jax"]))


@pytest.mark.parametrize("P", [PORT, JAX], ids=["port", "jax"])
def test_the_loop_runs_autoscaler_passes_under_on_and_not_under_scenario(P):
    """In the loop, "on" scales up for a pod nothing fits and binds it;
    "scenario" leaves the loop without the autoscaler (the pod stays
    pending and no node is added), as in the reference; both modes drive
    the synchronous autoscaled drain.  (How many scale-ups "on" takes
    depends on the tick timing against the pod's backoff, in both
    packages.)"""
    out = {}
    for mode in ("on", "scenario"):
        store = P.Store(clock=lambda: 0.0)
        store.create("nodegroups", mk_group("pool", mx=2, cpu="4000m", mem="8Gi"))
        svc = P.Service(store, tie_break="first", use_batch="off", autoscale=mode, autoscale_interval_s=0.0,
                        autoscaler_opts={"expander": "least-waste"})
        svc.start_scheduler(None)
        store.create("pods", asc_pod("p0", cpu="3000m", mem="1Gi"))
        svc.start_background(poll_interval=0.02)
        try:
            wait_for(lambda: not svc.pending_pods(), 3.0 if mode == "scenario" else 20.0)
        finally:
            svc.stop_background()
        ups = sum(e["action"] == "ScaleUp" for e in (svc._autoscaler.events if svc._autoscaler else []))
        out[mode] = (min(ups, 1), store.get("pods", "p0", "default")["spec"].get("nodeName"))
        if mode == "scenario":
            # the synchronous drain does run the autoscaler in this mode
            svc.schedule_pending_autoscaled(max_rounds=1)
            out["scenario drain"] = (len(store.list("nodes")),
                                     store.get("pods", "p0", "default")["spec"].get("nodeName"))
    assert out["on"][0] == 1 and out["on"][1]
    assert out["scenario"] == (0, None)
    assert out["scenario drain"][0] == 1 and out["scenario drain"][1]


def test_an_idle_tick_launches_no_scan(monkeypatch):
    """Ticks with nothing pending (and the tick after the last pod bound)
    never reach the engine."""
    calls = []
    real = TB.build_batch_fn

    def counting(*a, **kw):
        fn = real(*a, **kw)

        def wrapped(*args):
            calls.append(len(args))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(TB, "build_batch_fn", counting)
    store = PORT.Store(clock=PORT.Clock(T0))
    store.create("nodes", make_node("node-0"))
    svc = PORT.Service(store, tie_break="first", use_batch="auto", batch_min_work=0)
    svc.start_scheduler(None)
    svc.start_background(poll_interval=0.01)
    try:
        time.sleep(0.2)
        assert calls == []
        store.create("pods", make_pod("p1"))
        assert wait_for(lambda: not svc.pending_pods())
        time.sleep(0.2)
    finally:
        svc.stop_background()
    assert len(calls) == 1 and svc.metrics()["engine_rounds"] == 1


def test_a_launch_error_stops_the_loop_and_stop_background_raises_it():
    """The port's deliberate difference from the reference's loop (which
    swallows every exception): the loop stops at an error its round does not
    degrade (here a kernel library that fails to load at the launch; a
    kernel error itself finishes the round on the sequential cycle),
    ``is_background_running()`` reads False, nothing of the dying round is
    committed, and ``stop_background()`` re-raises the error once;
    ``start_background()`` over a loop that died re-raises it too."""
    real = TB.build_batch_fn

    def failing(*a, **kw):
        def fn(*args):
            raise KernelBuildError("injected launch error: the library did not load")
        return fn

    for restart_first in (False, True):
        store = PORT.Store(clock=PORT.Clock(T0))
        store.create("nodes", make_node("node-0"))
        svc = PORT.Service(store, tie_break="first", use_batch="auto", batch_min_work=0)
        svc.start_scheduler(None)
        TB.build_batch_fn = failing
        try:
            svc.start_background(poll_interval=0.01)
            store.create("pods", make_pod("p1"))
            assert wait_for(lambda: not svc.is_background_running())
        finally:
            TB.build_batch_fn = real
        assert not store.get("pods", "p1")["spec"].get("nodeName")
        assert svc.stats["batch_pods"] == 0 and svc.stats["sequential_pods"] == 0
        with pytest.raises(RuntimeError, match="injected launch error"):
            if restart_first:
                svc.start_background(poll_interval=0.01)
            else:
                svc.stop_background()
        assert not svc.is_background_running()
        svc.stop_background()  # raised once: nothing more to raise
        # a new loop schedules the pod
        svc.start_background(poll_interval=0.01)
        try:
            assert wait_for(lambda: bool(store.get("pods", "p1")["spec"].get("nodeName")))
        finally:
            svc.stop_background()
    assert not [t for t in threading.enumerate() if t.name == "scheduler-loop"]


# ------------------------------------------------- the process-wide tables

CHAOS_THEN_LIFECYCLE = """
import sys
import pytest
import kube_scheduler_simulator_tpu_torch.fuzz as TF
from kube_scheduler_simulator_tpu_torch import resilience

scn = TF.generate_scenario(12, 1, features=frozenset({"churn", "retune", "preemption"}))
v, _ = TF.run_differential(scn, TF.FuzzHarness("cpu"), comparisons=("stream-vs-serial",),
                           chaos={"roles": ["stream-on"], "fail_events": [1, 4]})
assert v["divergences"] == [], v
assert resilience.retry_stats().get("stream", 0) >= 1, resilience.retry_stats()
sys.exit(pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist",
                      "tests/test_torch_lifecycle.py", "-k", "metrics_after"]))
"""


def test_the_metrics_cases_hold_after_a_chaos_stream_in_one_process():
    """A chaos stream (tests/test_fuzz.py's stream chaos, on the port) counts
    retries at the stream seam in the port's process-wide table; this
    file's metrics cases, run after it in the same process, still find
    ``retry_by_seam == {}``: each starts from an empty table."""
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", CHAOS_THEN_LIFECYCLE], cwd=root, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    # every metrics case of this file ran and passed: batch rounds (2), the
    # gang round, streams (4), the tuning run and the queue sequences (3)
    progress = proc.stdout.split("[100%]")[0]
    assert progress.strip() == "." * (2 + 1 + len(STREAM_CASES) + 1 + len(QUEUE_CASES)), proc.stdout[-2000:]
