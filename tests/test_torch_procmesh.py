"""The port's scan ensemble (ops/procmesh.py, ops/procmesh_worker.py,
``KSS_MESH_PROCESSES``) and ``WorkerChaos`` against the JAX package's.

- The reference's own tests (tests/test_procmesh.py) run against the port
  on the CPU (``exec_on_port``): the env parsers, the reaper of a stopped
  child, the silent metrics, the ``aot_cache_disabled`` fallback, the N=1
  ensemble end to end and a worker killed at the first dispatch.  On the
  CPU the port's N=1 ensemble engages, so none of them skips.  Its N=2
  case is replaced: the port's two ranks engage but refuse every scan
  shape (``sharded_scan_unported``) until the node axis is sharded.
- The four env parsers equal the reference's over one list of values.
- A seeded round through an N=1 ensemble gives the annotation bytes of the
  port's in-process round and of the JAX package's (float64, scoped per
  test); a streamed run (``schedule_async``) equals the in-process one; an
  N=2 ensemble gives the same bytes with ``sharded_scan_unported`` counted.
- ``WorkerChaos`` kills, stops and cuts off the worker at the first
  dispatch: no divergence, one respawn (a hang detected when stopped), the
  breaker closed, no worker left.
- A kernel's own failure in a live worker is raised in the parent, never
  respawned; any other error there runs the wave in-process, counted.
- The pool and ``acquire`` take the card unless asked for the CPU.
- Each package's leak scan counts only its own workers.
- An idle ``heartbeat()`` replaces a stopped worker; ``/metrics`` renders
  a live ensemble's ``procmesh_*`` lines as the reference renders them.

Every test here that starts a worker has a time limit of its own
(``_time_limit``), beside the pool's own reply budget.
"""

from __future__ import annotations

import os
import random
import signal
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_reference_checks import exec_on_port  # noqa: E402

# every port test this process runs must degrade no kernel error without chaos
pytest_plugins = ["torch_degrade_watch"]

exec_on_port("test_procmesh", globals(), on_cpu_calls=("SchedulerService", "WorkerChaos"))
# Its N=2 case wants an engaged two-rank pool to dispatch scans.  The port's
# two ranks engage (gloo starts here) but refuse every scan shape, counted
# ``sharded_scan_unported``, until the node axis is sharded over them:
# test_two_workers_fall_back_counted_with_the_same_bytes holds that instead.
del test_multiprocess_ensemble_parity_or_loud_skip  # noqa: F821

from kube_scheduler_simulator_tpu.ops import procmesh as ref_procmesh  # noqa: E402
from kube_scheduler_simulator_tpu.fuzz import chaos as ref_chaos  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from kube_scheduler_simulator_tpu.utils.parity import pod_parity_state as jax_parity_state  # noqa: E402
from kube_scheduler_simulator_tpu_torch.fuzz import chaos as port_chaos  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import procmesh as port_procmesh  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import procmesh_worker  # noqa: E402
from kube_scheduler_simulator_tpu_torch.resilience import retry_stats  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state  # noqa: E402
from test_stream import churn_feed  # noqa: E402
from test_stream import mk_node as stream_node  # noqa: E402

T0 = 1_700_000_000.0
TIME_LIMIT_S = 150


@pytest.fixture(autouse=True)
def _time_limit():
    """SIGALRM fails a test that runs past ``TIME_LIMIT_S``; the pool's own
    waits are bounded by ``KSS_PROCMESH_TIMEOUT_S`` besides."""

    def expired(_sig, _frame):
        raise TimeoutError(f"test ran past its {TIME_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def ensemble(monkeypatch, tmp_path):
    """The port's ensemble knobs on a fresh module state (the pool, its
    verdict and counters are the process's), and a clean slate after."""
    port_procmesh.reset()
    monkeypatch.delenv("KSS_MESH_PROCESSES", raising=False)
    monkeypatch.setenv("KSS_PROCMESH_TIMEOUT_S", "60")
    cache = str(tmp_path / "aot")

    def engage(n: int) -> None:
        monkeypatch.setenv("KSS_AOT_CACHE_DIR", cache)
        monkeypatch.setenv("KSS_MESH_PROCESSES", str(n))

    yield engage
    port_procmesh.reset()
    assert port_chaos.leaked_worker_pids() == []


# ------------------------------------------------------------ env parsers

PARSERS = {
    "KSS_MESH_PROCESSES": ("procs_from_env", "procs_from_env"),
    "KSS_PROCMESH_HEARTBEAT_S": ("heartbeat_from_env", "heartbeat_from_env"),
    "KSS_PROCMESH_MAX_RESPAWNS": ("max_respawns_from_env", "max_respawns_from_env"),
    # the reference reads this one inline (``acquire``): float(env or "30")
    "KSS_PROCMESH_TIMEOUT_S": ("timeout_from_env", None),
}
VALUES = (None, "", " ", "0", "1", "3", " 2 ", "-1", "0.25", "1e3", "two", "nan")


def _outcome(fn):
    try:
        return ("value", fn())
    except ValueError as e:
        return ("ValueError", type(e).__name__)


@pytest.mark.parametrize("value", VALUES, ids=repr)
@pytest.mark.parametrize("knob", sorted(PARSERS))
def test_env_parsers_match_the_references(monkeypatch, knob, value):
    if value is None:
        monkeypatch.delenv(knob, raising=False)
    else:
        monkeypatch.setenv(knob, value)
    port_name, ref_name = PARSERS[knob]
    ref = getattr(ref_procmesh, ref_name) if ref_name else (lambda: float(os.environ.get(knob, "30")))
    got, want = _outcome(getattr(port_procmesh, port_name)), _outcome(ref)
    if got[0] == "value" and isinstance(got[1], float) and got[1] != got[1]:
        assert want[0] == "value" and want[1] != want[1]  # nan
    else:
        assert got == want


# ------------------------------------------------------------- parity

def _seed_cluster(store) -> None:
    """tests/test_procmesh.py's cluster (12 nodes, a fifth tainted; 30
    pods, a seventh tolerating), under a pinned clock."""
    from tests.test_batch_parity import mk_node, mk_pod

    rng = random.Random(7)
    for i in range(12):
        taints = [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}] if i % 5 == 0 else None
        store.create("nodes", mk_node(f"n{i}", cpu_m=4000 + 500 * (i % 3), mem_mi=8192, taints=taints))
    for i in range(30):
        p = mk_pod(f"p{i}", cpu_m=rng.choice([100, 250, 3900]), mem_mi=rng.choice([64, 256]),
                   labels={"app": f"a{i % 4}"})
        if i % 7 == 0:
            p["spec"]["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        store.create("pods", p)


def _parity_round(pkg: str) -> tuple:
    if pkg == "port":
        store = ClusterStore(clock=lambda: T0)
        _seed_cluster(store)
        svc = SchedulerService(store, tie_break="first", seed=3, use_batch="force", batch_min_work=0, device="cpu")
    else:
        store = JaxStore(clock=lambda: T0)
        _seed_cluster(store)
        svc = JaxService(store, tie_break="first", seed=3, use_batch="force", batch_min_work=0)
    svc.start_scheduler({"percentageOfNodesToScore": 100})
    svc.schedule_pending()
    assert svc.stats["batch_pods"] >= 1 and not svc.stats["batch_fallbacks"], svc.stats
    return (pod_parity_state if pkg == "port" else jax_parity_state)(store), svc


def test_one_worker_round_equals_the_in_process_rounds_of_both_packages(ensemble, monkeypatch):
    monkeypatch.delenv("KSS_AOT_CACHE_DIR", raising=False)
    with jax.enable_x64(True):
        reference, _ = _parity_round("jax")
    in_process, _ = _parity_round("port")
    ensemble(1)
    through, svc = _parity_round("port")
    assert through == in_process == reference
    st = svc.metrics()["procmesh"]
    pool = st["pool"]
    assert pool["engaged"] == 1 and pool["dispatches"] >= 1 and pool["scans_loaded"] >= 1, st
    assert pool["device"] == "cpu" and pool["worker_degrades"] == {} and pool["worker_builds"] == {}, st
    assert st["run_fallbacks_by_reason"] == {} and st["fallbacks_by_reason"] == {} and st["verdict"] is None, st
    assert pool["last_run"]["ship_bytes"] > 0 and pool["last_run"]["reply_bytes"] > 0, pool["last_run"]


def _stream_run(streaming: bool) -> dict:
    store = ClusterStore(clock=lambda: T0)
    for i in range(24):
        store.create("nodes", stream_node(i))
    svc = SchedulerService(store, tie_break="first", use_batch="force", batch_min_work=1, device="cpu")
    svc.start_scheduler(None)
    svc.schedule_stream(feed=churn_feed(store, 4, seed=11), streaming=streaming)
    assert svc.stats["stream_waves"] >= 3, svc.stats
    return pod_parity_state(store)


def test_a_streamed_run_through_one_worker_equals_the_in_process_one(ensemble):
    in_process = _stream_run(True)
    ensemble(1)
    through = _stream_run(True)
    assert through == in_process
    st = port_procmesh.stats()
    assert st["pool"]["dispatches"] >= 3 and st["run_fallbacks_by_reason"] == {}, st


def test_two_workers_fall_back_counted_with_the_same_bytes(ensemble):
    in_process, _ = _parity_round("port")
    ensemble(2)
    through, svc = _parity_round("port")
    assert through == in_process
    st = svc.metrics()["procmesh"]
    # gloo starts on the CPU: the probe passes, each scan shape is refused
    assert st["verdict"] is None and st["fallbacks_by_reason"] == {}, st
    assert st["pool"]["processes"] == 2 and st["pool"]["dispatches"] == 0, st
    assert set(st["run_fallbacks_by_reason"]) == {"sharded_scan_unported"}, st


def test_a_lost_wave_runs_in_process_counted(ensemble, monkeypatch):
    """A wave the ensemble cannot finish, even after its one re-dispatch,
    runs in this process with the same bytes, counted ``worker_lost`` and
    as a ``procmesh_local_rebuild`` retry; the shape then stays in-process."""
    in_process, _ = _parity_round("port")
    ensemble(1)
    # every wait lost (the pool's own re-dispatch included): the reply is
    # never read, and the handle returns nothing
    monkeypatch.setattr(port_procmesh._PendingRun, "fetch", lambda self: setattr(self.pool, "_inflight", 0))
    rebuilds = retry_stats().get("procmesh_local_rebuild", 0)
    through, _svc = _parity_round("port")
    assert through == in_process
    st = port_procmesh.stats()
    shapes = st["pool"]["scans_loaded"]
    assert shapes >= 1 and st["pool"]["dispatches"] == shapes, st
    assert st["run_fallbacks_by_reason"] == {"worker_lost": shapes}, st
    assert retry_stats().get("procmesh_local_rebuild", 0) == rebuilds + shapes


def _failing_worker(monkeypatch, error: str) -> None:
    """Workers started from here on raise ``error`` from their ``run``."""
    main = (
        "import sys; from kube_scheduler_simulator_tpu_torch.ops import procmesh_worker as w, kernels as K; "
        f"w._run = lambda *a: (_ for _ in ()).throw(getattr(K, {error!r}, RuntimeError)('injected')); "
        "sys.exit(w.main(sys.argv[2:]))"
    )
    monkeypatch.setattr(procmesh_worker, "_MAIN", main)


@pytest.mark.parametrize("error", ["KernelLaunchError", "KernelArgumentError", "KernelBuildError"])
def test_a_kernel_error_in_the_worker_is_raised_never_respawned(ensemble, monkeypatch, error):
    """A kernel's own failure (or a library's) in a live worker's scan is
    raised in the parent as the in-process scan raises it: no respawn, no
    re-dispatch, no in-process rerun, the worker kept."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    ensemble(1)
    _failing_worker(monkeypatch, error)
    pool = port_procmesh.acquire("cpu")
    assert pool is not None, port_procmesh.stats()
    pid = pool.workers[0].proc.pid
    assert pool.load_scan("k", {}, "unused") is None
    with pytest.raises(getattr(K, error), match="in the scan worker: .*injected"):
        pool.run("k", {}).fetch()
    snap = pool.snapshot()
    assert snap["respawns"] == 0 and snap["failures_by_verdict"] == {} and snap["breaker_state"] == "closed", snap
    assert snap["worker_errors"] == {error: 1} and snap["dispatches"] == 1, snap
    assert port_procmesh.stats()["run_fallbacks_by_reason"] == {}
    assert pool.workers[0].proc.pid == pid and pool.heartbeat() is True


def test_another_error_in_the_worker_runs_the_wave_in_process_counted(ensemble, monkeypatch):
    """A live worker whose scan raised anything else keeps its place: the
    wave runs in this process with the same bytes, counted
    ``worker_error:<type>``, and nothing is respawned."""
    in_process, _ = _parity_round("port")
    ensemble(1)
    _failing_worker(monkeypatch, "RuntimeError")
    through, _svc = _parity_round("port")
    assert through == in_process
    st = port_procmesh.stats()
    n = st["pool"]["dispatches"]
    assert n >= 1 and st["run_fallbacks_by_reason"] == {"worker_error:RuntimeError": n}, st
    assert st["pool"]["respawns"] == 0 and st["pool"]["failures_by_verdict"] == {}, st
    assert st["pool"]["last_error"] == "RuntimeError: injected", st


def test_the_pool_runs_on_the_card_unless_asked_for_the_cpu(ensemble, monkeypatch):
    """Without a device the pool and ``acquire`` take the card, its index
    named; with no card they raise, never starting workers on the host.
    The worker's ``--device`` has no default.  (CUDA is stubbed: nothing
    here initialises it.)"""
    import torch

    ensemble(1)
    started = []

    def start(self):
        started.append(self.device)
        return "stubbed"

    monkeypatch.setattr(port_procmesh.ProcMeshPool, "start", start)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_procmesh.acquire()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_procmesh.ProcMeshPool(1, 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert port_procmesh.ProcMeshPool(1, 1.0).device == "cuda:0"
    assert port_procmesh.ProcMeshPool(1, 1.0, device="cpu").device == "cpu"
    assert port_procmesh.acquire() is None and started == ["cuda:0"]
    assert port_procmesh.stats()["fallbacks_by_reason"] == {"stubbed": 1}
    with pytest.raises(SystemExit):
        procmesh_worker.main(["--rank", "0", "--nprocs", "1", "--coordinator", "127.0.0.1:1", "--out-fd", "1"])


# ------------------------------------------------------------ chaos

def _chaos_scenario() -> dict:
    from tests.test_batch_parity import mk_node, mk_pod

    return {
        "name": "respawn-parity",
        "nodes": [mk_node(f"sn{i}", cpu_m=4000, mem_mi=8192) for i in range(4)],
        "pods": [mk_pod(f"sp{i}", cpu_m=250, mem_mi=64) for i in range(12)],
    }


@pytest.mark.parametrize("mode", ["kill", "stop", "sever"])
def test_worker_chaos_recovers_with_no_divergence_and_no_leak(ensemble, mode):
    v = port_chaos.WorkerChaos(_chaos_scenario(), mode=mode, fault_at=0, nprocs=1, heartbeat_s=0.3, timeout_s=60,
                               device="cpu").run()
    assert v["engaged"] == 1 and v["fired"] == 1, v
    assert v["divergences"] == [], v["first_mismatch"]
    assert v["respawns"] == 1 and v["hangs_detected"] == (1 if mode == "stop" else 0), v
    assert v["breaker_state"] == "closed" and v["run_fallbacks"] == {} and v["leaked_workers"] == [], v


def test_worker_chaos_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="kill|stop|sever"):
        port_chaos.WorkerChaos(_chaos_scenario(), mode="pause", device="cpu")


# ------------------------------------------------------------ leak scans

def test_each_packages_leak_scan_counts_only_its_own_workers(ensemble, tmp_path):
    """A live port worker is not in the reference's scan; a process whose
    command line holds the reference's worker module is not in the port's,
    nor a port worker another process started.
    That process lives in a process table written here: a real one would
    itself be a leak to the reference's own no-leak checks, which run in
    parallel with this file."""
    ensemble(1)
    pool = port_procmesh.acquire("cpu")
    assert pool is not None, port_procmesh.stats()
    pid = pool.workers[0].proc.pid
    assert port_chaos.leaked_worker_pids() == [pid]
    assert pid not in ref_chaos.leaked_worker_pids()
    cmdline = open(f"/proc/{pid}/cmdline", "rb").read()
    assert procmesh_worker.MARKER.encode() in cmdline.split(b"\x00") and b"ops.procmesh_worker" not in cmdline
    table = tmp_path / "proc"
    fake = [sys.executable, "-m", "kube_scheduler_simulator_tpu.ops.procmesh_worker", "--rank", "0"]
    mine = procmesh_worker.command(0, 1, "127.0.0.1:1", 3, 0, "cpu")
    others = [a if a != str(os.getpid()) else "1" for a in mine]
    for entry, argv in (("4242", fake), ("4343", mine), ("4444", others), ("self", fake)):
        (table / entry).mkdir(parents=True)
        (table / entry / "cmdline").write_bytes(b"\x00".join(a.encode() for a in argv) + b"\x00")
    # this process's workers, not another process's
    assert port_chaos.leaked_worker_pids(str(table)) == [4343]
    port_procmesh.reset()
    assert port_chaos.leaked_worker_pids() == []


def test_metrics_read_the_ensemble_only_once_the_knob_was_read(ensemble):
    store = ClusterStore(clock=lambda: T0)
    svc = SchedulerService(store, device="cpu")
    svc.start_scheduler(None)
    assert svc.metrics()["procmesh"] is None
    ensemble(1)
    _state, svc = _parity_round("port")
    pm = svc.metrics()["procmesh"]
    assert pm["requested_processes"] == 1 and pm["pool"]["engaged"] == 1, pm
    port_procmesh.reset()
    assert svc.metrics()["procmesh"] is None


def test_metrics_render_the_ensemble_as_the_reference_does(ensemble, monkeypatch):
    """``/metrics``'s ``procmesh_*`` families and labels from a live
    ensemble's counters are the reference's rendering of the same counters."""
    from kube_scheduler_simulator_tpu.server import DIContainer as JaxContainer
    from kube_scheduler_simulator_tpu.server.metrics import render_metrics as jax_render
    from kube_scheduler_simulator_tpu_torch.server import DIContainer
    from kube_scheduler_simulator_tpu_torch.server.metrics import render_metrics

    ensemble(1)
    _parity_round("port")
    port_procmesh.count_run_fallback("artifact_missing:kernel-digest")
    st = port_procmesh.stats()
    assert st["pool"]["engaged"] == 1 and st["pool"]["dispatches"] >= 1, st
    monkeypatch.setattr(JaxService, "_procmesh_stats", staticmethod(lambda: st))
    monkeypatch.delenv("KSS_MESH_PROCESSES")

    def procmesh_lines(text: str) -> list:
        return [ln for ln in text.splitlines() if "procmesh_" in ln and "retry" not in ln]

    got = procmesh_lines(render_metrics(DIContainer(device="cpu")))
    want = procmesh_lines(jax_render(JaxContainer()))
    assert got == want and any(ln.startswith("simulator_procmesh_engaged 1") for ln in got), (got, want)
    assert 'simulator_procmesh_run_fallbacks_total{reason="artifact_missing"} 1' in got


def test_an_idle_heartbeat_replaces_a_stopped_worker(ensemble, monkeypatch):
    """``heartbeat()`` pings every worker; a stopped one is declared hung,
    killed alone and the ensemble respawned (the next generation), the
    breaker still closed."""
    ensemble(1)
    monkeypatch.setenv("KSS_PROCMESH_HEARTBEAT_S", "0.3")
    pool = port_procmesh.acquire("cpu")
    assert pool is not None and pool.heartbeat() is True and pool.respawns == 0
    stopped = pool.workers[0].proc
    os.kill(stopped.pid, signal.SIGSTOP)
    assert pool.heartbeat() is True
    snap = pool.snapshot()
    assert snap["respawns"] == 1 and snap["hangs_detected"] == 1 and snap["generation"] == 1, snap
    assert snap["failures_by_verdict"] == {"hang": 1} and snap["breaker_state"] == "closed", snap
    assert stopped.poll() is not None and pool.workers[0].proc.pid != stopped.pid
    assert port_chaos.leaked_worker_pids() == [pool.workers[0].proc.pid]
