"""The port stands alone: it imports neither JAX nor the JAX package, loads
its own C renderer and never the JAX package's library, and its entry
points run on the card unless the caller asks for the CPU."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "kube_scheduler_simulator_tpu_torch"
REFERENCE = "kube_scheduler_simulator_tpu"


def _is_forbidden(module: str) -> bool:
    # the port's own name starts with the reference's: compare whole names
    return (
        module == "jax"
        or module.startswith("jax.")
        or module == REFERENCE
        or module.startswith(REFERENCE + ".")
    )


def _imported_modules(path: Path) -> "list[str]":
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.append(node.module)
    return out


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_file_of_the_port_imports_jax_or_the_reference(path):
    bad = [m for m in _imported_modules(path) if _is_forbidden(m)]
    assert not bad, bad


def test_the_checks_cover_the_scenario_controller_and_service_modules():
    """The AST check above walks every module of the port, the scenario
    engine's, the controllers' and the services' among them; the
    subprocess check below replays a Scenario and drives the loop and the
    services through them."""
    checked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for module in ("scenario/__init__.py", "scenario/engine.py", "scenario/operator.py", "scenario/result.py",
                   "controllers/__init__.py", "controllers/manager.py", "services/__init__.py",
                   "services/reset.py", "services/snapshot.py", "services/importer.py",
                   "services/resourcewatcher.py", "utils/simclock.py"):
        assert module in checked, module
    assert "scenario_churn" in ROUND and "start_background" in ROUND and "SnapshotService" in ROUND


def test_the_checks_cover_the_durability_and_extension_modules():
    """The journal, recovery, replication, resilience, the extender webhooks
    and the scorer bridge are walked by the AST check; the subprocess check
    journals a round, recovers and promotes it, and answers extenderv1
    calls through them."""
    checked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for module in ("state/__init__.py", "state/journal.py", "state/recovery.py", "resilience/__init__.py",
                   "resilience/policy.py", "replication/__init__.py", "replication/ship.py",
                   "replication/apply.py", "replication/promote.py", "replication/replica.py",
                   "scheduler/extender.py", "scheduler/scorer_bridge.py"):
        assert module in checked, module
    assert "boot_recover" in ROUND and "promote_replica" in ROUND and "TPUScorerBridge" in ROUND


def test_the_checks_cover_the_server_and_session_modules():
    """The simulator process, its HTTP server, the kube API, the session
    plane, the embeddable scheduler, the simulator configuration, the
    selectors and the KEP-159/184 modules are walked by the AST check; the
    subprocess check below boots the process and serves a request."""
    checked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for module in ("server/__init__.py", "server/di.py", "server/kubeapi.py", "server/metrics.py",
                   "server/patches.py", "server/server.py", "server/webui.py", "server/wirecache.py",
                   "tenancy/__init__.py", "tenancy/manager.py", "tenancy/substrate.py", "pkg/__init__.py",
                   "pkg/debuggablescheduler.py", "simulator.py", "__main__.py", "config/simulator_config.py",
                   "utils/k8s_selectors.py", "scenario/simulation.py", "scenario/simulator_operator.py"):
        assert module in checked, module


def test_the_checks_cover_the_fuzz_and_analysis_modules():
    """The differential fuzzer, its chaos engine, its crash child, its sweep
    and the build counter are walked by the AST check; the subprocess check
    below runs a differential scenario with an injected kernel failure
    under the RecompileGuard through them."""
    checked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for module in ("fuzz/__init__.py", "fuzz/__main__.py", "fuzz/chaos.py", "fuzz/coverage.py",
                   "fuzz/crash_child.py", "fuzz/generator.py", "fuzz/runner.py", "fuzz/shrink.py",
                   "fuzz/smoke.py", "fuzz/verdict.py", "analysis/__init__.py", "analysis/runtime.py"):
        assert module in checked, module
    assert "run_differential" in ROUND and "RecompileGuard" in ROUND and "fail_events" in ROUND


def test_the_checks_cover_the_library_cache_the_checker_and_the_js_tooling():
    """The kernel-library cache, the contract checker with its rules and
    fixtures, and the JavaScript tooling are walked by the AST check (the
    fixtures import neither JAX nor the reference either); the subprocess
    check reads the cache's counters, runs the checker over the live tree
    and the served script through the checker and the interpreter."""
    checked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for module in ("ops/aot.py", "analysis/framework.py", "analysis/__main__.py", "analysis/rules_dtype.py",
                   "analysis/rules_env.py", "analysis/rules_host_sync.py", "analysis/rules_hot_render.py",
                   "analysis/rules_lock.py", "analysis/rules_pinned.py", "utils/jscheck.py", "utils/jsdom.py",
                   "utils/jseval.py", "utils/jsengine.py"):
        assert module in checked, module
    fixtures = sorted(p.name for p in (PORT / "analysis" / "fixtures").glob("*.py"))
    assert len(fixtures) == 18 and all(f"analysis/fixtures/{f}" in checked for f in fixtures)
    assert "run_analysis" in ROUND and "aot.stats" in ROUND and "jscheck.check" in ROUND


def test_the_checks_cover_the_mesh_and_the_ensemble_modules():
    """The mesh boundary, the scan ensemble and its worker are walked by the
    AST check; the subprocess check validates the mesh knob and runs a
    round through a one-worker ensemble on the CPU, leaving no worker."""
    checked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for module in ("ops/mesh.py", "ops/procmesh.py", "ops/procmesh_worker.py"):
        assert module in checked, module
    assert "KSS_MESH_PROCESSES" in ROUND and "mesh_from_env" in ROUND and "leaked_worker_pids" in ROUND


def test_name_check_tells_the_packages_apart():
    assert _is_forbidden("kube_scheduler_simulator_tpu.ops.batch")
    assert _is_forbidden("jax.numpy")
    assert not _is_forbidden("kube_scheduler_simulator_tpu_torch.ops.batch")
    assert not _is_forbidden("jaxlib_free_module")


ROUND = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
before = set(sys.modules)
from kube_scheduler_simulator_tpu_torch import workloads
from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine
nodes, all_pods, pending = workloads.cluster(12, 20, seed=1)
eng = BatchEngine(scores=[("NodeResourcesFit", 1), ("TaintToleration", 3)], trace=True, device="cpu")
res = eng.schedule(nodes, all_pods, pending)
assert sum(s is not None for s in res.selected_nodes) == 12
res.filter_annotation_json(0); res.score_annotations_json(0)
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
store = ClusterStore()
for w in workloads.churn(store, 40, 20, 2, cordon=2):
    if w == 0:
        svc = SchedulerService(store, use_batch="auto", batch_min_work=0, device="cpu")
        svc.start_scheduler(None)
    svc.schedule_pending(max_rounds=1)
assert svc.stats["batch_pods"] >= 30 and not svc.stats["batch_fallbacks"], svc.stats
from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config, partially_bound_groups
from kube_scheduler_simulator_tpu_torch.gang.engine import group_preview
gstore = ClusterStore()
for w in workloads.gang_churn(gstore, jobs=6, min_members=2, max_members=4, nodes=6, waves=2, seed=1):
    if w == 0:
        gsvc = SchedulerService(gstore, use_batch="auto", batch_min_work=0, device="cpu")
        gsvc.start_scheduler(gang_scheduler_config())
    gsvc.schedule_pending(max_rounds=3)
    assert not partially_bound_groups(gstore)
assert gsvc.stats["gang_kernel_dispatches"] >= 2 and gsvc.stats["gang_released_groups"] == 6, gsvc.stats
from kube_scheduler_simulator_tpu_torch.gang.scenario import make_member
gstore.create("podgroups", dict(metadata=dict(name="g"), spec=dict(minMember=2)))
for name in ("g-0", "g-1"):
    gstore.create("pods", make_member(name, "g"))
assert group_preview(gstore, gstore.get("podgroups", "g"), device="cpu")["feasible"] is True
def start(st):
    s = SchedulerService(st, use_batch="auto", batch_min_work=0, autoscale="on", device="cpu")
    s.start_scheduler(None)
    return s
astore = ClusterStore()
asvc = workloads.autoscale(astore, start, n_pods=60, seed_nodes=0, max_size=4)
asvc.schedule_pending_autoscaled(max_rounds=2)
assert not asvc.pending_pods() and asvc.autoscaler.metrics()["estimate_dispatches"] >= 1
from kube_scheduler_simulator_tpu_torch.tuning import run_tuning
for fam, tuner in (("imbalance", "cem"), ("imbalance", "grad")):
    rep = run_tuning(family=fam, tuner=tuner, n_nodes=6, n_pods=24, steps=2, pop=4, device="cpu")
    assert rep["kernelPlatform"] == "cpu" and rep["tunedObjective"] >= rep["defaultObjective"], rep
wstore = ClusterStore()
for w in workloads.churn(wstore, 40, 20, 1):
    wsvc = SchedulerService(wstore, use_batch="auto", batch_min_work=0, weights=[1.5, 2, 0.25, 2, 2, 1, 1], device="cpu")
    wsvc.start_scheduler(None)
    wsvc.schedule_pending(max_rounds=1)
assert wsvc.stats["batch_pods"] >= 30 and wsvc.plugin_weights() is not None, wsvc.stats
from kube_scheduler_simulator_tpu_torch.controllers import ControllerManager
from kube_scheduler_simulator_tpu_torch.scenario import ScenarioEngine, ScenarioOperator, allocation_rate
from kube_scheduler_simulator_tpu_torch.services.importer import ClusterResourceImporter
from kube_scheduler_simulator_tpu_torch.services.reset import ResetService
from kube_scheduler_simulator_tpu_torch.services.resourcewatcher import ResourceWatcherService
from kube_scheduler_simulator_tpu_torch.services.snapshot import SnapshotService
from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock
sstore = ClusterStore(clock=SimClock(0.0))
ssvc = SchedulerService(sstore, use_batch="auto", batch_min_work=0, device="cpu")
ssvc.start_scheduler(None)
reset = ResetService(sstore, ssvc)
out = ScenarioEngine(sstore, ssvc, ControllerManager(sstore)).run(workloads.scenario_churn(12, 30, 3, web=2, cordon=1))
assert out["status"]["phase"] == "Succeeded" and allocation_rate(sstore) == 1.0, out["status"]
ssvc.start_background(poll_interval=0.01)
ssvc.stop_background()
assert ssvc.metrics()["batch_pods"] == 34 and ssvc.metrics()["engine_rounds"] >= 3, ssvc.metrics()
dstore = ClusterStore(clock=SimClock(0.0))
dsvc = SchedulerService(dstore, device="cpu")
dsvc.start_scheduler(None)
ClusterResourceImporter(SnapshotService(sstore, ssvc), SnapshotService(dstore, dsvc)).import_cluster_resources()
assert len(dstore.list("pods")) == 32
reset.reset()
assert sstore.list("pods") == [] and ResourceWatcherService(sstore) and ScenarioOperator(sstore, ssvc)
import tempfile
from kube_scheduler_simulator_tpu_torch.replication import ReplicaApplier, promote_replica
from kube_scheduler_simulator_tpu_torch.resilience import RetryPolicy
from kube_scheduler_simulator_tpu_torch.scheduler.scorer_bridge import TPUScorerBridge
from kube_scheduler_simulator_tpu_torch.state import Journal, boot_recover, restore_scheduler_state
from kube_scheduler_simulator_tpu_torch.state import scheduler_meta_provider, write_mark
jdir = tempfile.mkdtemp()
jstore = ClusterStore(clock=SimClock(0.0))
jsvc = SchedulerService(jstore, use_batch="force", device="cpu")
journal = Journal(jdir)
jstore.attach_journal(journal)
journal.add_meta_provider(scheduler_meta_provider(jsvc))
plan = workloads.gang_setup(jstore, jobs=4, min_members=2, max_members=3, nodes=4, seed=2)
jsvc.start_scheduler(gang_scheduler_config())
for w in range(2):
    workloads.gang_wave(jstore, plan, 2, w)
    jsvc.schedule_pending(max_rounds=3)
    write_mark(jsvc, w)
rstore = ClusterStore(clock=SimClock(0.0))
report = boot_recover(jdir, rstore)
rsvc = SchedulerService(rstore, use_batch="force", device="cpu")
rsvc.start_scheduler(report.scheduler_config)
restore_scheduler_state(rsvc, report)
assert rstore.dump() == jstore.dump() and report.partial_gangs == 0 and report.last_mark["tick"] == 1
applier = ReplicaApplier(ClusterStore(clock=SimClock(0.0)), jdir, notify=False)
applier.bootstrap()
applier.step()
promoted = promote_replica(applier, lambda st: SchedulerService(st, device="cpu"))
assert applier.store.dump() == jstore.dump() and promoted.service.framework is not None
assert RetryPolicy(seed=1).schedule() == RetryPolicy(seed=1).schedule()
bridge = TPUScorerBridge(dsvc)
out = bridge.filter({{"pod": {{"metadata": {{"name": "x"}}, "spec": {{}}}}, "nodenames": [n["metadata"]["name"] for n in dstore.list("nodes")][:3]}})
assert out["error"] == "" and len(out["nodenames"]) == 3 and bridge.fallbacks == 0, out
import os
from kube_scheduler_simulator_tpu_torch.fuzz.chaos import leaked_worker_pids
from kube_scheduler_simulator_tpu_torch.ops import mesh, procmesh
assert mesh.mesh_from_env(device="cpu") is None
os.environ.update(KSS_MESH_PROCESSES="1", KSS_AOT_CACHE_DIR=tempfile.mkdtemp())
pstore = ClusterStore()
for w in workloads.churn(pstore, 40, 20, 1):
    psvc = SchedulerService(pstore, use_batch="auto", batch_min_work=0, device="cpu")
    psvc.start_scheduler(None)
    psvc.schedule_pending(max_rounds=1)
pm = psvc.metrics()["procmesh"]
assert pm["pool"]["dispatches"] >= 1 and pm["run_fallbacks_by_reason"] == {{}} and psvc.stats["batch_pods"] >= 30, pm
procmesh.reset()
del os.environ["KSS_MESH_PROCESSES"]
assert leaked_worker_pids() == []
from kube_scheduler_simulator_tpu_torch.analysis import RecompileGuard
from kube_scheduler_simulator_tpu_torch.fuzz import FuzzHarness, generate_scenario, run_differential
with RecompileGuard("a CPU differential"):
    fv, _fs = run_differential(generate_scenario(0, 1), FuzzHarness("cpu"), chaos={{"roles": ["batch"], "fail_events": [0]}})
assert fv["divergences"] == [] and fv["comparisons"][0]["explained"]["batch_fallbacks"] == {{"kernel error: ChaosError": 1}}, fv
from kube_scheduler_simulator_tpu_torch.ops import aot
from kube_scheduler_simulator_tpu_torch.analysis import run_analysis
from kube_scheduler_simulator_tpu_torch.utils import jscheck
from kube_scheduler_simulator_tpu_torch.utils.jseval import Interp
from kube_scheduler_simulator_tpu_torch.server.webui import JS
assert aot.stats()["aot_cache_saves_total"] == 0 and aot.LibraryCache
assert run_analysis()["findings"] == []
jscheck.check(JS)
assert Interp({{}}).run("const x = [1, 2].map(v => v * 2).join(',');").get("x") == "2,4"
from kube_scheduler_simulator_tpu_torch import native
assert native.fastjson is not None and native.status()["path"].startswith({str(PORT)!r}), native.status()
# the port's renderer, never the JAX package's library
mapped = [ln.split()[-1] for ln in open("/proc/self/maps") if ".so" in ln]
assert not [m for m in mapped if m.startswith({str(ROOT / REFERENCE)!r} + "/")], mapped
new = set(sys.modules) - before
print(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == {REFERENCE!r} or m.startswith({REFERENCE!r} + ".")))
print(sorted(m for m in new if m == "jax" or m.startswith("jax.")))
"""


def test_a_cpu_round_loads_no_jax_and_no_reference_module():
    # -I: no PYTHONPATH and no user site, so nothing but the port is loaded
    proc = subprocess.run(
        [sys.executable, "-I", "-c", ROUND], capture_output=True, text=True, timeout=300, cwd=str(ROOT)
    )
    assert proc.returncode == 0, proc.stderr
    loaded, new_jax = proc.stdout.strip().splitlines()[-2:]
    assert loaded == "[]", loaded
    assert new_jax == "[]", new_jax


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device resolves instead of raising")
    from kube_scheduler_simulator_tpu_torch.device import resolve_device, resolve_dtype
    from kube_scheduler_simulator_tpu_torch.gang import engine as GE
    from kube_scheduler_simulator_tpu_torch.gang import kernel as GK
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.ops import batch as TB
    from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.lower(None)
    store = ClusterStore()
    store.create("podgroups", {"metadata": {"name": "g"}, "spec": {"minMember": 1}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GE.group_preview(store, store.get("podgroups", "g"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GK.run_window_verdict([0], [0], [[0]], [0], [1], 1)
    from kube_scheduler_simulator_tpu_torch.autoscaler import ScaleUpEstimator

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScaleUpEstimator()
    from kube_scheduler_simulator_tpu_torch.tuning import run_tuning
    from kube_scheduler_simulator_tpu_torch.tuning.tuner import TuningSession

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tuning(n_nodes=4, n_pods=8, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TuningSession([], [], [("NodeResourcesFit", 1)])
    from kube_scheduler_simulator_tpu_torch.fuzz import FuzzHarness, ProcessChaos, replay_fixture, run_differential

    with pytest.raises(RuntimeError, match="no CUDA device"):
        FuzzHarness()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProcessChaos({"name": "s", "features": [], "ticks": []})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_differential({"name": "s", "features": [], "ticks": []})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay_fixture({"scenario": {"name": "s", "features": [], "ticks": []}, "comparisons": []})
    assert resolve_device("cpu").type == "cpu"
    assert resolve_dtype(resolve_device("cpu")) == torch.float64
    assert resolve_dtype(torch.device("cuda")) == torch.float32
    assert resolve_dtype(resolve_device("cpu"), torch.float32) == torch.float32
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


@pytest.mark.gpu
def test_a_cuda_round_launches_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sys.path.insert(0, str(ROOT))
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels
    from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine

    nodes, all_pods, pending = workloads.cluster(40, 60, seed=1)
    kernels.reset_counts()
    res = BatchEngine(scores=[("NodeResourcesFit", 1)], trace=True).schedule(nodes, all_pods, pending)
    assert kernels.LAUNCHES == {
        "scan": 1, "scan_lanes": 0, "scan_sharded": 0, "scan_lanes_sharded": 0, "compact": 1, "scatter": 0, "preempt": 0,
        "gang_verdict": 0, "gang_feasibility": 0, "scan_population": 0, "objective": 0, "scan_grad": 0, "grad_contract": 0,
    }
    assert sum(s is not None for s in res.selected_nodes) == 40


def test_every_library_entry_the_loader_binds_is_in_its_source():
    """``kernels.build`` loads each csrc/ source's library and binds the
    entries of ``kernels.ENTRIES`` (the tuner's objective kernel among
    them): each is an ``extern "C"`` function of that source."""
    import re

    from kube_scheduler_simulator_tpu_torch.ops import kernels

    assert set(kernels.ENTRIES) == set(kernels.SOURCES) and kernels.SOURCES["objective"] == "tune.cu"
    for lib, entries in kernels.ENTRIES.items():
        text = (kernels.CSRC / kernels.SOURCES[lib]).read_text()
        exported = set(re.findall(r'extern "C" int (\w+)\(', text))
        assert set(entries) <= exported, (lib, set(entries) - exported)


PROCESS = f"""
import logging, os, runpy, signal, sys, threading, time, urllib.request
sys.path.insert(0, {str(ROOT)!r})
sys.argv = ["kube_scheduler_simulator_tpu_torch", "--device", "cpu"]
ports = []


class Ports(logging.Handler):
    def emit(self, rec):
        if rec.getMessage().startswith("simulator server started"):
            ports.append(rec.args)


logging.getLogger("simulator").addHandler(Ports())


def check():
    while not ports:
        time.sleep(0.05)
    port, kube = ports[0]
    with urllib.request.urlopen(f"http://127.0.0.1:{{port}}/api/v1/schedulerconfiguration", timeout=30) as r:
        print("status", r.status, int(kube) > 0 and int(kube) != 3131)
    print(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == {REFERENCE!r} or m.startswith({REFERENCE!r} + ".")))
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGTERM)


threading.Thread(target=check, daemon=True).start()
runpy.run_module("kube_scheduler_simulator_tpu_torch", run_name="__main__")
"""


def _process_env() -> dict:
    import os

    env = {k: v for k, v in os.environ.items() if not k.startswith("KSS_")}
    env.update(PORT="0", KUBE_API_PORT="0")
    return env


def test_the_process_boots_on_the_cpu_and_loads_no_jax(tmp_path):
    """``python -m kube_scheduler_simulator_tpu_torch --device cpu`` on
    ephemeral ports answers a request, and neither JAX nor the JAX package
    is in its ``sys.modules``."""
    proc = subprocess.run([sys.executable, "-I", "-c", PROCESS], capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path), env=_process_env())
    assert proc.returncode == 0, proc.stderr
    status, loaded = proc.stdout.strip().splitlines()[-2:]
    assert status == "status 200 True", proc.stdout
    assert loaded == "[]", loaded


def test_the_process_refuses_to_start_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the process starts on it")
    # -m reads the package from the working directory, the repo's root
    proc = subprocess.run([sys.executable, "-m", "kube_scheduler_simulator_tpu_torch"], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT), env=_process_env())
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "simulator server started" not in proc.stderr
