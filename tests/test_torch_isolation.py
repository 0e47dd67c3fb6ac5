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
        "scan": 1, "scan_lanes": 0, "compact": 1, "scatter": 0, "preempt": 0, "gang_verdict": 0, "gang_feasibility": 0,
        "scan_population": 0, "objective": 0, "scan_grad": 0, "grad_contract": 0,
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
