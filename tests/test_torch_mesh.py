"""The port's mesh boundary (ops/mesh.py) against the JAX package's.

``KSS_MESH_DEVICES`` is accepted or rejected as the reference does it: for
each listed value both packages return "no mesh", or both raise
``MeshConfigError`` naming the same rule (the reference runs over
tests/conftest.py's 8 virtual CPU devices, the port's CPU engine sees one
device).  A count above the port's visible devices raises on the port,
and ``SchedulerService`` and ``ScaleUpEstimator`` validate the knob at
their boundary as the reference's do; a valid explicit mesh is accepted
and shards the node axis (tests/test_torch_shard.py holds its rounds).
"""

from __future__ import annotations

import random

import pytest
import torch

from kube_scheduler_simulator_tpu.ops import mesh as ref_mesh
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore
from kube_scheduler_simulator_tpu_torch.autoscaler.estimator import ScaleUpEstimator
from kube_scheduler_simulator_tpu_torch.ops import mesh as port_mesh
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

# the rule each rejection names, by a phrase both packages' messages hold
RULES = ("must be a positive integer", "must be >= 1", "is not a power of two", "visible device")


def _outcome(fn) -> "tuple[str, str | None]":
    try:
        mesh = fn()
    except ref_mesh.MeshConfigError as e:
        return "raise", next(r for r in RULES if r in str(e))
    except port_mesh.MeshConfigError as e:
        return "raise", next(r for r in RULES if r in str(e))
    return ("mesh", None) if mesh is not None else ("none", None)


@pytest.mark.parametrize("value", ["", "0", "1", "-2", "two", "3", "6"], ids=repr)
@pytest.mark.parametrize("entry", ["mesh_from_env", "resolve_mesh"])
def test_the_knob_is_accepted_or_rejected_as_the_reference_does(monkeypatch, entry, value):
    monkeypatch.setenv("KSS_MESH_DEVICES", value)
    if entry == "mesh_from_env":
        want = _outcome(ref_mesh.mesh_from_env)
        got = _outcome(lambda: port_mesh.mesh_from_env(device="cpu"))
    else:
        want = _outcome(lambda: ref_mesh.resolve_mesh("auto"))
        got = _outcome(lambda: port_mesh.resolve_mesh("auto", device="cpu"))
    assert got == want
    assert want[0] in ("none", "raise")


@pytest.mark.parametrize("value", ["2", "4", "1024"])
def test_a_count_above_the_visible_devices_raises_on_the_port(monkeypatch, value):
    monkeypatch.setenv("KSS_MESH_DEVICES", value)
    with pytest.raises(port_mesh.MeshConfigError, match="exceeds the 1 visible device"):
        port_mesh.mesh_from_env(device="cpu")
    if torch.cuda.device_count() < int(value):
        with pytest.raises(port_mesh.MeshConfigError, match="visible device"):
            port_mesh.mesh_from_env(device="cuda")


def test_explicit_meshes_and_the_helpers():
    mesh = port_mesh.NodeMesh((torch.device("cpu"), torch.device("cpu")))
    assert port_mesh.resolve_mesh(mesh) is mesh and port_mesh.resolve_mesh(None) is None
    assert port_mesh.mesh_devices(mesh) == 2 and port_mesh.mesh_devices(None) == 0
    assert port_mesh.mesh_on_accelerator(mesh) is False and port_mesh.mesh_on_accelerator(None) is False
    assert port_mesh.mesh_on_accelerator(port_mesh.NodeMesh((torch.device("cuda", 0),))) is True
    with pytest.raises(port_mesh.MeshConfigError, match="'nodes'"):
        port_mesh.resolve_mesh(port_mesh.NodeMesh((torch.device("cpu"),), "batch"))
    with pytest.raises(port_mesh.MeshConfigError, match="'auto'"):
        port_mesh.resolve_mesh("everywhere")
    assert port_mesh.AXIS_NAME == ref_mesh.AXIS_NAME and issubclass(port_mesh.MeshConfigError, ValueError)


@pytest.mark.parametrize("value", ["0", "two", "3"], ids=repr)
def test_the_service_and_the_estimator_raise_as_the_reference_does(monkeypatch, value):
    monkeypatch.setenv("KSS_MESH_DEVICES", value)
    with pytest.raises(ref_mesh.MeshConfigError) as ref_err:
        JaxService(JaxStore())
    with pytest.raises(port_mesh.MeshConfigError) as port_err:
        SchedulerService(ClusterStore(), device="cpu")
    assert next(r for r in RULES if r in str(port_err.value)) == next(r for r in RULES if r in str(ref_err.value))
    with pytest.raises(port_mesh.MeshConfigError):
        ScaleUpEstimator(mesh="auto", device="cpu")


def test_unset_empty_and_one_run_on_one_device(monkeypatch):
    for value in (None, "", "1"):
        if value is None:
            monkeypatch.delenv("KSS_MESH_DEVICES", raising=False)
        else:
            monkeypatch.setenv("KSS_MESH_DEVICES", value)
        assert SchedulerService(ClusterStore(), device="cpu").device.type == "cpu"
        assert ScaleUpEstimator(mesh="auto", device="cpu").engine is not None


def test_a_valid_mesh_is_refused_until_the_node_axis_is_sharded():
    """(The name predates the sharded node axis.)  A valid explicit mesh of
    two shards on one device is accepted by the service and the estimator,
    and its round equals the single-device round."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state

    mesh = port_mesh.NodeMesh((torch.device("cpu"), torch.device("cpu")))
    assert ScaleUpEstimator(mesh=mesh, device="cpu").mesh is mesh
    states = []
    for m in (None, mesh):
        store = ClusterStore(clock=lambda: 0.0)
        for i in range(9):
            store.create("nodes", workloads.mk_node(i))
        rng = random.Random(2)
        for i in range(14):
            store.create("pods", workloads.stamp(workloads.mk_pod(i, rng, spread=i % 3 == 0), i))
        svc = SchedulerService(store, mesh=m, device="cpu", use_batch="force", batch_min_work=0)
        assert svc.mesh is m
        svc.start_scheduler(None)
        svc.schedule_pending(max_rounds=1)
        states.append(pod_parity_state(store))
    assert states[0] == states[1] and any(v[0] for v in states[0].values())
    assert svc.metrics()["shard_devices"] == 2 and not svc.stats["batch_fallbacks"]
