"""Parity gate: the port's batch round past the reference's volume-id cap.

The JAX package's batch engine refuses a round with more than 256 distinct
CSI/PVC volume ids; the port's scan reads only each pod's own ids and
batches it.  A seeded cluster of 1 800 pods x 100 nodes with
``workloads.add_host_ports`` and ``add_volumes`` (272 ids) through the
port's ``SchedulerService`` on the CPU (float64, one batch round, upstream's
default profile) and through the JAX package's service in its sequential
cycle: every pod must carry equal node, annotations and status.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.scheduler.batch_engine import BatchEngine as JaxEngine  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from test_torch_service import assert_same, pod_states  # noqa: E402
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402

P, N = 1800, 100


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def snapshot():
    """(nodes, all pods, pending pods, volume objects): 1 800 pending pods
    over 100 nodes, seed 42, host ports and volumes."""
    nodes, all_pods, pending = workloads.cluster(P, N)
    workloads.add_host_ports(all_pods)
    vols = workloads.add_volumes(nodes, all_pods)
    return nodes, all_pods, pending, vols


def volume_ids(pending) -> int:
    """Distinct CSI/PVC volume ids of the pending pods, as the reference
    counts them for its cap: a claim once, an inline CSI volume per pod."""
    ids = set()
    for p in pending:
        ns = p["metadata"].get("namespace", "default")
        for v in (p.get("spec") or {}).get("volumes") or []:
            if v.get("persistentVolumeClaim"):
                ids.add(f"pvc:{ns}/{v['persistentVolumeClaim'].get('claimName', '')}")
            elif v.get("csi"):
                ids.add(f"inline:{ns}/{p['metadata']['name']}/{v.get('name', '')}")
    return len(ids)


def test_batch_round_past_the_volume_id_cap_matches_the_reference_sequential_cycle():
    nodes, all_pods, pending, vols = snapshot()
    assert volume_ids(pending) == 272
    ok, why = JaxEngine().supported(pending, nodes, vols)
    assert not ok and "volume ids exceed" in why, why
    states = []
    for Svc, Store, kw in (
        (SchedulerService, ClusterStore, dict(use_batch="auto", batch_min_work=0, device="cpu")),
        (JaxService, JaxStore, dict(use_batch="off")),
    ):
        store = Store(clock=lambda: 0.0)
        for kind, objs in vols.items():
            for o in objs:
                store.create(kind, o)
        for n in nodes:
            store.create("nodes", n)
        for p in all_pods:
            store.create("pods", p)
        svc = Svc(store, tie_break="first", **kw)
        svc.start_scheduler(None)
        svc.schedule_pending(max_rounds=1)
        states.append((svc, pod_states(store)))
    (port, got), (ref, want) = states
    assert_same(got, want)
    # one batch round; a pod that fails it and asks for host ports takes
    # DefaultPreemption's sequential cycle (outside the batched search)
    assert port.stats["batch_commits"] == 1 and not port.stats["batch_fallbacks"]
    assert port.stats["batch_pods"] >= P - 2
    assert ref.stats["batch_pods"] == 0
    assert sum(node is not None for node, _a, _s in got.values()) > P // 2
