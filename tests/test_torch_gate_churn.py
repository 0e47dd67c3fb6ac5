"""Parity gate: the reference's churn parity workload without the mesh.

``__graft_entry__._churn_parity`` (its single-device side): 64 nodes of 16
CPU and 32Gi in 4 zones, 3 waves of 120 pods (spread on every 3rd pod,
preferred anti-affinity on every odd one, requests drawn from
``random.Random(1000 + wave)``), every 10th bound pod deleted after each
wave, the full default profile with the trace on, one batch round a wave.
The port's ``SchedulerService`` on the CPU (float64) against the JAX
package's (x64), store clocks frozen: after every wave every pod carries
equal node, annotations and status.
"""

from __future__ import annotations

import copy
import random
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from test_torch_service import assert_same, pod_states  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402

N, P_WAVE, WAVES = 64, 120, 3


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def node_obj(i: int) -> dict:
    return {
        "metadata": {
            "name": f"cn-{i:03d}",
            "labels": {"topology.kubernetes.io/zone": f"z{i % 4}", "kubernetes.io/hostname": f"cn-{i:03d}"},
        },
        "status": {"allocatable": {"cpu": "16000m", "memory": "32Gi", "pods": "64"}},
    }


def pod_obj(i: int, rng: random.Random) -> dict:
    spec: dict = {
        "containers": [
            {
                "name": "c",
                "resources": {
                    "requests": {
                        "cpu": f"{rng.choice([100, 250, 500])}m",
                        "memory": f"{rng.choice([128, 256])}Mi",
                    }
                },
            }
        ]
    }
    if i % 3 == 0:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": 2,
                "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": f"a{i % 4}"}},
            }
        ]
    if i % 2:
        spec["affinity"] = {
            "podAntiAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {
                        "weight": 5,
                        "podAffinityTerm": {
                            "labelSelector": {"matchLabels": {"app": f"a{i % 4}"}},
                            "topologyKey": "kubernetes.io/hostname",
                        },
                    }
                ]
            }
        }
    return {"metadata": {"name": f"cp-{i:04d}", "namespace": "default", "labels": {"app": f"a{i % 4}"}}, "spec": spec}


@pytest.mark.parametrize("tie", ["first", "reservoir"])
def test_churn_parity_workload_matches_the_reference_every_wave(tie):
    services = []
    for Svc, Store, kw in ((SchedulerService, ClusterStore, {"device": "cpu"}), (JaxService, JaxStore, {})):
        store = Store(clock=lambda: 0.0)
        for i in range(N):
            store.create("nodes", node_obj(i))
        svc = Svc(store, tie_break=tie, use_batch="auto", batch_min_work=0, **kw)
        svc.start_scheduler(None)
        services.append(svc)
    port, ref = services
    created = compared = 0
    for w in range(WAVES):
        rng = random.Random(1000 + w)
        batch = [pod_obj(created + j, rng) for j in range(P_WAVE)]
        created += P_WAVE
        for svc in services:
            for pod in batch:
                svc.cluster_store.create("pods", copy.deepcopy(pod))
            svc.schedule_pending(max_rounds=1)
        got, want = pod_states(port.cluster_store), pod_states(ref.cluster_store)
        assert_same(got, want)
        compared += len(want)
        bound = sorted(name for name, (node, _a, _s) in want.items() if node)
        for svc in services:
            for name in bound[::10]:
                svc.cluster_store.delete("pods", name, "default")
    assert compared >= WAVES * P_WAVE
    assert port.stats["batch_commits"] == WAVES and not port.stats["batch_fallbacks"]
    assert port.stats["sequential_pods"] == 0
