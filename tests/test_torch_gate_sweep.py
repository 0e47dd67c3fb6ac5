"""Parity gate: the reference's large seeded sweep through the port's
batch round.

The workload of tests/test_batch_parity.py's
``test_large_scale_seeded_parity_sweep`` (1 000 pods x 500 nodes over
NodeResourcesFit, TaintToleration, NodeAffinity, PodTopologySpread and
InterPodAffinity: taints on every 11th node, node selectors, tolerations,
spread on every 3rd pod, preferred anti-affinity on every 5th) goes
through the port's ``SchedulerService`` on the CPU (float64, one batch
round) and through the JAX package's service in its sequential cycle
(``use_batch="off"``); every pod must carry equal node, annotations and
status.  Under ``first`` every node is scored; under ``reservoir`` 30 %
of them.
"""

from __future__ import annotations

import random
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from test_batch_parity import mk_node, mk_pod, profile_with  # noqa: E402
from test_torch_service import assert_same, pod_states  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402

PLUGINS = ["NodeResourcesFit", "TaintToleration", "NodeAffinity", "PodTopologySpread", "InterPodAffinity"]


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def sweep(store, P: int = 1000, N: int = 500) -> None:
    """test_large_scale_seeded_parity_sweep's nodes and pods (seed 1234)."""
    rng = random.Random(1234)
    for i in range(N):
        labels = {
            "topology.kubernetes.io/zone": f"z{i % 7}",
            "kubernetes.io/hostname": f"node-{i}",
            "disk": "ssd" if i % 3 else "hdd",
        }
        taints = (
            [{"key": "spot", "value": "true", "effect": rng.choice(["NoSchedule", "PreferNoSchedule"])}]
            if i % 11 == 0
            else None
        )
        store.create("nodes", mk_node(f"node-{i}", cpu_m=rng.choice([16000, 32000, 64000]), mem_mi=65536,
                                      labels=labels, taints=taints))
    for i in range(P):
        p = mk_pod(
            f"pod-{i}",
            cpu_m=rng.choice([50, 100, 250, 500]),
            mem_mi=rng.choice([64, 128, 256]),
            labels={"app": f"app-{i % 5}", "tier": "web" if i % 2 else "db"},
        )
        if i % 4 == 0:
            p["spec"]["nodeSelector"] = {"disk": "ssd"}
        if i % 6 == 0:
            p["spec"]["tolerations"] = [{"key": "spot", "operator": "Exists"}]
        if i % 3 == 0:
            p["spec"]["topologySpreadConstraints"] = [
                {
                    "maxSkew": 4,
                    "topologyKey": "topology.kubernetes.io/zone",
                    "whenUnsatisfiable": "DoNotSchedule",
                    "labelSelector": {"matchLabels": {"app": f"app-{i % 5}"}},
                },
                {
                    "maxSkew": 6,
                    "topologyKey": "kubernetes.io/hostname",
                    "whenUnsatisfiable": "ScheduleAnyway",
                    "labelSelector": {"matchLabels": {"app": f"app-{i % 5}"}},
                },
            ]
        if i % 5 == 1:
            p["spec"]["affinity"] = {
                "podAntiAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {
                            "weight": 10,
                            "podAffinityTerm": {
                                "labelSelector": {"matchLabels": {"app": f"app-{i % 5}"}},
                                "topologyKey": "kubernetes.io/hostname",
                            },
                        }
                    ]
                }
            }
        store.create("pods", p)


@pytest.mark.parametrize("tie,percentage", [("first", 100), ("reservoir", 30)])
def test_seeded_sweep_batch_round_matches_the_reference_sequential_cycle(tie, percentage):
    cfg = {"profiles": [profile_with(PLUGINS)], "percentageOfNodesToScore": percentage}
    states = []
    for Svc, Store, kw in (
        (SchedulerService, ClusterStore, dict(use_batch="auto", batch_min_work=0, device="cpu")),
        (JaxService, JaxStore, dict(use_batch="off")),
    ):
        store = Store(clock=lambda: 0.0)
        sweep(store)
        svc = Svc(store, tie_break=tie, **kw)
        svc.start_scheduler(cfg)
        svc.schedule_pending(max_rounds=1)
        states.append((svc, pod_states(store)))
    (port, got), (ref, want) = states
    assert_same(got, want)
    assert port.stats["batch_pods"] == 1000 and not port.stats["batch_fallbacks"]
    assert ref.stats["sequential_pods"] == 1000
    assert sum(node is not None for node, _a, _s in got.values()) == 1000
