"""The distributed-training scenario family: gangs with churn.

``make_training_scenario`` emits a KEP-140 Scenario whose operations
model a DL training cluster: jobs (PodGroup + member pods) arrive over
MajorSteps, run for a few steps, and complete (members + group deleted),
so every replay exercises arrival churn, all-or-nothing release waves,
and the capacity freed by completions — the workload class the gang
engine exists for.  Everything is seeded ``random.Random`` + counter
names, so the same arguments always produce the same Scenario and — with
a ScenarioClock-driven service — the same byte-identical replay.

Port of the JAX package's ``gang/scenario.py``, copied whole; the
scenario engine that replays it (``scenario/``) is not ported yet.
"""

from __future__ import annotations

import random
from typing import Any

from kube_scheduler_simulator_tpu_torch.gang.podgroups import POD_GROUP_LABEL

Obj = dict[str, Any]

ZONES = ("zone-a", "zone-b", "zone-c", "zone-d")


def make_node(name: str, cpu: int, zone: str) -> Obj:
    return {
        "metadata": {
            "name": name,
            "labels": {
                "kubernetes.io/hostname": name,
                "topology.kubernetes.io/zone": zone,
            },
        },
        "status": {
            "allocatable": {"cpu": str(cpu), "memory": "256Gi", "pods": "110"}
        },
    }


def make_member(name: str, group: str, cpu: str = "1") -> Obj:
    return {
        "metadata": {"name": name, "namespace": "default", "labels": {POD_GROUP_LABEL: group}},
        "spec": {
            "containers": [
                {"name": "trainer", "resources": {"requests": {"cpu": cpu, "memory": "1Gi"}}}
            ]
        },
    }


def make_training_scenario(
    jobs: int = 12,
    min_members: int = 2,
    max_members: int = 8,
    nodes: int = 8,
    node_cpu: int = 16,
    arrival_majors: int = 4,
    complete_after: int = 2,
    member_cpu: str = "1",
    timeout_s: float = 120.0,
    seed: int = 0,
) -> Obj:
    """A Scenario: ``nodes`` nodes at major 1, then ``jobs`` training
    jobs arriving round-robin over ``arrival_majors`` majors, each
    completing (pods + group deleted) ``complete_after`` majors after
    arrival."""
    rng = random.Random(seed)
    ops: list[Obj] = []
    oid = 0

    def op(major: int, field: str, body: Obj) -> None:
        nonlocal oid
        oid += 1
        ops.append({"id": str(oid), "step": {"major": major}, field: body})

    for i in range(nodes):
        op(
            1,
            "createOperation",
            {
                "typeMeta": {"kind": "Node"},
                "object": make_node(f"node-{i}", node_cpu, ZONES[i % len(ZONES)]),
            },
        )

    job_members: dict[int, int] = {}
    job_major: dict[int, int] = {}
    for j in range(jobs):
        arrive = 2 + (j % max(arrival_majors, 1))
        job_major[j] = arrive
        members = rng.randint(min_members, max_members)
        job_members[j] = members
        op(
            arrive,
            "createOperation",
            {
                "typeMeta": {"kind": "PodGroup"},
                "object": {
                    "metadata": {"name": f"job-{j}", "namespace": "default"},
                    "spec": {
                        "minMember": members,
                        "scheduleTimeoutSeconds": timeout_s,
                        "topologyPackKey": "topology.kubernetes.io/zone",
                    },
                },
            },
        )
        for m in range(members):
            op(
                arrive,
                "createOperation",
                {
                    "typeMeta": {"kind": "Pod"},
                    "object": make_member(f"job-{j}-m{m}", f"job-{j}", member_cpu),
                },
            )

    last_major = 2 + max(arrival_majors, 1) + complete_after
    for j in range(jobs):
        done_at = job_major[j] + complete_after
        for m in range(job_members[j]):
            op(
                done_at,
                "deleteOperation",
                {
                    "typeMeta": {"kind": "Pod"},
                    "objectMeta": {"name": f"job-{j}-m{m}", "namespace": "default"},
                },
            )
        op(
            done_at,
            "deleteOperation",
            {
                "typeMeta": {"kind": "PodGroup"},
                "objectMeta": {"name": f"job-{j}", "namespace": "default"},
            },
        )
        last_major = max(last_major, done_at)

    op(last_major + 1, "doneOperation", {})
    return {
        "metadata": {"name": f"training-churn-{seed}", "namespace": "default"},
        "spec": {"operations": ops, "stepSeconds": 1.0},
    }
