"""Seeded synthetic clusters: the benchmark's node and pod generators.

``mk_node`` / ``mk_pod`` are the generators of the JAX package's bench
(BASELINE cfg1-cfg5 shapes: 64-core / 256 Gi nodes in 8 zones, every 16th
node carrying a PreferNoSchedule taint; pods of 100m-1000m CPU and
128-1024 Mi memory, every 4th with a nodeSelector; bench's two spread
constraints and its preferred podAntiAffinity on request).  ``cluster``
builds a whole seeded snapshot and adds the features the port's other
filters and scores read (NoSchedule taints and tolerations, an
unschedulable node, a nodeName-pinned pod, container images on nodes and
pods), all drawn from the same seed.
"""

from __future__ import annotations

import random


def mk_node(i: int, zones: int = 8) -> dict:
    return {
        "metadata": {
            "name": f"node-{i}",
            "labels": {
                "topology.kubernetes.io/zone": f"zone-{i % zones}",
                "kubernetes.io/hostname": f"node-{i}",
                "disk": "ssd" if i % 2 else "hdd",
            },
        },
        "spec": (
            {"taints": [{"key": "spot", "value": "true", "effect": "PreferNoSchedule"}]}
            if i % 16 == 0
            else {}
        ),
        "status": {"allocatable": {"cpu": "64000m", "memory": "256Gi", "pods": "512"}},
    }


def _interpod_affinity(i: int) -> dict:
    """Pod i's inter-pod terms: bench's preferred anti-affinity on hostname
    for odd pods (weight 10, against its own app), a required
    anti-affinity on hostname against its own app for every 25th pod, and
    a required affinity to a ``tier=web`` pod's zone for pods 20, 60, ..."""
    app = {"matchLabels": {"app": f"app-{i % 8}"}}
    aff: dict = {}
    anti: dict = {}
    if i % 2:
        anti["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": 10, "podAffinityTerm": {"labelSelector": app, "topologyKey": "kubernetes.io/hostname"}}
        ]
    if i % 25 == 0:
        anti["requiredDuringSchedulingIgnoredDuringExecution"] = [
            {"labelSelector": app, "topologyKey": "kubernetes.io/hostname"}
        ]
    if i % 40 == 20:
        aff["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"tier": "web"}}, "topologyKey": "topology.kubernetes.io/zone"}
            ]
        }
    if anti:
        aff["podAntiAffinity"] = anti
    return aff


def mk_pod(i: int, rng: random.Random, spread: bool = False, interpod: bool = False) -> dict:
    spec: dict = {
        "containers": [
            {
                "name": "c",
                "resources": {
                    "requests": {
                        "cpu": f"{rng.choice([100, 250, 500, 1000])}m",
                        "memory": f"{rng.choice([128, 256, 512, 1024])}Mi",
                    }
                },
            }
        ]
    }
    labels = {"app": f"app-{i % 8}", "tier": "web" if i % 2 else "db"}
    if i % 4 == 0:
        spec["nodeSelector"] = {"disk": "ssd"}
    if spread:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": 3,
                "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": f"app-{i % 8}"}},
            },
            {
                "maxSkew": 5,
                "topologyKey": "kubernetes.io/hostname",
                "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": f"app-{i % 8}"}},
            },
        ]
    if interpod and (aff := _interpod_affinity(i)):
        spec["affinity"] = aff
    return {"metadata": {"name": f"pod-{i}", "namespace": "default", "labels": labels}, "spec": spec}


IMAGES = [(f"registry.example/app-{k}:v1", (k + 1) * 150 * 1024 * 1024) for k in range(6)]


def cluster(n_pods: int, n_nodes: int, seed: int = 42, n_bound: int = 0, spread=False, interpod=False):
    """(nodes, all_pods, pending) of a seeded cluster in queue order.

    Beyond the bench shapes, drawn from the same seed: NoSchedule taints
    on every 8th node with tolerations on every 3rd pod, node 3
    unschedulable (every 10th pod tolerates it), pod 5 pinned to
    ``node-7`` by nodeName, and container images on nodes and pods
    (ImageLocality).  ``n_bound`` pods
    are bound round-robin before the round, so the carry starts non-empty.
    ``spread`` and ``interpod`` are predicates on the pod index (bound pods
    first), or False: the pods they pick carry the spread constraints and
    the inter-pod terms of ``mk_pod``.
    """
    rng = random.Random(seed)
    nodes = [mk_node(i) for i in range(n_nodes)]
    pods = [
        mk_pod(i, rng, spread=bool(spread and spread(i)), interpod=bool(interpod and interpod(i)))
        for i in range(n_pods + n_bound)
    ]
    for i, n in enumerate(nodes):
        if i % 8 == 3:
            n["spec"] = {
                "taints": [{"key": "dedicated", "value": f"team-{i % 3}", "effect": "NoSchedule"}]
                + n["spec"].get("taints", [])
            }
        n["status"]["images"] = [
            {"names": [nm], "sizeBytes": sz} for nm, sz in IMAGES if rng.random() < 0.4
        ]
    if n_nodes > 3:
        nodes[3]["spec"]["unschedulable"] = True
    for i, p in enumerate(pods):
        spec = p["spec"]
        spec["containers"][0]["image"] = IMAGES[rng.randrange(len(IMAGES))][0]
        if i % 3 == 0:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Equal", "value": f"team-{i % 3}", "effect": "NoSchedule"}]
        if i % 10 == 0:
            spec.setdefault("tolerations", []).append(
                {"key": "node.kubernetes.io/unschedulable", "operator": "Exists", "effect": "NoSchedule"}
            )
    if n_pods > 5 and n_nodes > 7:
        pods[n_bound + 5]["spec"]["nodeName"] = "node-7"
    for j, p in enumerate(pods[:n_bound]):
        p["spec"]["nodeName"] = f"node-{j % n_nodes}"
    return nodes, pods, pods[n_bound:]
