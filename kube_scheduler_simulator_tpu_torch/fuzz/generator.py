"""Seeded composite-scenario generation.

A *fuzz scenario* is a deterministic function of ``(seed, index)``: a
timeline of ticks, each a list of store operations (creates / deletes /
patches / live weight retunes), composing at least three of the repo's
subsystems at once — gang PodGroups (the Tesserae workload class),
preemption-inducing priority/PDB mixes, autoscale node-group timelines,
mid-stream node/taint churn with PDB flips, and live
``set_plugin_weights`` retunes.  The structure (which subsystems a
scenario exercises) is drawn through :mod:`fuzz.coverage`'s
diversity-seeking buckets, not uniform noise; everything below the
bucket — sizes, shapes, arrival order, flip timing — comes from the
scenario's own ``random.Random``.

The op vocabulary is deliberately tiny and JSON-serializable (the
shrinker deletes ops and re-serializes scenarios into committed
fixtures):

    {"op": "create", "kind": K, "object": {...}}
    {"op": "delete", "kind": K, "name": N, "namespace": NS}
    {"op": "patch",  "kind": K, "name": N, "namespace": NS, "body": {...}}
    {"op": "weights", "weights": {name: w, ...}}

Determinism rules mirror the scenario families that came before
(gang/scenario.py, tuning/scenario.py): seeded rng + counter names +
explicit creationTimestamps (PrioritySort tie-breaks on them — the wall
clock must never leak in; the runner additionally pins both store and
service clocks with :class:`utils.SimClock`).  Churn deletes only touch
pods created two or more ticks earlier, the invariant that keeps a feed
phase-insensitive between the streamed and serial pipelines.
"""

from __future__ import annotations

import random
from typing import Any

from kube_scheduler_simulator_tpu_torch.fuzz.coverage import (
    FEATURES,
    MIN_COMPOSE,
    CoverageMap,
)

Obj = dict[str, Any]

ZONES = ("z0", "z1", "z2")

# names valid in both the default and the gang profile's score set —
# what a live retune op may override (tuning/validate.py mapping form)
RETUNE_NAMES = ("NodeResourcesFit", "TaintToleration", "PodTopologySpread", "InterPodAffinity")
RETUNE_VALUES = (0.5, 1.0, 2.0, 3.0)

GANG_TIMEOUTS = (3.0, 5.0, 300.0)


def _stamp(i: int) -> str:
    """Deterministic, strictly ordered creationTimestamp per pod index."""
    return f"2024-06-01T{(i // 3600) % 24:02d}:{(i // 60) % 60:02d}:{i % 60:02d}Z"


def _create(kind: str, obj: Obj) -> Obj:
    return {"op": "create", "kind": kind, "object": obj}


def _delete(kind: str, name: str, namespace: "str | None" = "default") -> Obj:
    return {"op": "delete", "kind": kind, "name": name, "namespace": namespace}


def _patch(kind: str, name: str, body: Obj, namespace: "str | None" = "default") -> Obj:
    return {"op": "patch", "kind": kind, "name": name, "namespace": namespace, "body": body}


def _node(prefix: str, i: int, cpu_m: int, mem_mi: int, taints: "list | None" = None) -> Obj:
    name = f"{prefix}-n{i}"
    n: Obj = {
        "metadata": {
            "name": name,
            "labels": {
                "kubernetes.io/hostname": name,
                "topology.kubernetes.io/zone": ZONES[i % len(ZONES)],
                "disk": "ssd" if i % 2 == 0 else "hdd",
            },
        },
        "status": {
            "allocatable": {"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi", "pods": "48"}
        },
    }
    if taints:
        n["spec"] = {"taints": taints}
    return n


def _pod(
    prefix: str,
    i: int,
    rng: random.Random,
    *,
    cpu_m: "int | None" = None,
    mem_mi: "int | None" = None,
    labels: "dict | None" = None,
    priority_class: "str | None" = None,
    group: "str | None" = None,
    spread: "bool | None" = None,
    selector: "bool | None" = None,
) -> Obj:
    labels = dict(labels or {})
    labels.setdefault("app", f"a{i % 3}")
    if group is not None:
        from kube_scheduler_simulator_tpu_torch.gang.podgroups import POD_GROUP_LABEL

        labels[POD_GROUP_LABEL] = group
    spec: Obj = {
        "containers": [
            {
                "name": "c",
                "resources": {
                    "requests": {
                        "cpu": f"{cpu_m if cpu_m is not None else rng.choice((100, 250, 500, 900))}m",
                        "memory": f"{mem_mi if mem_mi is not None else rng.choice((128, 256, 512))}Mi",
                    }
                },
            }
        ]
    }
    if priority_class:
        spec["priorityClassName"] = priority_class
    if spread if spread is not None else rng.random() < 0.3:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": 2,
                "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": labels["app"]}},
            }
        ]
    if selector if selector is not None else rng.random() < 0.2:
        spec["nodeSelector"] = {"disk": "ssd"}
    return {
        "metadata": {
            "name": f"{prefix}-p{i:04d}",
            "namespace": "default",
            "labels": labels,
            "creationTimestamp": _stamp(i),
        },
        "spec": spec,
    }


def generate_scenario(
    seed: int,
    index: int = 0,
    coverage: "CoverageMap | None" = None,
    features: "frozenset[str] | None" = None,
) -> Obj:
    """One composite scenario, a pure function of ``(seed, index)`` given
    the coverage map's accumulated counts.  ``features`` overrides the
    coverage draw (the shrinker and fixtures replay a recorded set)."""
    rng = random.Random(f"kss-fuzz:{seed}:{index}")
    if features is None:
        if coverage is None:
            features = frozenset(rng.sample(FEATURES, rng.randint(MIN_COMPOSE, len(FEATURES))))
        else:
            features = coverage.choose_features(rng)
    if coverage is not None:
        coverage.note(features)
    prefix = f"fz{seed}x{index}"
    n_ticks = rng.randint(6, 8)
    ticks: list[list[Obj]] = [[] for _ in range(n_ticks)]
    pod_i = 0
    # (name, created_tick) of churn-deletable pods; gang members and
    # preemption actors are excluded — deleting a parked / mid-preemption
    # pod from the feed would make the stream projection phase-sensitive
    deletable: list[tuple[str, int]] = []
    deleted: set[str] = set()

    # ---- tick 0: the cluster -------------------------------------------
    n_nodes = rng.randint(5, 8)
    cpu_shapes = (4000, 8000, 12000)
    for i in range(n_nodes):
        taints = None
        if rng.random() < 0.34:
            taints = [{"key": "spot", "value": "true", "effect": "PreferNoSchedule"}]
        ticks[0].append(
            _create("nodes", _node(prefix, i, rng.choice(cpu_shapes), rng.choice((8192, 16384)), taints))
        )
    next_node_i = n_nodes

    if "preemption" in features:
        ticks[0].append(
            _create(
                "priorityclasses",
                {"metadata": {"name": f"{prefix}-prio-high"}, "value": 100000},
            )
        )
        ticks[0].append(
            _create(
                "priorityclasses",
                {"metadata": {"name": f"{prefix}-prio-low"}, "value": 10},
            )
        )
        # PDB over the filler cohort: some victims are budget-protected
        ticks[0].append(
            _create(
                "poddisruptionbudgets",
                {
                    "metadata": {"name": f"{prefix}-pdb", "namespace": "default"},
                    "spec": {
                        "minAvailable": rng.randint(1, 3),
                        "selector": {"matchLabels": {"cohort": f"{prefix}-filler"}},
                    },
                },
            )
        )

    if "autoscale" in features:
        ticks[0].append(
            _create(
                "nodegroups",
                {
                    "metadata": {"name": f"{prefix}-pool"},
                    "spec": {
                        "minSize": 0,
                        "maxSize": rng.randint(2, 4),
                        "template": {
                            "metadata": {
                                "labels": {
                                    "topology.kubernetes.io/zone": rng.choice(ZONES),
                                    "disk": "ssd",
                                }
                            },
                            "status": {
                                "allocatable": {
                                    "cpu": "8000m",
                                    "memory": "16Gi",
                                    "pods": "48",
                                }
                            },
                        },
                    },
                },
            )
        )

    # ---- base workload: plain pods arriving over the early/mid ticks ---
    arrivals = rng.randint(10, 18)
    for _ in range(arrivals):
        t = rng.randint(1, n_ticks - 3)
        p = _pod(prefix, pod_i, rng)
        ticks[t].append(_create("pods", p))
        deletable.append((p["metadata"]["name"], t))
        pod_i += 1

    if "preemption" in features:
        # low-priority filler early, then a high-priority burst that
        # exceeds what is left — the PostFilter victim search has to act
        filler_t = 1
        for _ in range(rng.randint(6, 10)):
            p = _pod(
                prefix,
                pod_i,
                rng,
                cpu_m=rng.choice((1500, 2500)),
                mem_mi=1024,
                labels={"cohort": f"{prefix}-filler"},
                priority_class=f"{prefix}-prio-low",
                spread=False,
                selector=False,
            )
            ticks[filler_t].append(_create("pods", p))
            pod_i += 1
        burst_t = rng.randint(3, n_ticks - 3)
        for _ in range(rng.randint(3, 5)):
            p = _pod(
                prefix,
                pod_i,
                rng,
                cpu_m=rng.choice((2500, 3500)),
                mem_mi=2048,
                priority_class=f"{prefix}-prio-high",
                spread=False,
                selector=False,
            )
            ticks[burst_t].append(_create("pods", p))
            pod_i += 1
        if rng.random() < 0.6:
            # PDB flip mid-run: the protection the victim search must
            # honor changes under the engines' feet
            flip_t = min(burst_t + 1, n_ticks - 2)
            ticks[flip_t].append(
                _patch(
                    "poddisruptionbudgets",
                    f"{prefix}-pdb",
                    {"spec": {"minAvailable": rng.randint(0, 4)}},
                )
            )

    if "gang" in features:
        n_groups = rng.randint(2, 3)
        for g in range(n_groups):
            arrive = rng.randint(1, n_ticks - 4)
            members = rng.randint(2, 4)
            # one group may arrive short of quorum: its members park at
            # Permit and the (possibly small) gang timeout has to expire
            # them — the rejection-cascade path
            short = g == n_groups - 1 and rng.random() < 0.5
            created = members - 1 if short else members
            gname = f"{prefix}-job{g}"
            ticks[arrive].append(
                _create(
                    "podgroups",
                    {
                        "metadata": {"name": gname, "namespace": "default"},
                        "spec": {
                            "minMember": members,
                            "scheduleTimeoutSeconds": rng.choice(GANG_TIMEOUTS),
                            "topologyPackKey": "topology.kubernetes.io/zone",
                        },
                    },
                )
            )
            for m in range(created):
                p = _pod(
                    prefix,
                    pod_i,
                    rng,
                    cpu_m=1000,
                    mem_mi=1024,
                    group=gname,
                    spread=False,
                    selector=False,
                )
                ticks[arrive].append(_create("pods", p))
                pod_i += 1
            if not short and rng.random() < 0.5:
                # job completes: members + group deleted two ticks later
                done = min(arrive + 2, n_ticks - 1)
                for m in range(created):
                    ticks[done].append(
                        _delete("pods", f"{prefix}-p{pod_i - created + m:04d}")
                    )
                ticks[done].append(_delete("podgroups", gname))

    if "churn" in features:
        # pod churn: delete settled pods (created >= 2 ticks earlier —
        # the stream-feed phase-insensitivity rule)
        for t in range(3, n_ticks - 1):
            settled = [nm for nm, ct in deletable if ct <= t - 2 and nm not in deleted]
            for nm in rng.sample(settled, min(len(settled), rng.randint(0, 2))):
                deleted.add(nm)
                ticks[t].append(_delete("pods", nm))
        # node churn: drop one base node mid-run, add a fresh one later,
        # and flip taints on another — every encode-invalidation gate at once
        if rng.random() < 0.7:
            t = rng.randint(2, n_ticks - 3)
            ticks[t].append(_delete("nodes", f"{prefix}-n{rng.randrange(n_nodes)}", None))
        if rng.random() < 0.7:
            t = rng.randint(2, n_ticks - 2)
            ticks[t].append(
                _create(
                    "nodes",
                    _node(prefix, next_node_i, rng.choice(cpu_shapes), 16384),
                )
            )
            next_node_i += 1
        if rng.random() < 0.7:
            t = rng.randint(2, n_ticks - 2)
            ticks[t].append(
                _patch(
                    "nodes",
                    f"{prefix}-n{rng.randrange(n_nodes)}",
                    {
                        "spec": {
                            "taints": [
                                {"key": "spot", "value": "true", "effect": "PreferNoSchedule"}
                            ]
                        }
                    },
                    None,
                )
            )

    if "retune" in features:
        # live set_plugin_weights retunes mid-run (value-only changes: the
        # traced engines re-dispatch, never recompile)
        for _ in range(rng.randint(1, 2)):
            t = rng.randint(1, n_ticks - 2)
            mapping = {
                nm: rng.choice(RETUNE_VALUES)
                for nm in rng.sample(RETUNE_NAMES, rng.randint(1, 3))
            }
            ticks[t].append({"op": "weights", "weights": mapping})

    return {
        "name": f"fuzz-{prefix}",
        "seed": seed,
        "index": index,
        "features": sorted(features),
        "profile": "gang" if "gang" in features else "default",
        "stepSeconds": 1.0,
        "ticks": ticks,
    }
