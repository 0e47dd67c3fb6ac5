"""ClusterAutoscaler: the deterministic scale-up / scale-down passes.

Port of the JAX package's ``autoscaler/engine.py``, copied whole; the
estimator it builds runs on the scheduler service's device and dtype.

Simulates the upstream cluster-autoscaler's main loop against the
in-memory control plane:

- **Scale-up**: driven by the scheduling queue's unschedulable set (the
  pods left pending after a drain).  All candidate groups are estimated
  in ONE lane-kernel launch (autoscaler/estimator.py), an expander
  (autoscaler/expander.py) picks the group, and the new Node objects
  land through ``ClusterStore.bulk_update(allow_create=True)`` — one
  store transaction whose per-node ADDED events drive the scheduling
  queue's moveRequestCycle exactly like N individual node creates, so
  the unschedulable pods re-activate without bespoke plumbing.

- **Scale-down**: a group-owned node whose utilization (max of cpu and
  memory requested/allocatable — the upstream utilization measure) stays
  under ``scale_down_utilization_threshold`` for
  ``scale_down_unneeded_rounds`` consecutive passes is drained: its pods
  must all be evictable under the PodDisruptionBudget rules preemption
  already enforces (shared per-pass budget, plugins/intree/queue_bind
  semantics), they must RELOCATE — first-fit into the remaining nodes'
  free cpu/memory/pod capacity, accumulated across the pass so two
  drains can't promise the same slack (the upstream drainability
  simulation, resource-level) — the group must stay at or above
  minSize, and a pass that scaled up never scales down (upstream's
  post-scale-up cooldown).  Drained pods are unbound (back to Pending)
  and the node deleted, both through bulk waves.

Determinism: every decision is a pure function of (cluster state, group
specs, config) — synthetic names use the lowest free indices, expander
ties break on names, pass counters live in this object and reset with
it.  Replaying a scenario from an empty cluster therefore reproduces the
action sequence byte-for-byte (pinned by tests/test_autoscaler.py).
"""

from __future__ import annotations

import logging
import threading
from typing import Any

logger = logging.getLogger("autoscaler")

from kube_scheduler_simulator_tpu_torch.autoscaler import nodegroups as ng
from kube_scheduler_simulator_tpu_torch.autoscaler.estimator import ScaleUpEstimator
from kube_scheduler_simulator_tpu_torch.autoscaler.expander import EXPANDERS, pick
from kube_scheduler_simulator_tpu_torch.state.store import BULK_DELETE
from kube_scheduler_simulator_tpu_torch.utils.pdb import violates_pdb
from kube_scheduler_simulator_tpu_torch.utils.quantity import parse_quantity

Obj = dict[str, Any]


class ClusterAutoscaler:
    def __init__(
        self,
        cluster_store: Any,
        scheduler_service: Any,
        expander: str = "least-waste",
        scale_down_utilization_threshold: float = 0.5,
        scale_down_unneeded_rounds: int = 3,
        max_nodes_per_scale_up: int = 64,
        max_events: int = 256,
    ):
        if expander not in EXPANDERS:
            raise ValueError(f"unknown expander {expander!r} (want one of {EXPANDERS})")
        self.store = cluster_store
        self.scheduler = scheduler_service
        self.expander = expander
        self.scale_down_utilization_threshold = float(scale_down_utilization_threshold)
        self.scale_down_unneeded_rounds = max(int(scale_down_unneeded_rounds), 1)
        self.max_nodes_per_scale_up = max(int(max_nodes_per_scale_up), 1)
        self.max_events = max_events
        # consecutive under-threshold passes per node (the unneeded timer)
        self._unneeded: dict[str, int] = {}
        self._invalid_logged: set[str] = set()  # warn once per bad group
        self._estimator: "ScaleUpEstimator | None" = None
        self._estimator_fw: Any = None
        # action feed: the scenario engine drains it into the timeline;
        # the API serves the retained tail
        self.events: list[Obj] = []
        self._pending_events: list[Obj] = []
        self.stats = {
            "passes": 0,
            "scale_ups": 0,
            "scale_downs": 0,
            "nodes_added": 0,
            "nodes_removed": 0,
        }
        self._lock = threading.Lock()

    # --------------------------------------------------------------- state

    def node_groups(self) -> list[Obj]:
        return self.store.list("nodegroups", copy_objects=False)

    def group_status(self) -> list[Obj]:
        """Per-group view for the API/webui: spec bounds + live size."""
        out = []
        for g in self.node_groups():
            name = g["metadata"]["name"]
            mn, mx = ng.group_bounds(g)
            nodes = sorted(n["metadata"]["name"] for n in ng.group_nodes(self.store, name))
            out.append(
                {
                    "name": name,
                    "minSize": mn,
                    "maxSize": mx,
                    "priority": int((g.get("spec") or {}).get("priority") or 0),
                    "currentSize": len(nodes),
                    "nodes": nodes,
                }
            )
        return out

    def status(self) -> Obj:
        est = self._estimator
        with self._lock:
            stats = dict(self.stats)
            events = list(self.events[-50:])
        return {
            "expander": self.expander,
            "scaleDownUtilizationThreshold": self.scale_down_utilization_threshold,
            "scaleDownUnneededRounds": self.scale_down_unneeded_rounds,
            "stats": stats,
            "estimator": {
                "dispatches": est.dispatches if est else 0,
                "compiles": est.compiles if est else 0,
                "lastEstimateSeconds": round(est.last_estimate_s, 6) if est else 0.0,
                "cumEstimateSeconds": round(est.cum_estimate_s, 6) if est else 0.0,
            },
            "groups": self.group_status(),
            "events": events,
        }

    def metrics(self) -> Obj:
        """Flat counters for the Prometheus endpoint."""
        est = self._estimator
        with self._lock:
            stats = dict(self.stats)
        return {
            **stats,
            "estimate_dispatches": est.dispatches if est else 0,
            "estimate_compiles": est.compiles if est else 0,
            "estimate_kernel_errors": est.kernel_errors if est else 0,
            "estimate_last_s": est.last_estimate_s if est else 0.0,
            "estimate_cum_s": est.cum_estimate_s if est else 0.0,
            "estimate_sharded_dispatches": est.sharded_dispatches if est else 0,
            "estimate_shard_plane_bytes_per_device": (
                est.shard_plane_bytes_per_device if est else 0
            ),
            "groups": {
                gs["name"]: {"current": gs["currentSize"], "min": gs["minSize"], "max": gs["maxSize"]}
                for gs in self.group_status()
            },
        }

    def durability_state(self) -> Obj:
        """The crash-restorable process state (state/recovery.py): the
        per-node unneeded streaks.  Losing them to a crash delays
        scale-downs by up to ``scale_down_unneeded_rounds`` passes,
        which shifts node-drain events — and with them the re-activation
        cadence of parked pods — off the uninterrupted timeline (a real
        byte divergence the crash harness caught)."""
        return {"unneeded": dict(self._unneeded)}

    def restore_durability_state(self, state: "Obj | None") -> None:
        if state:
            self._unneeded = {
                str(k): int(v) for k, v in (state.get("unneeded") or {}).items()
            }

    def drain_events(self) -> list[Obj]:
        """Actions recorded since the last drain (scenario timeline feed)."""
        with self._lock:
            out = self._pending_events
            self._pending_events = []
        return out

    def _record(self, event: Obj) -> None:
        with self._lock:
            self.events.append(event)
            del self.events[: -self.max_events]
            self._pending_events.append(event)

    # ------------------------------------------------------------ main loop

    def run_once(self) -> Obj:
        """One autoscaler pass: scale-up (if pods are pending), then
        scale-down (if the pass didn't scale up).  Returns a summary with
        ``actions`` = number of cluster mutations taken."""
        with self._lock:
            self.stats["passes"] += 1
        summary: Obj = {"actions": 0, "scaled_up": None, "scaled_down": []}
        pending = self.scheduler.pending_pods()
        if pending:
            up = self.scale_up(pending)
            if up is not None:
                summary["scaled_up"] = up
                summary["actions"] += len(up["nodes"])
        if summary["scaled_up"] is None:
            down = self.scale_down()
            summary["scaled_down"] = down
            summary["actions"] += len(down)
        return summary

    # ------------------------------------------------------------- scale up

    def _estimator_for(self, fw: Any) -> ScaleUpEstimator:
        if self._estimator is None or self._estimator_fw is not fw:
            # the estimator runs where the scheduler's batch engines run
            self._estimator = ScaleUpEstimator.from_framework(
                fw,
                store=self.store,
                mesh=getattr(self.scheduler, "mesh", None),
                device=getattr(self.scheduler, "device", None),
                dtype=getattr(self.scheduler, "dtype", None),
            )
            self._estimator_fw = fw
        return self._estimator

    def scale_up(self, pending: list[Obj]) -> "Obj | None":
        """Estimate all groups in one dispatch, expand the winner, and
        materialize its nodes.  Returns the action record or None."""
        groups = []
        for g in sorted(self.node_groups(), key=lambda x: x["metadata"]["name"]):
            # groups can arrive UNVALIDATED (generic resources route,
            # scenario creates): a malformed one must cost itself, not
            # crash every autoscaler pass
            try:
                ng.validate_node_group(g)
            except ValueError:
                name = g["metadata"].get("name", "?")
                if name not in self._invalid_logged:
                    self._invalid_logged.add(name)
                    logger.warning("skipping invalid nodegroup %s", name, exc_info=True)
                continue
            groups.append(g)
        if not groups:
            return None
        headroom: dict[str, int] = {}
        for g in groups:
            name = g["metadata"]["name"]
            _mn, mx = ng.group_bounds(g)
            headroom[name] = min(
                max(mx - len(ng.group_nodes(self.store, name)), 0),
                self.max_nodes_per_scale_up,
            )
        if not any(headroom.values()):
            return None
        fw = getattr(self.scheduler, "framework", None)
        if fw is None:
            return None
        est = self._estimator_for(fw)
        from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import VOLUME_KINDS

        volumes = {k: self.store.list(k, copy_objects=False) for k in VOLUME_KINDS}
        estimates = est.estimate(
            groups,
            headroom,
            pending,
            self.store.list("namespaces", copy_objects=False),
            volumes=volumes,
        )
        winner = pick(self.expander, estimates)
        if winner is None:
            return None
        n_new = min(winner.nodes_needed, headroom.get(winner.group, 0))
        if n_new <= 0:
            return None
        group = next(g for g in groups if g["metadata"]["name"] == winner.group)
        indices = ng.free_indices(self.store, winner.group, n_new)
        nodes = [ng.synthetic_node(group, i) for i in indices]
        names = [n["metadata"]["name"] for n in nodes]
        by_name = {n["metadata"]["name"]: n for n in nodes}
        # one store transaction; per-node ADDED events dispatch after the
        # wave and bump the queue's moveRequestCycle one-by-one
        added = self.store.bulk_update(
            "nodes",
            [(nm, None, lambda cur, nm=nm: by_name[nm] if cur is None else None) for nm in names],
            allow_create=True,
        )
        with self._lock:
            self.stats["scale_ups"] += 1
            self.stats["nodes_added"] += added
        action = {
            "action": "ScaleUp",
            "nodeGroup": winner.group,
            "nodes": names,
            "pendingPods": len(pending),
            "podsFit": winner.pods_fit,
            "expander": self.expander,
            "method": winner.method,
            "estimates": [
                {
                    "group": e.group,
                    "nodesNeeded": e.nodes_needed,
                    "podsFit": e.pods_fit,
                    "waste": e.waste,
                }
                for e in estimates
            ],
        }
        self._record(action)
        return action

    # ----------------------------------------------------------- scale down

    def _capacity_view(self) -> "tuple[dict[str, float], dict[str, list[float]], dict[str, list[Obj]]]":
        """ONE pass over pods + nodes serving the whole scale-down pass:
        per-node utilization (max of cpu/memory requested/allocatable),
        free capacity ([cpu, mem, pod slots] — the relocation budget),
        and the bound pods per node."""
        pods_by_node: dict[str, list[Obj]] = {}
        req_by_node: dict[str, list[float]] = {}
        for p in self.store.list("pods", copy_objects=False):
            nn = (p.get("spec") or {}).get("nodeName")
            if not nn:
                continue
            pods_by_node.setdefault(nn, []).append(p)
            cpu, mem = self._pod_request(p)
            r = req_by_node.setdefault(nn, [0.0, 0.0])
            r[0] += cpu
            r[1] += mem
        util: dict[str, float] = {}
        free: dict[str, list[float]] = {}
        for n in self.store.list("nodes", copy_objects=False):
            name = n["metadata"]["name"]
            alloc = (n.get("status") or {}).get("allocatable") or {}
            cap_cpu = float(parse_quantity(alloc.get("cpu", 0)))
            cap_mem = float(parse_quantity(alloc.get("memory", 0)))
            cap_pods = float(parse_quantity(alloc.get("pods", 110)))
            used = req_by_node.get(name, (0.0, 0.0))
            fr = []
            if cap_cpu:
                fr.append(used[0] / cap_cpu)
            if cap_mem:
                fr.append(used[1] / cap_mem)
            util[name] = max(fr) if fr else 0.0
            free[name] = [
                cap_cpu - used[0],
                cap_mem - used[1],
                cap_pods - len(pods_by_node.get(name, ())),
            ]
        return util, free, pods_by_node

    def _violates_pdb(self, victim: Obj, pdbs: list[Obj], budget: dict[int, int]) -> bool:
        """The preemption dry-run's PDB rule — the ONE shared
        implementation (utils/pdb.py): evicting ``victim`` consumes one
        disruption from every matching budget; going negative vetoes."""
        return violates_pdb(victim, pdbs, budget)

    def scale_down(self) -> list[Obj]:
        """Advance the unneeded timers and drain the nodes that are ripe.
        Returns the action records (one per drained node)."""
        # one pods+nodes pass serves utilization, the relocation budget,
        # and the per-node victim lists for the whole pass
        util, free, pods_by_node = self._capacity_view()
        bounds: dict[str, int] = {}  # group -> minSize (valid groups only)
        for g in self.node_groups():
            try:
                mn, _mx = ng.group_bounds(g)
            except (TypeError, ValueError):
                continue  # malformed group: its nodes are left alone
            bounds[g["metadata"]["name"]] = mn
        owned: dict[str, str] = {}  # node name -> group
        for n in self.store.list("nodes", copy_objects=False):
            g = (n["metadata"].get("labels") or {}).get(ng.NODE_GROUP_LABEL)
            if g in bounds:
                owned[n["metadata"]["name"]] = g
        # timers: advance under-threshold owned nodes, reset the rest
        for name in list(self._unneeded):
            if name not in owned:
                del self._unneeded[name]
        for name in sorted(owned):
            if util.get(name, 0.0) < self.scale_down_utilization_threshold:
                self._unneeded[name] = self._unneeded.get(name, 0) + 1
            else:
                self._unneeded.pop(name, None)

        pdbs = self.store.list("poddisruptionbudgets", copy_objects=False)
        budget: dict[int, int] = {}  # shared across the pass, like preemption
        current: dict[str, int] = {}
        for grp in owned.values():
            current[grp] = current.get(grp, 0) + 1
        removable_left = {
            grp: max(current.get(grp, 0) - mn, 0) for grp, mn in bounds.items()
        }

        actions: list[Obj] = []
        received: set[str] = set()  # nodes promised to earlier drains' victims
        for name in sorted(owned):
            if self._unneeded.get(name, 0) < self.scale_down_unneeded_rounds:
                continue
            if name in received:
                continue  # it holds slack an earlier drain relies on
            group = owned[name]
            if removable_left.get(group, 0) <= 0:
                continue  # minSize floor
            victims = sorted(
                pods_by_node.get(name, ()),
                key=lambda p: (p["metadata"].get("namespace", "default"), p["metadata"]["name"]),
            )
            trial = dict(budget)
            if any(self._violates_pdb(v, pdbs, trial) for v in victims):
                continue  # a PDB vetoes this node's drain
            if not self._relocate(victims, name, free, received):
                continue  # pods have nowhere to go — keep the node
            budget = trial
            removable_left[group] -= 1
            free.pop(name, None)  # a drained node can't host relocations
            drained = self._drain_node(name, victims)
            self._unneeded.pop(name, None)
            with self._lock:
                self.stats["scale_downs"] += 1
                self.stats["nodes_removed"] += 1
            action = {
                "action": "ScaleDown",
                "nodeGroup": group,
                "nodes": [name],
                "drainedPods": drained,
                "utilization": round(util.get(name, 0.0), 6),
            }
            self._record(action)
            actions.append(action)
        return actions

    @staticmethod
    def _pod_request(pod: Obj) -> "tuple[float, float]":
        cpu = mem = 0.0
        for c in (pod.get("spec") or {}).get("containers") or []:
            reqs = ((c.get("resources") or {}).get("requests")) or {}
            cpu += float(parse_quantity(reqs.get("cpu", 0)))
            mem += float(parse_quantity(reqs.get("memory", 0)))
        return cpu, mem

    def _relocate(
        self,
        victims: list[Obj],
        draining: str,
        free: dict[str, list[float]],
        received: set[str],
    ) -> bool:
        """Would every victim first-fit into the other nodes' remaining
        capacity?  Commits the deductions into ``free`` on success (the
        pass-wide budget) and records the receiving nodes in
        ``received`` — a node that absorbed a relocation must NOT be
        drained later in the same pass, or the slack it promised an
        earlier drain's victims would be deleted out from under them.
        Leaves both untouched on failure."""
        trial = {k: list(v) for k, v in free.items() if k != draining}
        took: set[str] = set()
        for v in victims:
            cpu, mem = self._pod_request(v)
            placed = False
            for name in sorted(trial):
                cap = trial[name]
                if cap[0] >= cpu and cap[1] >= mem and cap[2] >= 1.0:
                    cap[0] -= cpu
                    cap[1] -= mem
                    cap[2] -= 1.0
                    took.add(name)
                    placed = True
                    break
            if not placed:
                return False
        for k, v in trial.items():
            free[k] = v
        received |= took
        return True

    def _drain_node(self, node_name: str, victims: list[Obj]) -> list[str]:
        """Unbind the node's pods (one bulk wave), then delete the node
        (a second wave) — pod MODIFIED and node DELETED events all drive
        the queue's move machinery, so the evicted pods re-schedule."""

        def unbind(cur: "Obj | None") -> "Obj | None":
            if cur is None or (cur.get("spec") or {}).get("nodeName") != node_name:
                return None  # re-bound or deleted since the plan
            spec = {k: v for k, v in (cur.get("spec") or {}).items() if k != "nodeName"}
            status = {
                k: v for k, v in (cur.get("status") or {}).items() if k != "nominatedNodeName"
            }
            status["phase"] = "Pending"
            return {**cur, "metadata": dict(cur["metadata"]), "spec": spec, "status": status}

        drained = [
            f"{p['metadata'].get('namespace', 'default')}/{p['metadata']['name']}"
            for p in victims
        ]
        self.store.bulk_update(
            "pods",
            [
                (p["metadata"]["name"], p["metadata"].get("namespace", "default"), unbind)
                for p in victims
            ],
        )
        self.store.bulk_update(
            "nodes", [(node_name, None, lambda cur: BULK_DELETE)], allow_delete=True
        )
        return drained
