"""Snapshot export/import of the whole simulator state.

Rebuild of the reference's snapshot service (reference
simulator/snapshot/snapshot.go): ``snap()`` exports the 7 resource kinds +
the scheduler configuration in the exact ResourcesForSnap JSON shape
(keys ``pods nodes pvs pvcs storageClasses priorityClasses schedulerConfig
namespaces``, snapshot.go:33-40); ``load()`` applies a snapshot with the
reference's ordering — namespaces first, then {priorityClasses,
storageClasses, pvcs, nodes, pods}, PVs last with ClaimRef UID
re-resolution (snapshot.go:154-192, 439-470) — and restarts the scheduler
from the snapshot's config unless IgnoreSchedulerConfiguration.

Filters (snapshot.go:538-560): ``system-``-prefixed PriorityClasses and
``kube-``-prefixed + ``default`` Namespaces are excluded both ways.
"""

from __future__ import annotations

import copy
import logging
from typing import Any

logger = logging.getLogger(__name__)

Obj = dict[str, Any]

SNAP_KIND_KEYS = (
    ("pods", "pods"),
    ("nodes", "nodes"),
    ("pvs", "persistentvolumes"),
    ("pvcs", "persistentvolumeclaims"),
    ("storageClasses", "storageclasses"),
    ("priorityClasses", "priorityclasses"),
    ("namespaces", "namespaces"),
)


def _is_system_priority_class(name: str) -> bool:
    return name.startswith("system-")


def _is_system_namespace(name: str) -> bool:
    return name.startswith("kube-")


def _is_ignore_namespace(name: str) -> bool:
    return _is_system_namespace(name) or name == "default"


class SnapshotService:
    """Snap/Load over a ClusterStore + SchedulerService."""

    def __init__(self, cluster_store: Any, scheduler_service: Any):
        self.cluster_store = cluster_store
        self.scheduler_service = scheduler_service

    # ------------------------------------------------------------------ snap

    def snap(self) -> Obj:
        """Export all resources + scheduler config (ResourcesForSnap)."""
        out: Obj = {}
        for json_key, kind in SNAP_KIND_KEYS:
            objs = self.cluster_store.list(kind)
            if kind == "priorityclasses":
                objs = [o for o in objs if not _is_system_priority_class(o["metadata"]["name"])]
            elif kind == "namespaces":
                objs = [o for o in objs if not _is_ignore_namespace(o["metadata"]["name"])]
            out[json_key] = objs
        try:
            out["schedulerConfig"] = self.scheduler_service.get_scheduler_config()
        except AssertionError:
            out["schedulerConfig"] = None
        return out

    # ------------------------------------------------------------------ load

    def load(
        self,
        resources: Obj,
        ignore_err: bool = False,
        ignore_scheduler_configuration: bool = False,
    ) -> None:
        """Apply a snapshot (ResourcesForLoad) onto the store.

        Apply order mirrors the reference: scheduler config restart →
        namespaces → {PCs, SCs, PVCs, Nodes, Pods} → PVs (ClaimRef UIDs
        re-resolved against the freshly applied PVCs).

        A load during an active streaming session would interleave this
        wholesale reset with an in-flight wave commit — the whole body
        runs under the scheduler's stream quiesce gate (every active
        StreamSession drains to a wave boundary first, counted as a
        ``"snapshot load"`` stream drain, and stays parked until the
        load finishes)."""
        import contextlib

        pauser = getattr(self.scheduler_service, "pause_streams", None)
        gate = pauser("snapshot load") if pauser is not None else contextlib.nullcontext()
        with gate:
            self._load_gated(resources, ignore_err, ignore_scheduler_configuration)

    def _load_gated(
        self,
        resources: Obj,
        ignore_err: bool,
        ignore_scheduler_configuration: bool,
    ) -> None:
        if not ignore_scheduler_configuration:
            cfg = resources.get("schedulerConfig")
            try:
                self.scheduler_service.restart_scheduler(cfg)
            except Exception:
                if not ignore_err:
                    raise
                logger.exception("restart scheduler from snapshot config")

        def apply_list(kind: str, objs: "list[Obj] | None", filter_fn=None) -> None:
            for o in objs or []:
                name = (o.get("metadata") or {}).get("name", "")
                if filter_fn is not None and filter_fn(name):
                    continue
                o = copy.deepcopy(o)
                # server-side apply with nulled UID (snapshot.go:373-536)
                (o.get("metadata") or {}).pop("uid", None)
                try:
                    self.cluster_store.apply(kind, o)
                except Exception:
                    if not ignore_err:
                        raise
                    logger.exception("apply %s %s", kind, name)

        apply_list("namespaces", resources.get("namespaces"), _is_ignore_namespace)
        apply_list("priorityclasses", resources.get("priorityClasses"), _is_system_priority_class)
        apply_list("storageclasses", resources.get("storageClasses"))
        apply_list("persistentvolumeclaims", resources.get("pvcs"))
        apply_list("nodes", resources.get("nodes"))
        apply_list("pods", resources.get("pods"))

        # PVs last: bound claimRef UIDs must point at the NEW pvc UIDs.
        for pv in resources.get("pvs") or []:
            pv = copy.deepcopy(pv)
            (pv.get("metadata") or {}).pop("uid", None)
            claim = (pv.get("spec") or {}).get("claimRef")
            if claim and (pv.get("status") or {}).get("phase") == "Bound":
                try:
                    pvc = self.cluster_store.get(
                        "persistentvolumeclaims", claim.get("name", ""), claim.get("namespace")
                    )
                    claim["uid"] = pvc["metadata"]["uid"]
                    claim["resourceVersion"] = pvc["metadata"]["resourceVersion"]
                except KeyError:
                    # dangling claimRef: null the UID (reference behavior)
                    claim.pop("uid", None)
            try:
                self.cluster_store.apply("persistentvolumes", pv)
            except Exception:
                if not ignore_err:
                    raise
                logger.exception("apply pv %s", (pv.get("metadata") or {}).get("name"))
