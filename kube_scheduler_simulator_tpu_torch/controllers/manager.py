"""Deployment / ReplicaSet / PersistentVolume controllers.

Reconcile semantics (upstream, simplified to the simulator's needs — the
reference runs the real upstream controllers but only ever exercises the
basic create/scale/bind paths, reference simulator/controller/*.go):

- **deployment**: ensure one ReplicaSet per Deployment carrying the pod
  template and replica count (no rollout/versioned RS history — the
  simulator never updates images).
- **replicaset**: ensure ``spec.replicas`` pods exist matching the
  selector, created from the template with ``<rs-name>-<n>`` names and an
  ownerReference; surplus pods are deleted (highest ordinal first).
- **persistentvolume**: bind Pending PVCs to the smallest compatible
  Available PV (storageClass + accessModes + capacity), setting
  ``claimRef``/``status.phase`` both ways.

All reconciles are idempotent and run until quiescent via
``reconcile_all()``; ``start()`` also wires them to store events so the
manager behaves like the reference's always-on controllers.
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.utils.quantity import value as quantity_value

Obj = dict[str, Any]


def _ns(obj: Obj) -> str:
    return obj["metadata"].get("namespace", "default")


def _owned_by(obj: Obj, owner: Obj) -> bool:
    for ref in obj["metadata"].get("ownerReferences") or []:
        if ref.get("uid") == owner["metadata"]["uid"]:
            return True
    return False


def _owner_ref(owner: Obj, kind: str) -> Obj:
    return {
        "apiVersion": "apps/v1",
        "kind": kind,
        "name": owner["metadata"]["name"],
        "uid": owner["metadata"]["uid"],
        "controller": True,
    }


class ControllerManager:
    def __init__(self, cluster_store: Any):
        self.store = cluster_store
        self._unsubscribe = None
        # Synchronization uses the STORE's reentrant lock (store.lock): the
        # synchronous event bus already holds it when it calls us, so a
        # private lock here would create a store→manager / manager→store
        # lock-order inversion between the scheduler and HTTP threads.
        # The store's event bus is synchronous: our own mutations re-enter
        # reconcile_all via the subscription.  A depth guard turns that
        # recursion into a "dirty → one more pass" loop.
        self._reconciling = False
        self._dirty = False
        # RS uid → number of pods carrying that controller ownerReference;
        # maintained incrementally by _on_event, rebuilt authoritatively by
        # every _reconcile_replicasets sweep (drift self-heals).
        self._owned_counts: dict[str, int] = {}
        # RS uid → spec.replicas: lets the ADDED-pod hot path decide
        # "surplus or not" without deepcopying the replicasets kind.
        self._rs_replicas: dict[str, int] = {}
        # Owner uids whose DELETION this manager observed.  Cascade GC
        # fires only for these: a dangling ownerReference whose owner was
        # NEVER seen (snapshot import applies pods but snapshots don't
        # carry replicasets) must survive, matching the reference where no
        # kube GC controller runs at all (controller/controller.go:77-83).
        self._deleted_owner_uids: set[str] = set()

    # ---------------------------------------------------------------- wiring

    def start(self) -> None:
        """RunController analog: reconcile now and on every relevant event."""
        self.reconcile_all()
        if self._unsubscribe is None:
            self._unsubscribe = self.store.subscribe(
                ["deployments", "replicasets", "pods", "persistentvolumes", "persistentvolumeclaims"],
                self._on_event,
            )

    def _on_event(self, ev: Any) -> None:
        # lock-free: the store's event bus is SYNCHRONOUS and dispatches
        # while the store's reentrant lock is held (state/store.py _emit
        # runs inside the mutating call) — this callback is lock-held by
        # construction, through a subscription the static analysis can't
        # see; taking store.lock here would merely re-enter it
        # Pod churn concerns the replicaset controller when owned pods
        # appear (user-created pod adopted by / surplus to an existing RS)
        # or disappear — but NOT for the scheduler's bind updates
        # (MODIFIED without ownership change), the hot path, which would
        # otherwise pay a full-cluster deepcopy sweep per bind.  ADDED
        # events are filtered through an incrementally-tracked per-RS pod
        # count so a bulk import of N owned pods coalesces to zero sweeps
        # instead of N full-cluster ones (the reference's informer
        # workqueues coalesce such bursts the same way).
        if ev.kind in ("deployments", "replicasets") and ev.type == "DELETED":
            self._deleted_owner_uids.add((ev.obj.get("metadata") or {}).get("uid", ""))
        if ev.kind == "replicasets":
            uid = (ev.obj.get("metadata") or {}).get("uid", "")
            if ev.type == "DELETED":
                self._rs_replicas.pop(uid, None)
            else:
                self._rs_replicas[uid] = int((ev.obj.get("spec") or {}).get("replicas", 1))
        if ev.kind == "pods":
            refs = (ev.obj.get("metadata") or {}).get("ownerReferences") or []
            ctrl = next((r for r in refs if r.get("controller")), None)
            if ev.type == "DELETED":
                if not refs:
                    return
                if ctrl is not None and ctrl.get("kind") == "ReplicaSet":
                    uid = ctrl.get("uid", "")
                    self._owned_counts[uid] = max(0, self._owned_counts.get(uid, 0) - 1)
            elif ev.type == "ADDED":
                if ctrl is None or ctrl.get("kind") != "ReplicaSet":
                    return  # the RS controller only reacts to RS-owned pods
                uid = ctrl.get("uid", "")
                cnt = self._owned_counts[uid] = self._owned_counts.get(uid, 0) + 1
                want = self._rs_replicas.get(uid)
                if want is not None and cnt <= want:
                    return  # owner exists, no surplus: nothing to reconcile
                if want is None and uid not in self._deleted_owner_uids:
                    # Owner never seen by this manager (e.g. snapshot import
                    # applies pods without their replicasets): not an
                    # orphan, nothing to scale — skip the sweep.
                    return
                # surplus (scale-down) or observed-deleted owner (GC): sweep
            else:
                return
        self.reconcile_all()

    def stop(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None

    def reconcile_all(self, max_passes: int = 25) -> None:
        """Run all controllers to quiescence (each pass is idempotent; a
        pass that changes nothing ends the loop)."""
        with self.store.lock:
            if self._reconciling:
                self._dirty = True
                return
            # fast path: nothing for any controller to do (no workload
            # objects, no unbound claims) — avoids full-cluster deepcopies
            # on every pod event
            if (
                self.store.count("deployments") == 0
                and self.store.count("replicasets") == 0
                and not self._has_unbound_pvcs()
            ):
                return
            self._reconciling = True
            try:
                for _ in range(max_passes):
                    self._dirty = False
                    changed = self._reconcile_deployments()
                    changed = self._reconcile_replicasets() or changed
                    changed = self._gc_orphans() or changed
                    changed = self._reconcile_volumes() or changed
                    if not changed and not self._dirty:
                        return
            finally:
                self._reconciling = False

    def _has_unbound_pvcs(self) -> bool:
        if self.store.count("persistentvolumeclaims") == 0:
            return False
        return any(
            (pvc.get("status") or {}).get("phase", "Pending") != "Bound"
            for pvc in self.store.list("persistentvolumeclaims")
        )

    # ------------------------------------------------------------------- gc

    def _gc_orphans(self) -> bool:
        """Cascade deletion (the kube GC role): ReplicaSets whose owning
        Deployment was OBSERVED deleted, and pods whose owning ReplicaSet
        was observed deleted.  A dangling ownerReference to an owner this
        manager never saw (snapshot import carries pods but not their
        replicasets) is left alone — the reference runs no GC controller
        at all, so imported pods must never be collected."""
        changed = False
        dep_uids = {d["metadata"]["uid"] for d in self.store.list("deployments")}
        rs_uids = set()
        for rs in self.store.list("replicasets"):
            owner = next(
                (r for r in rs["metadata"].get("ownerReferences") or [] if r.get("controller")), None
            )
            if (
                owner
                and owner.get("kind") == "Deployment"
                and owner.get("uid") not in dep_uids
                and owner.get("uid") in self._deleted_owner_uids
            ):
                self.store.delete("replicasets", rs["metadata"]["name"], _ns(rs))
                changed = True
            else:
                rs_uids.add(rs["metadata"]["uid"])
        for p in self.store.list("pods"):
            owner = next(
                (r for r in p["metadata"].get("ownerReferences") or [] if r.get("controller")), None
            )
            if (
                owner
                and owner.get("kind") == "ReplicaSet"
                and owner.get("uid") not in rs_uids
                and owner.get("uid") in self._deleted_owner_uids
            ):
                self.store.delete("pods", p["metadata"]["name"], _ns(p))
                changed = True
        return changed

    # ----------------------------------------------------------- deployment

    def _reconcile_deployments(self) -> bool:
        changed = False
        replicasets = self.store.list("replicasets")
        for dep in self.store.list("deployments"):
            spec = dep.get("spec") or {}
            want_replicas = int(spec.get("replicas", 1))
            owned = [rs for rs in replicasets if _ns(rs) == _ns(dep) and _owned_by(rs, dep)]
            if not owned:
                rs = {
                    "metadata": {
                        "name": dep["metadata"]["name"] + "-rs",
                        "namespace": _ns(dep),
                        "labels": dict((spec.get("selector") or {}).get("matchLabels") or {}),
                        "ownerReferences": [_owner_ref(dep, "Deployment")],
                    },
                    "spec": {
                        "replicas": want_replicas,
                        "selector": (spec.get("selector") or {}),
                        "template": (spec.get("template") or {}),
                    },
                }
                try:
                    self.store.create("replicasets", rs)
                except Exception:
                    continue  # name taken by an unowned RS: leave it alone
                changed = True
            else:
                rs = owned[0]
                if int((rs.get("spec") or {}).get("replicas", 1)) != want_replicas:
                    self.store.patch(
                        "replicasets", rs["metadata"]["name"], {"spec": {"replicas": want_replicas}}, _ns(rs)
                    )
                    changed = True
            status = dep.get("status") or {}
            ready = sum(
                int((rs.get("status") or {}).get("replicas") or 0)
                for rs in self.store.list("replicasets")
                if _ns(rs) == _ns(dep) and _owned_by(rs, dep)
            )
            if status.get("replicas") != ready:
                self.store.patch("deployments", dep["metadata"]["name"], {"status": {"replicas": ready}}, _ns(dep))
                changed = True
        return changed

    # ----------------------------------------------------------- replicaset

    def _reconcile_replicasets(self) -> bool:
        changed = False
        pods = self.store.list("pods")
        counts: dict[str, int] = {}
        for p in pods:
            ref = next(
                (r for r in p["metadata"].get("ownerReferences") or [] if r.get("controller")),
                None,
            )
            if ref is not None and ref.get("kind") == "ReplicaSet":
                uid = ref.get("uid", "")
                counts[uid] = counts.get(uid, 0) + 1
        self._owned_counts = counts
        self._rs_replicas = {
            rs["metadata"]["uid"]: int((rs.get("spec") or {}).get("replicas", 1))
            for rs in self.store.list("replicasets")
        }
        for rs in self.store.list("replicasets"):
            want = int((rs.get("spec") or {}).get("replicas", 1))
            owned = sorted(
                (p for p in pods if _ns(p) == _ns(rs) and _owned_by(p, rs)),
                key=lambda p: p["metadata"]["name"],
            )
            if len(owned) < want:
                # Skip any taken pod name (owned or not — a user pod may
                # collide with an ordinal name).
                taken = {p["metadata"]["name"] for p in pods if _ns(p) == _ns(rs)}
                template = (rs.get("spec") or {}).get("template") or {}
                i = 0
                while len(owned) < want and i < want + len(taken) + 1:
                    name = f"{rs['metadata']['name']}-{i}"
                    i += 1
                    if name in taken:
                        continue
                    pod = {
                        "metadata": {
                            "name": name,
                            "namespace": _ns(rs),
                            "labels": dict((template.get("metadata") or {}).get("labels") or {}),
                            "ownerReferences": [_owner_ref(rs, "ReplicaSet")],
                        },
                        "spec": dict(template.get("spec") or {}),
                    }
                    try:
                        self.store.create("pods", pod)
                    except Exception:
                        continue
                    owned.append(pod)
                    changed = True
            elif len(owned) > want:
                for p in owned[want:]:
                    self.store.delete("pods", p["metadata"]["name"], _ns(p))
                    changed = True
            status_replicas = int((rs.get("status") or {}).get("replicas") or 0)
            if status_replicas != min(len(owned), want) or status_replicas != len(owned):
                self.store.patch(
                    "replicasets", rs["metadata"]["name"], {"status": {"replicas": len(owned[:want])}}, _ns(rs)
                )
                changed = True
        return changed

    # -------------------------------------------------------------- volumes

    @staticmethod
    def _pv_matches(pv: Obj, pvc: Obj) -> bool:
        pv_spec = pv.get("spec") or {}
        pvc_spec = pvc.get("spec") or {}
        if pv_spec.get("storageClassName", "") != pvc_spec.get("storageClassName", ""):
            return False
        want_modes = set(pvc_spec.get("accessModes") or [])
        have_modes = set(pv_spec.get("accessModes") or [])
        if not want_modes <= have_modes:
            return False
        want = (pvc_spec.get("resources") or {}).get("requests", {}).get("storage")
        have = (pv_spec.get("capacity") or {}).get("storage")
        if want is not None:
            if have is None or quantity_value(have) < quantity_value(want):
                return False
        return True

    def _reconcile_volumes(self) -> bool:
        changed = False
        pvs = self.store.list("persistentvolumes")
        available = [
            pv for pv in pvs if (pv.get("status") or {}).get("phase", "Available") in ("Available", "")
            and not (pv.get("spec") or {}).get("claimRef")
        ]
        available.sort(
            key=lambda pv: quantity_value(((pv.get("spec") or {}).get("capacity") or {}).get("storage", "0"))
        )
        for pvc in self.store.list("persistentvolumeclaims"):
            phase = (pvc.get("status") or {}).get("phase", "Pending")
            if phase == "Bound":
                continue
            match = next((pv for pv in available if self._pv_matches(pv, pvc)), None)
            if match is None:
                continue
            available.remove(match)
            self.store.patch(
                "persistentvolumes",
                match["metadata"]["name"],
                {
                    "spec": {
                        "claimRef": {
                            "kind": "PersistentVolumeClaim",
                            "namespace": _ns(pvc),
                            "name": pvc["metadata"]["name"],
                            "uid": pvc["metadata"]["uid"],
                        }
                    },
                    "status": {"phase": "Bound"},
                },
            )
            self.store.patch(
                "persistentvolumeclaims",
                pvc["metadata"]["name"],
                {"spec": {"volumeName": match["metadata"]["name"]}, "status": {"phase": "Bound"}},
                _ns(pvc),
            )
            changed = True
        return changed
