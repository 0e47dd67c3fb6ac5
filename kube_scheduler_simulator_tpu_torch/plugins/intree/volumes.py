"""Volume-related filter plugins (upstream v1.26 semantics over the
simulator's resource model: PVs, PVCs, StorageClasses).

- VolumeBinding: pending PVCs must exist; immediate-binding PVCs must be
  bound; node-affinity of bound PVs must match the node.
- VolumeZone: zone/region labels of a bound PV must match the node's.
- VolumeRestrictions: GCE-PD/EBS/AzureDisk single-attach conflicts and
  ReadWriteOncePod enforcement.
- NodeVolumeLimits family (EBSLimits/GCEPDLimits/AzureDiskLimits/
  NodeVolumeLimits=CSI): attachable-volume count limits.
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import CycleState, Status
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo

Obj = dict[str, Any]

ERR_PVC_NOT_FOUND = 'persistentvolumeclaim "%s" not found'
ERR_VOLUME_NODE_CONFLICT = "node(s) had volume node affinity conflict"
ERR_VOLUME_ZONE = "node(s) had no available volume zone"
ERR_DISK_CONFLICT = "node(s) had no available disk"
ERR_MAX_VOLUME_COUNT = "node(s) exceed max volume count"
ERR_UNBOUND_IMMEDIATE_PVC = "pod has unbound immediate PersistentVolumeClaims"

ZONE_LABELS = ("topology.kubernetes.io/zone", "failure-domain.beta.kubernetes.io/zone")
REGION_LABELS = ("topology.kubernetes.io/region", "failure-domain.beta.kubernetes.io/region")


def _pod_pvc_names(pod: Obj) -> list[str]:
    out = []
    for v in (pod.get("spec") or {}).get("volumes") or []:
        pvc = v.get("persistentVolumeClaim")
        if pvc and pvc.get("claimName"):
            out.append(pvc["claimName"])
    return out


class _VolumeHandleMixin:
    def __init__(self, args: "Obj | None" = None, handle: Any = None):
        self.handle = handle

    def _store(self):
        return getattr(self.handle, "cluster_store", None) if self.handle else None

    def _get(self, kind: str, name: str, namespace: "str | None" = None) -> "Obj | None":
        store = self._store()
        if store is None:
            return None
        try:
            return store.get(kind, name, namespace)
        except KeyError:
            return None


class VolumeBinding(_VolumeHandleMixin):
    name = "VolumeBinding"

    def pre_filter(self, state: CycleState, pod: Obj):
        ns = pod["metadata"].get("namespace", "default")
        missing = []
        for claim in _pod_pvc_names(pod):
            if self._store() is not None and self._get("persistentvolumeclaims", claim, ns) is None:
                missing.append(claim)
        if missing:
            return None, Status.unresolvable(ERR_PVC_NOT_FOUND % missing[0])
        return None, None

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        ns = pod["metadata"].get("namespace", "default")
        node = node_info.node
        labels = node["metadata"].get("labels") or {}
        for claim in _pod_pvc_names(pod):
            pvc = self._get("persistentvolumeclaims", claim, ns)
            if pvc is None:
                continue  # pre_filter already rejected the pod
            vol_name = (pvc.get("spec") or {}).get("volumeName")
            if not vol_name:
                # Unbound: WaitForFirstConsumer can bind later; immediate
                # binding mode means the pod must wait.
                sc_name = (pvc.get("spec") or {}).get("storageClassName")
                sc = self._get("storageclasses", sc_name) if sc_name else None
                mode = (sc or {}).get("volumeBindingMode", "Immediate")
                if mode != "WaitForFirstConsumer":
                    return Status.unresolvable(ERR_UNBOUND_IMMEDIATE_PVC)
                continue
            pv = self._get("persistentvolumes", vol_name)
            if pv is None:
                continue
            node_affinity = ((pv.get("spec") or {}).get("nodeAffinity") or {}).get("required")
            if node_affinity is not None:
                from kube_scheduler_simulator_tpu_torch.utils.labels import match_node_selector

                if not match_node_selector(node_affinity, labels, node_info.name):
                    return Status.unresolvable(ERR_VOLUME_NODE_CONFLICT)
        return None

    def reserve(self, state: CycleState, pod: Obj, node_name: str) -> "Status | None":
        return None

    def unreserve(self, state: CycleState, pod: Obj, node_name: str) -> None:
        return None

    def pre_bind(self, state: CycleState, pod: Obj, node_name: str) -> "Status | None":
        return None


class VolumeZone(_VolumeHandleMixin):
    name = "VolumeZone"

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        ns = pod["metadata"].get("namespace", "default")
        node_labels = node_info.node["metadata"].get("labels") or {}
        for claim in _pod_pvc_names(pod):
            pvc = self._get("persistentvolumeclaims", claim, ns)
            if pvc is None:
                continue
            vol_name = (pvc.get("spec") or {}).get("volumeName")
            if not vol_name:
                continue
            pv = self._get("persistentvolumes", vol_name)
            if pv is None:
                continue
            pv_labels = pv["metadata"].get("labels") or {}
            for label_set in (ZONE_LABELS, REGION_LABELS):
                for label in label_set:
                    if label in pv_labels and label in node_labels:
                        pv_vals = set(pv_labels[label].split("__"))
                        if node_labels[label] not in pv_vals:
                            return Status.unresolvable(ERR_VOLUME_ZONE)
        return None


def _gce_pd(v: Obj) -> "str | None":
    pd = v.get("gcePersistentDisk")
    return pd.get("pdName") if pd else None


def _ebs(v: Obj) -> "str | None":
    ebs = v.get("awsElasticBlockStore")
    return ebs.get("volumeID") if ebs else None


def _azure(v: Obj) -> "str | None":
    d = v.get("azureDisk")
    return d.get("diskName") if d else None


# (volume source key, unique-id field) for the single-attach cloud disks —
# shared by VolumeRestrictions and the batch encoder's conflict classes
CLOUD_ID_FIELDS = (
    ("gcePersistentDisk", "pdName"),
    ("awsElasticBlockStore", "volumeID"),
    ("azureDisk", "diskName"),
)


def pod_cloud_triples(pod: Obj) -> "list[tuple[str, str, bool]]":
    """The (kind, id, readOnly) cloud-disk mounts of a pod."""
    out = []
    for v in (pod.get("spec") or {}).get("volumes") or []:
        for key, id_field in CLOUD_ID_FIELDS:
            src = v.get(key)
            vid = src.get(id_field) if src else None
            if vid:
                out.append((key, vid, bool(src.get("readOnly", False))))
    return out


def volumes_conflict(a: "tuple[str, str, bool]", b: "tuple[str, str, bool]") -> bool:
    """Two mounts of the same cloud disk conflict unless both are
    read-only (upstream volumerestrictions single-attach semantics)."""
    return a[0] == b[0] and a[1] == b[1] and not (a[2] and b[2])


class VolumeRestrictions(_VolumeHandleMixin):
    name = "VolumeRestrictions"

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        want = pod_cloud_triples(pod)
        if not want:
            return None
        for existing in node_info.pods:
            for et in pod_cloud_triples(existing):
                for t in want:
                    if volumes_conflict(t, et):
                        return Status.unschedulable(ERR_DISK_CONFLICT)
        return None


class _VolumeLimits(_VolumeHandleMixin):
    """Shared logic for the four NodeVolumeLimits-family plugins."""

    name = "NodeVolumeLimits"
    volume_key = ""  # e.g. "awsElasticBlockStore"
    default_limit = 256

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        if not self.volume_key:
            return None

        def count(p: Obj) -> int:
            return sum(1 for v in (p.get("spec") or {}).get("volumes") or [] if v.get(self.volume_key))

        want = count(pod)
        if want == 0:
            return None
        used = sum(count(p) for p in node_info.pods)
        if used + want > self.default_limit:
            return Status.unschedulable(ERR_MAX_VOLUME_COUNT)
        return None


class EBSLimits(_VolumeLimits):
    name = "EBSLimits"
    volume_key = "awsElasticBlockStore"
    default_limit = 39


class GCEPDLimits(_VolumeLimits):
    name = "GCEPDLimits"
    volume_key = "gcePersistentDisk"
    default_limit = 16


class AzureDiskLimits(_VolumeLimits):
    name = "AzureDiskLimits"
    volume_key = "azureDisk"
    default_limit = 16


class NodeVolumeLimits(_VolumeLimits):
    """CSI volume limits: counts each pod's CSI-attached volumes PER
    DRIVER — inline ``csi:`` volumes by their driver name, and PVC-backed
    volumes resolved PVC → StorageClass → provisioner (upstream
    nodevolumelimits/csi.go) — and caps each driver at the node's CSINode
    ``allocatable.count`` (falling back to the generic 256 when the node
    publishes no CSINode entry for the driver)."""

    name = "NodeVolumeLimits"
    volume_key = "csi"
    default_limit = 256

    def _driver_of(self, volume: Obj, namespace: str) -> "str | None":
        """CSI driver name a volume attaches through, or None."""
        return resolve_csi_driver(volume, namespace, self._get)

    def _csinode_limits(self, node_name: str) -> dict[str, int]:
        """driver → allocatable attach count from the node's CSINode."""
        store = getattr(self.handle, "cluster_store", None) if self.handle else None
        if store is None:
            return {}
        try:
            csinode = store.get("csinodes", node_name)
        except Exception:
            return {}
        out: dict[str, int] = {}
        for d in ((csinode.get("spec") or {}).get("drivers")) or []:
            cnt = ((d.get("allocatable") or {}).get("count"))
            if d.get("name") and cnt is not None:
                out[d["name"]] = int(cnt)
        return out

    _CACHE_KEY = "NodeVolumeLimits/cycle-cache"

    def _pod_volume_ids(self, pod: Obj, drv_memo: "dict | None" = None) -> "set[tuple[str, str]]":
        return pod_csi_volume_ids(pod, self._driver_of, drv_memo)

    def filter(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "Status | None":
        # cycle-scoped memo: the incoming pod's volume set, every existing
        # pod's set (keyed ns/name — the cycle's snapshot is stable), and
        # PVC→driver / CSINode resolutions — upstream computes these once
        # per cycle too; without it, every candidate node re-walks the
        # PVC→StorageClass chains through deep-copying store lookups
        cache = state.read(self._CACHE_KEY)
        if cache is None:
            cache = {"drv": {}, "pods": {}, "limits": {}}
            cache["want"] = self._pod_volume_ids(pod, cache["drv"])
            state.write(self._CACHE_KEY, cache)
        want = cache["want"]
        if not want:
            return None
        limits = cache["limits"].get(node_info.name)
        if limits is None:
            limits = self._csinode_limits(node_info.name)
            cache["limits"][node_info.name] = limits
        attached: set[tuple[str, str]] = set()
        for p in node_info.pods:
            pk = f"{p['metadata'].get('namespace', 'default')}/{p['metadata']['name']}"
            ids = cache["pods"].get(pk)
            if ids is None:
                ids = self._pod_volume_ids(p, cache["drv"])
                cache["pods"][pk] = ids
            attached |= ids
        new = want - attached
        for driver in {d for d, _ in new}:
            used = sum(1 for d, _ in attached if d == driver)
            needed = sum(1 for d, _ in new if d == driver)
            if used + needed > limits.get(driver, self.default_limit):
                return Status.unschedulable(ERR_MAX_VOLUME_COUNT)
        return None


# Column order of the batch kernel's per-family cloud count arrays
# (ops/encode cloud_cnt / ops/batch CLOUD_LIMIT_COL) — limits and volume
# keys come from the plugin classes so a fix there propagates everywhere.
CLOUD_LIMIT_PLUGINS = (EBSLimits, GCEPDLimits, AzureDiskLimits)


def resolve_csi_driver(volume: Obj, ns: str, get) -> "str | None":
    """CSI driver a volume attaches through — the upstream resolution
    chain (inline ``csi:`` names it; PVC-backed resolves bound PV csi
    driver, then StorageClass provisioner).  ``get(kind, name,
    namespace=None) → obj | None`` abstracts the object source: the
    cluster store here, plain dict indexes in the batch encoder — one
    parity-critical implementation for both paths."""
    csi = volume.get("csi")
    if csi:
        return csi.get("driver") or ""
    ref = volume.get("persistentVolumeClaim")
    if not ref:
        return None
    pvc = get("persistentvolumeclaims", ref.get("claimName", ""), ns)
    if pvc is None:
        return None
    vol_name = (pvc.get("spec") or {}).get("volumeName")
    if vol_name:
        pv = get("persistentvolumes", vol_name)
        d = (((pv or {}).get("spec") or {}).get("csi") or {}).get("driver")
        if d:
            return d
    sc_name = (pvc.get("spec") or {}).get("storageClassName")
    if not sc_name:
        return None
    sc = get("storageclasses", sc_name)
    return sc.get("provisioner") if sc is not None else None


def pod_csi_volume_ids(pod: Obj, driver_of, drv_memo: "dict | None" = None) -> "set[tuple[str, str]]":
    """(driver, unique volume id) pairs a pod attaches.  PVC-backed
    volumes are identified by the claim (pods sharing a PVC share ONE
    attachment — upstream counts unique volume handles); inline csi:
    volumes are unique per pod+volume.  ``driver_of(volume, ns)`` resolves
    the driver; ``drv_memo`` caches PVC-backed resolutions (3 object
    lookups each otherwise)."""
    ns = pod["metadata"].get("namespace", "default")
    out: set[tuple[str, str]] = set()
    for v in (pod.get("spec") or {}).get("volumes") or []:
        pvc_ref = v.get("persistentVolumeClaim")
        if pvc_ref is not None and drv_memo is not None:
            mk = (ns, pvc_ref.get("claimName", ""))
            if mk in drv_memo:
                driver = drv_memo[mk]
            else:
                driver = driver_of(v, ns)
                drv_memo[mk] = driver
        else:
            driver = driver_of(v, ns)
        if driver is None:
            continue
        if pvc_ref:
            vid = f"pvc:{ns}/{pvc_ref.get('claimName', '')}"
        else:
            vid = f"inline:{ns}/{pod['metadata']['name']}/{v.get('name', '')}"
        out.add((driver, vid))
    return out
