"""Volume plugins: failure reasons, cloud-limit families and the shared
volume resolution helpers the encoder reads (upstream v1.26 semantics over
the simulator's resource model: PVs, PVCs, StorageClasses, CSINodes)."""

from __future__ import annotations

from typing import Any

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


# (volume source key, unique-id field) for the single-attach cloud disks
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


class _VolumeLimits:
    """A NodeVolumeLimits-family plugin: its name, the volume source it
    counts and its default per-node cap."""

    name = "NodeVolumeLimits"
    volume_key = ""
    default_limit = 256


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
    """CSI volume limits, capped per driver (default 256)."""

    name = "NodeVolumeLimits"
    volume_key = "csi"
    default_limit = 256


# Column order of the encoder's per-family cloud count arrays.
CLOUD_LIMIT_PLUGINS = (EBSLimits, GCEPDLimits, AzureDiskLimits)


def resolve_csi_driver(volume: Obj, ns: str, get) -> "str | None":
    """CSI driver a volume attaches through — the upstream resolution
    chain (inline ``csi:`` names it; PVC-backed resolves bound PV csi
    driver, then StorageClass provisioner).  ``get(kind, name,
    namespace=None) → obj | None`` abstracts the object source."""
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
    attachment); inline csi: volumes are unique per pod+volume.
    ``driver_of(volume, ns)`` resolves the driver; ``drv_memo`` caches
    PVC-backed resolutions."""
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
