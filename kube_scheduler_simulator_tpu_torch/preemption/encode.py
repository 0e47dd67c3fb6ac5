"""Host-side encoding for the batched DefaultPreemption victim search.

Port of the JAX package's ``preemption/encode.py``.  The sequential oracle
(plugins/intree/queue_bind.DefaultPreemption) walks ``ni.pods`` per
candidate node per unschedulable pod; this module lifts the same data into
per-node victim SLOT tables the kernel can scan:

- slots are ALL pods on the node with priority strictly below the round's
  highest pending priority, stably sorted by MoreImportantPod (priority
  desc, start time asc) — exactly ``sorted(lower, key=...)`` in the
  oracle, because a stable sort of a superset restricted to any priority
  threshold equals the stable sort of the subset;
- resource columns are the union of the fit-checked resources any pending
  pod requests, GCD-scaled per column (by the engine) so the device floats
  stay exact;
- PDB matching (namespace + label selector vs victim labels) becomes a
  [N, V, PDB] bool matrix against the per-PDB ``disruptionsAllowed``
  budget.

Every array is numpy on the host, in the reference's dtypes (int64
resources, counts, priorities and start ranks; bool masks).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from kube_scheduler_simulator_tpu_torch.models.podresources import is_fit_resource, pod_resource_request
from kube_scheduler_simulator_tpu_torch.ops.encode import gcd_scale_columns
from kube_scheduler_simulator_tpu_torch.plugins.intree.queue_bind import DefaultPreemption, pod_priority
from kube_scheduler_simulator_tpu_torch.utils.labels import match_label_selector

Obj = dict[str, Any]

# MoreImportantPod's timestamp rule comes from the oracle: one source of
# truth, so the kernel's victim ordering can never drift from it
_start_time = DefaultPreemption._start_time


def fit_resource_axis(pods: list[Obj]) -> list[str]:
    """The union of fit-checked resources any of ``pods`` requests with a
    nonzero want — the only columns the Fit filter (and therefore the
    victim search) ever compares."""
    res: set[str] = set()
    for p in pods:
        for r, v in pod_resource_request(p).items():
            if v > 0 and is_fit_resource(r):
                res.add(r)
    return sorted(res)


def _req_vec(pod: Obj, res_idx: dict[str, int]) -> np.ndarray:
    v = np.zeros(len(res_idx), dtype=np.int64)
    for r, val in pod_resource_request(pod).items():
        j = res_idx.get(r)
        if j is not None:
            v[j] = val
    return v


class PreemptionProblem:
    """Encoded victim-search state for one batch kernel run (numpy, host).

    ``device_tables`` caches the node-axis tables on a device, uploaded
    once per round: the victim search's dispatches upload only the
    per-pod arrays and the round's extra usage."""

    __slots__ = (
        "node_names", "resource_names", "alloc", "base_req", "base_cnt",
        "max_pods", "vreq", "vprio", "vstart", "vvalid", "vmatch",
        "allowed", "victim_pods", "res_idx", "V", "PDB", "_device",
    )

    def __init__(self, node_names, resource_names):
        self.node_names = node_names
        self.resource_names = resource_names
        self._device = None


def encode_preemption(
    node_infos: list[Any],
    resource_names: list[str],
    pdbs: list[Obj],
    nominated: "list[tuple[Obj, str]] | None" = None,
    max_pending_priority: int = 0,
) -> PreemptionProblem:
    """Build the per-node victim tables from the round snapshot's NodeInfos
    (which already account this round's earlier commits the service
    assumed).

    ``nominated``: unbound (pod, node) nominations every victim search must
    respect as non-evictable usage (the oracle adds them to the scratch
    NodeInfo; the caller's gate guarantees every nominee outranks every
    pending pod, so they are unconditionally accounted)."""
    N = len(node_infos)
    R = len(resource_names)
    res_idx = {r: j for j, r in enumerate(resource_names)}
    pr = PreemptionProblem([ni.name for ni in node_infos], resource_names)
    pr.res_idx = res_idx
    pr.alloc = np.zeros((N, R), dtype=np.int64)
    pr.base_req = np.zeros((N, R), dtype=np.int64)
    pr.base_cnt = np.zeros(N, dtype=np.int64)
    pr.max_pods = np.zeros(N, dtype=np.int64)

    # victims: pods below the round's top pending priority, stably in
    # MoreImportantPod order — slot order is the oracle's scan order
    victim_pods: list[list[Obj]] = []
    for j, ni in enumerate(node_infos):
        for r, v in ni.allocatable.items():
            if r in res_idx:
                pr.alloc[j, res_idx[r]] = v
        for r, v in ni.requested.items():
            if r in res_idx:
                pr.base_req[j, res_idx[r]] = v
        pr.base_cnt[j] = len(ni.pods)
        pr.max_pods[j] = ni.allowed_pod_number()
        lows = [p for p in ni.pods if pod_priority(p) < max_pending_priority]
        lows.sort(key=lambda p: (-pod_priority(p), _start_time(p)))
        victim_pods.append(lows)
    node_index = {nn: j for j, nn in enumerate(pr.node_names)}
    for npod, nn in nominated or []:
        j = node_index.get(nn)
        if j is None:
            continue
        pr.base_cnt[j] += 1
        pr.base_req[j] += _req_vec(npod, res_idx)

    V = max((len(v) for v in victim_pods), default=0)
    pr.V = V
    pr.victim_pods = victim_pods
    pr.vreq = np.zeros((N, V, R), dtype=np.int64)
    pr.vprio = np.zeros((N, V), dtype=np.int64)
    pr.vvalid = np.zeros((N, V), dtype=bool)
    # start-time RANK (global order over all slots): pickOneNodeForPreemption
    # compares start-time strings; equal strings must stay equal as ranks
    starts = sorted({_start_time(p) for lows in victim_pods for p in lows})
    start_rank = {s: k for k, s in enumerate(starts)}
    pr.vstart = np.zeros((N, V), dtype=np.int64)
    for j, lows in enumerate(victim_pods):
        for s, p in enumerate(lows):
            pr.vreq[j, s] = _req_vec(p, res_idx)
            pr.vprio[j, s] = pod_priority(p)
            pr.vstart[j, s] = start_rank[_start_time(p)]
            pr.vvalid[j, s] = True

    PDB = len(pdbs)
    pr.PDB = PDB
    pr.vmatch = np.zeros((N, V, PDB), dtype=bool)
    pr.allowed = np.zeros(PDB, dtype=np.int64)
    scopes = []
    for k, pdb in enumerate(pdbs):
        pr.allowed[k] = int(((pdb.get("status") or {}).get("disruptionsAllowed")) or 0)
        scopes.append((pdb["metadata"].get("namespace") or "default", (pdb.get("spec") or {}).get("selector")))
    if PDB:
        # a victim's PDB row depends only on its namespace and labels:
        # match each distinct (namespace, labels) once
        rows: dict = {}
        for j, lows in enumerate(victim_pods):
            for s, p in enumerate(lows):
                ns = p["metadata"].get("namespace") or "default"
                labels = p["metadata"].get("labels") or {}
                key = (ns, tuple(sorted(labels.items())))
                row = rows.get(key)
                if row is None:
                    row = rows[key] = np.array(
                        [pdb_ns == ns and match_label_selector(sel, labels) for pdb_ns, sel in scopes], dtype=bool
                    )
                pr.vmatch[j, s] = row
    return pr


__all__ = [
    "PreemptionProblem",
    "encode_preemption",
    "fit_resource_axis",
    "gcd_scale_columns",
]
