"""Host-side encoding for the gang kernels (gang/kernel.py).

Two problem shapes:

- the **window verdict**: group-membership vectors over one replay
  window's kernel selections (plus members parked in earlier rounds),
  and per-group topology-label planes ``dom[G, N]`` — the domain id of
  node n under group g's ``topologyPackKey``.  One dispatch per replay
  window answers all-or-nothing feasibility and distinct-domain counts
  for EVERY group at once.
- the **feasibility scan**: per-group member request slots ``req[G, M,
  R]`` against per-node free capacity ``free[N, R]`` — the greedy
  all-or-nothing scan (gang/kernel.run_feasibility) behind
  ``gang.engine.group_preview``.

Port of the JAX package's ``gang/encode.py`` (JAX-free there too).

Resource columns are GCD-scaled with the same ``gcd_scale_columns`` the
batch and victim-search encoders share, so device floats stay exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from kube_scheduler_simulator_tpu_torch.models.podresources import pod_resource_request
from kube_scheduler_simulator_tpu_torch.ops.encode import gcd_scale_columns

Obj = dict[str, Any]


def node_domain_ids(nodes: list[Obj], topology_keys: list[str]) -> "tuple[np.ndarray, int]":
    """``dom[G, N]`` — the domain id of node n under each group's packing
    key, plus the distinct-domain width D.  Ids are assigned per (key,
    label value) in first-seen node order; nodes missing the label share
    the key's empty-value domain (they pack together, which is what
    "fewest distinct domains" means for unlabeled flat clusters)."""
    G, N = len(topology_keys), len(nodes)
    dom = np.zeros((G, N), dtype=np.int32)
    width = 1
    for g, key in enumerate(topology_keys):
        ids: dict[str, int] = {}
        for n, nd in enumerate(nodes):
            val = ((nd.get("metadata") or {}).get("labels") or {}).get(key, "")
            if val not in ids:
                ids[val] = len(ids)
            dom[g, n] = ids[val]
        width = max(width, len(ids))
    return dom, width


class GangFeasibilityProblem:
    """Encoded all-or-nothing scan state for G groups × N nodes."""

    __slots__ = ("req", "valid", "free", "cnt_free", "dom", "D", "resource_names",
                 "group_keys", "node_names")

    def __init__(self) -> None:
        self.resource_names: list[str] = []


def encode_feasibility(
    member_pods: "list[list[Obj]]",
    topology_keys: list[str],
    node_infos: list[Any],
    resource_names: "list[str] | None" = None,
) -> GangFeasibilityProblem:
    """Encode groups' member requests + per-node free capacity.

    ``member_pods[g]`` are group g's UNBOUND members (the ones the scan
    must place); ``node_infos`` already account bound usage."""
    if resource_names is None:
        res: set[str] = set()
        for ms in member_pods:
            for p in ms:
                for r, v in pod_resource_request(p).items():
                    if v > 0:
                        res.add(r)
        resource_names = sorted(res) or ["cpu"]
    res_idx = {r: j for j, r in enumerate(resource_names)}
    G = len(member_pods)
    M = max((len(ms) for ms in member_pods), default=0)
    N = len(node_infos)
    R = len(resource_names)
    pr = GangFeasibilityProblem()
    pr.resource_names = resource_names
    pr.node_names = [ni.name for ni in node_infos]
    pr.req = np.zeros((G, max(M, 1), R), dtype=np.int64)
    pr.valid = np.zeros((G, max(M, 1)), dtype=bool)
    for g, ms in enumerate(member_pods):
        for m, p in enumerate(ms):
            for r, v in pod_resource_request(p).items():
                j = res_idx.get(r)
                if j is not None:
                    pr.req[g, m, j] = v
            pr.valid[g, m] = True
    pr.free = np.zeros((N, R), dtype=np.int64)
    pr.cnt_free = np.zeros(N, dtype=np.int64)
    for n, ni in enumerate(node_infos):
        for r, j in res_idx.items():
            pr.free[n, j] = ni.allocatable.get(r, 0) - ni.requested.get(r, 0)
        pr.cnt_free[n] = ni.allowed_pod_number() - len(ni.pods)
    nodes = [ni.node for ni in node_infos]
    pr.dom, pr.D = node_domain_ids(nodes, topology_keys)
    for r in range(R):
        gcd_scale_columns([pr.free[:, r], pr.req[:, :, r]])
    return pr
