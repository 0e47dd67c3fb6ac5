"""Node-axis mesh plumbing: the ``KSS_MESH_DEVICES`` knob resolved and
validated at the boundary.

Port of the JAX package's ``ops/mesh.py``.  The node axis is the
workload's tensor-parallel axis: every per-step filter and score is
elementwise over nodes, and the cross-node reductions (feasible counts,
normalize max/min, the argmax select) are what a sharded run turns into
collectives.  Three kernels scan it: the main scan, the victim search and
the estimator's lanes.  A mesh here is a ``NodeMesh``: the cards that
that each hold a slice of the node axis (a shard), under the axis name
``"nodes"``.  An explicit ``NodeMesh`` may name one device several times:
each entry is one shard with its own buffers, so a mesh of shards on one
card runs the layout (and the kernels' in-launch exchange) that a mesh of
several cards runs, as the reference's tests run on a virtual CPU mesh.

Resolution order as in the reference: an explicit mesh wins; the
``"auto"`` sentinel (the ``SchedulerService`` default) reads
``KSS_MESH_DEVICES``; ``None``, unset, empty or ``1`` mean one device.
Validation happens HERE: a bad device count is a :class:`MeshConfigError`
naming the rule it broke, in the reference's words and order (an integer,
at least 1, a power of two, at most the visible devices).  The visible
devices are ``torch.cuda.device_count()`` for an engine on the card and
one for an engine on the CPU (the port's CPU runs are one process on one
device; the reference's virtual 8-device CPU mesh has no counterpart).

A mesh over distinct cards that cannot map each other's memory
(``torch.cuda.can_device_access_peer``) is a :class:`MeshConfigError` when
it is resolved: the sharded scan exchanges each pod's partials through a
mailbox in the first card's memory, which the other cards map as peers.
The reference's ``tpu_lowering_dryrun`` (a ``jax.export`` lowering for
another platform) has no counterpart: the port's kernels are built by
``nvcc`` for one target (ops/kernels.py).
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch

AXIS_NAME = "nodes"


class MeshConfigError(ValueError):
    """A mesh/device-count configuration the boundary rejects."""


class NodeMesh(NamedTuple):
    """The devices a node-axis mesh spans, under one axis name."""

    devices: tuple
    axis_name: str = AXIS_NAME

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}


def _available_devices(device: "str | torch.device | None") -> list:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def mesh_from_env(axis_name: str = AXIS_NAME, device: "str | torch.device | None" = None) -> "NodeMesh | None":
    """The node-axis mesh the ``KSS_MESH_DEVICES`` knob asks for, or None
    when the knob is unset, empty or ``1`` (one device).  ``device``: the
    engine's device (the card unless "cpu"), whose kind sets the visible
    devices.

    Rejected with a :class:`MeshConfigError`, in this order:

    - a value that is not an integer, or one below 1;
    - a count that is not a power of two: the encoder's node buckets
      {2^k, 1.25·2^k, 1.5·2^k, 1.75·2^k} (ops/encode._bucket) divide
      evenly by a power-of-two count from four times the count on, and by
      almost no other count;
    - a count above the visible devices.
    """
    raw = os.environ.get("KSS_MESH_DEVICES")
    if raw is None or not raw.strip():
        return None
    try:
        n = int(raw)
    except ValueError:
        raise MeshConfigError(f"KSS_MESH_DEVICES must be a positive integer, got {raw!r}") from None
    if n <= 0:
        raise MeshConfigError(f"KSS_MESH_DEVICES must be >= 1, got {n}")
    if n == 1:
        return None
    if n & (n - 1):
        raise MeshConfigError(
            f"KSS_MESH_DEVICES={n} is not a power of two: a power-of-two count divides every padded "
            f"node bucket >= 4x its size, while {n} divides almost none (every bucket transition would "
            f"pad off the series); device meshes come in power-of-two sizes, so this is rejected as a "
            f"misconfiguration"
        )
    devices = _available_devices(device)
    if n > len(devices):
        raise MeshConfigError(
            f"KSS_MESH_DEVICES={n} exceeds the {len(devices)} visible device(s) of "
            f"{torch.device('cuda' if device is None else device).type} — lower the knob"
        )
    return NodeMesh(tuple(devices[:n]), axis_name)


def resolve_mesh(mesh: Any, axis_name: str = AXIS_NAME, device: "str | torch.device | None" = None) -> Any:
    """Normalize a mesh argument: ``"auto"`` → :func:`mesh_from_env`,
    ``None`` → None, an explicit mesh → itself, validated to carry the
    ``"nodes"`` axis every sharded kernel shards over."""
    if mesh is None:
        return None
    if isinstance(mesh, str):
        if mesh == "auto":
            return mesh_from_env(axis_name, device)
        raise MeshConfigError(f"mesh must be a NodeMesh, None or 'auto', got {mesh!r}")
    if axis_name not in getattr(mesh, "shape", {}):
        raise MeshConfigError(
            f"mesh {mesh} has no {axis_name!r} axis — the node-axis kernels shard over NodeMesh(devices, "
            f"{axis_name!r})"
        )
    cards = sorted({d.index or 0 for d in map(torch.device, mesh.devices) if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise MeshConfigError(
                    f"mesh {mesh}: cuda:{a} cannot access cuda:{b}'s memory as a peer — the sharded kernels "
                    f"exchange each pod's partials through a mailbox every card of the mesh maps"
                )
    return mesh


def mesh_devices(mesh: Any) -> int:
    """Device count of a node-axis mesh (0 = one device, no mesh)."""
    return int(mesh.shape[AXIS_NAME]) if mesh is not None else 0


def mesh_on_accelerator(mesh: Any) -> bool:
    """True when the mesh's devices are cards."""
    if mesh is None:
        return False
    return torch.device(mesh.devices[0]).type != "cpu"
