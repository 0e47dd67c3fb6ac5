"""Carry a problem lowered by the JAX package across to the port.

This system has no weights to convert; its counterpart is the lowered
problem itself.  ``from_jax_problem`` takes the JAX package's
``DeviceProblem`` as numpy arrays (``dp._asdict()`` with every leaf passed
through ``np.asarray``; ``spf`` and ``sps`` as tuples) and places the
port's ``DeviceProblem`` on ``device`` in one copy, so both packages'
kernels can be fed the very same problem.  The JAX-only fields (the
on-device expansion placeholders, the traced weight vector and the one-hot
key expansion) are dropped; the port's own derived fields (the per-pod
column and term-group lists) are built from the carried ones as ``lower``
builds them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.device import resolve_device
from kube_scheduler_simulator_tpu_torch.ops.batch import (
    LIST_FIELDS,
    ROUND_SCALARS,
    DeviceProblem,
    place,
    term_lists,
    volume_lists,
)


def from_jax_problem(
    fields: "dict[str, Any]", dims: dict, device: "str | torch.device | None" = None
) -> "tuple[DeviceProblem, dict]":
    """(port DeviceProblem on ``device``, dims) from the JAX package's
    lowered problem given as numpy arrays and its dims dict."""
    host: dict[str, Any] = volume_lists(
        fields["pod_ports"], fields["pod_restr"], fields["pod_csi"], fields["csi_drv_oh"]
    )
    host.update(term_lists(fields["term_match"]))
    for name in DeviceProblem._fields:
        if name in LIST_FIELDS:
            continue
        val = fields[name]
        if name in ROUND_SCALARS:
            host[name] = int(np.asarray(val))
        elif isinstance(val, tuple):
            host[name] = tuple(np.asarray(v) for v in val)
        else:
            host[name] = np.asarray(val)
    return place(host, resolve_device(device)), dict(dims)
