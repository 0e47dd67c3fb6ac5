"""The shared byte-parity comparator (the JAX package's ``utils/parity.py``,
copied: the port imports nothing of that package).

Every harness that byte-compares two scheduler runs (the stream tests, the
chip smoke's stream phase, ``time_stream.py``) compares the SAME per-pod
surface: a comparator copy that drifted (say, one that stopped looking at
failure conditions) would let a parity regression in the uncompared field
pass some checks and fail others.
"""

from __future__ import annotations

import hashlib
from typing import Any


def pod_parity_state(store: Any, include_conditions: bool = True) -> dict:
    """Per-pod byte-comparable state over ``store``'s pods: the binding
    (``spec.nodeName``), the full sorted annotation trail, and, unless
    ``include_conditions=False``, the failure conditions."""
    out: dict = {}
    for p in store.list("pods", copy_objects=False):
        k = p["metadata"].get("namespace", "default") + "/" + p["metadata"]["name"]
        row = (
            (p.get("spec") or {}).get("nodeName"),
            tuple(sorted((p["metadata"].get("annotations") or {}).items())),
        )
        if include_conditions:
            row += (str((p.get("status") or {}).get("conditions")),)
        out[k] = row
    return out


def parity_digest(store: Any) -> str:
    """sha256 over ``pod_parity_state`` in key order: one string two runs'
    final stores must share.  Each field is hashed as its UTF-8 bytes behind
    their length (a repr of megabyte annotation strings would cost seconds
    a store)."""
    h = hashlib.sha256()
    for k, (node, annotations, *conditions) in sorted(pod_parity_state(store).items()):
        parts = [k, repr(node), *(x for kv in annotations for x in kv), *conditions]
        h.update(len(parts).to_bytes(8, "little"))
        for part in parts:
            b = part.encode("utf-8", "surrogatepass")
            h.update(len(b).to_bytes(8, "little"))
            h.update(b)
    return h.hexdigest()
