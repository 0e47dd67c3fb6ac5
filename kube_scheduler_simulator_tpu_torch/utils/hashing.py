"""Deterministic 32-bit mixing for tie-break draws.

Upstream selectHost breaks score ties with an unseeded PRNG (reference
mirrors it at scheduler/scheduler.go:323-344) — any tied node is a valid
pick.  This build makes the draw reproducible AND path-independent: both
the sequential cycle (scheduler/framework_runner.py) and the batch kernel
(ops/batch.py) pick the k-th tied candidate in visit order, where k comes
from the same integer hash of (seed, per-pod attempt counter).  A counter-
keyed hash (rather than a shared PRNG stream) is what makes the two paths
agree: the draw for pod #c never depends on how many ties earlier pods had.

The kernel re-implements ``mix32`` with jnp.uint32 ops; the constants here
are the murmur3 finalizer's and must stay in sync with ops/batch.py.
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF
GOLDEN32 = 0x9E3779B9


def mix32(x: int) -> int:
    """murmur3's 32-bit finalizer (a bijection on uint32)."""
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & MASK32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & MASK32
    x ^= x >> 16
    return x


def tie_break_draw(seed: int, counter: int) -> int:
    """The uint32 draw for scheduling attempt ``counter`` under ``seed``."""
    return mix32(mix32(seed ^ GOLDEN32) ^ mix32(counter))
