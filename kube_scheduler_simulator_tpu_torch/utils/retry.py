"""Conflict retry with exponential backoff.

Mirrors the reference's RetryWithExponentialBackOff (reference
simulator/util/retry.go:11-26): initial 100ms, factor 3, jitter 0, 6 steps,
retrying only on conflict errors.  The in-memory store is single-process so
conflicts are rare, but the semantics (and the retry budget) are preserved
for the kube-backed adapter and for parity of behavior under concurrent
annotation updates (reference storereflector/storereflector.go:124-137).
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")


class ConflictError(Exception):
    """Optimistic-concurrency conflict (stale resourceVersion)."""


def retry_on_conflict(
    fn: Callable[[], T],
    *,
    initial_ms: float = 100.0,
    factor: float = 3.0,
    steps: int = 6,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    delay = initial_ms / 1000.0
    last: Exception | None = None
    for step in range(steps):
        try:
            return fn()
        except ConflictError as e:  # noqa: PERF203
            last = e
            if step < steps - 1:
                sleep(delay)
                delay *= factor
    assert last is not None
    raise last
