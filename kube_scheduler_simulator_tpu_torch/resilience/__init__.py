"""Fault-tolerance primitives shared by every cross-process seam.

The execution plane grew into an ensemble — shard worker subprocesses
(ops/procmesh.py), a journaled store shipping to follower processes
(state/journal.py + replication/), chaos children (fuzz/) — and every
seam needs the same three disciplines: a bounded wait (:class:`Deadline`),
a replayable backoff schedule (:class:`RetryPolicy` — seeded and
deterministic, never wall-clock-random, so a chaos run's retry timing is
reproducible byte-for-byte), and a counted circuit breaker
(:class:`Breaker`) that turns "one strike and the subsystem is dead for
the run" into "K counted consecutive failures, then a counted
degradation".

Every retry taken through these primitives is counted per seam
(:func:`note_retry` → ``retry_attempts_total{seam}`` on /metrics) —
the repo's standing rule that no fallback is silent applies to retries
too.
"""

from kube_scheduler_simulator_tpu_torch.resilience.policy import (
    Breaker,
    Deadline,
    RetryPolicy,
    note_retry,
    reset_retry_stats,
    retry_seed_from_env,
    retry_stats,
)

__all__ = [
    "Breaker",
    "Deadline",
    "RetryPolicy",
    "note_retry",
    "reset_retry_stats",
    "retry_seed_from_env",
    "retry_stats",
]
