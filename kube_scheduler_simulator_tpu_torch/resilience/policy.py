"""Deadline / RetryPolicy / Breaker — the resilience substrate.

Three primitives, deliberately tiny and deterministic:

- :class:`Deadline` — a monotonic budget every blocking wait slices
  from, so a seam's total wait is bounded even when it retries.
- :class:`RetryPolicy` — jittered exponential backoff whose jitter is
  drawn from a SEEDED hash of (seed, attempt), not from wall-clock
  entropy: the same ``KSS_RETRY_SEED`` produces the same schedule in
  every process, which is what lets the chaos harnesses replay a run
  (fuzz/chaos.py) and byte-compare it against an uninterrupted one —
  a ``random.random()`` here would make retry timing the one
  non-replayable input in the system.
- :class:`Breaker` — the closed → open → half-open circuit with every
  transition counted.  ``cooldown_s=None`` is the "last resort" shape:
  once open it stays open (the procmesh pool's counted permanent
  degradation to the virtual mesh).

Module-level: the per-seam retry counter (:func:`note_retry`) surfaced
as ``retry_attempts_total{seam}`` by server/metrics.py.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Callable

__all__ = [
    "Breaker",
    "Deadline",
    "RetryPolicy",
    "note_retry",
    "reset_retry_stats",
    "retry_seed_from_env",
    "retry_stats",
]


def retry_seed_from_env() -> int:
    """The ``KSS_RETRY_SEED`` knob (default 0): the seed every
    env-constructed RetryPolicy jitters from.  Validated here so a typo
    fails loudly at construction (docs/environment-variables.md)."""
    raw = os.environ.get("KSS_RETRY_SEED", "").strip()
    if not raw:
        return 0
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"KSS_RETRY_SEED must be an integer, got {raw!r}") from None


class Deadline:
    """A monotonic time budget; waits slice from it, never exceed it."""

    def __init__(self, budget_s: float, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.budget_s = float(budget_s)
        self._t0 = clock()

    @classmethod
    def after(cls, budget_s: float) -> "Deadline":
        return cls(budget_s)

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> float:
        return max(0.0, self.budget_s - self.elapsed())

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def slice(self, cap_s: float) -> float:
        """A wait bounded by BOTH the per-step cap and the remaining
        budget — the shape every poll loop under a deadline wants."""
        return max(0.0, min(float(cap_s), self.remaining()))


def _unit_hash(seed: int, attempt: int) -> float:
    """A deterministic uniform in [0, 1) from (seed, attempt) — the
    jitter source.  Hash-based rather than random.Random so concurrent
    policies sharing a seed never contend on (or advance) shared RNG
    state, and attempt k's jitter is independent of whether attempts
    0..k-1 were ever taken."""
    h = hashlib.sha256(f"{seed}:{attempt}".encode("ascii")).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class RetryPolicy:
    """Seeded, deterministic jittered exponential backoff.

    ``delay(attempt)`` for attempt 0, 1, 2… is
    ``min(max_s, base_s * factor**attempt)`` scaled by a jitter factor
    in ``[1 - jitter, 1 + jitter]`` drawn from ``_unit_hash(seed,
    attempt)`` — same seed ⇒ identical schedule, always within the
    jitter band, capped so no single sleep exceeds ``max_s * (1 +
    jitter)``.  ``attempts`` bounds how many retries a seam takes before
    giving up (``exhausted``)."""

    def __init__(
        self,
        base_s: float = 0.05,
        factor: float = 2.0,
        max_s: float = 2.0,
        jitter: float = 0.25,
        attempts: int = 5,
        seed: "int | None" = None,
    ):
        if base_s <= 0 or factor < 1.0 or max_s <= 0 or not (0.0 <= jitter < 1.0):
            raise ValueError(
                f"invalid RetryPolicy(base_s={base_s}, factor={factor}, "
                f"max_s={max_s}, jitter={jitter})"
            )
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.attempts = int(attempts)
        self.seed = retry_seed_from_env() if seed is None else int(seed)

    def delay(self, attempt: int) -> float:
        nominal = min(self.max_s, self.base_s * (self.factor ** max(0, int(attempt))))
        u = _unit_hash(self.seed, int(attempt))
        return nominal * (1.0 - self.jitter + 2.0 * self.jitter * u)

    def schedule(self) -> list[float]:
        return [self.delay(i) for i in range(self.attempts)]

    def exhausted(self, attempt: int) -> bool:
        return int(attempt) >= self.attempts


class Breaker:
    """Counted circuit breaker: closed → open → half-open → closed/open.

    - CLOSED: calls flow; ``fail_threshold`` CONSECUTIVE failures open
      the circuit (one success resets the streak).
    - OPEN: ``allow()`` returns False until ``cooldown_s`` has elapsed,
      then the breaker half-opens and admits ONE probe.
      ``cooldown_s=None`` never half-opens — open is terminal (the
      counted permanent-degradation shape).
    - HALF_OPEN: the probe's ``success()`` closes the circuit, its
      ``failure()`` re-opens it.

    Every transition is counted in ``stats`` (``opened`` /
    ``half_opened`` / ``closed``) — the /metrics
    ``procmesh_breaker_state`` gauge and its siblings read
    ``state_code``.  Thread-safe: transitions serialize on an internal
    mutex (the procmesh dispatcher and the metrics reader race)."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    _STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(
        self,
        fail_threshold: int = 3,
        cooldown_s: "float | None" = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if fail_threshold < 1:
            raise ValueError(f"fail_threshold must be >= 1, got {fail_threshold}")
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = None if cooldown_s is None else float(cooldown_s)
        self._clock = clock
        self._mu = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.stats: dict[str, int] = {"opened": 0, "half_opened": 0, "closed": 0}

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    @property
    def state_code(self) -> int:
        """0 closed, 1 half-open, 2 open — the /metrics gauge value."""
        with self._mu:
            return self._STATE_CODES[self._state]

    def allow(self) -> bool:
        with self._mu:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self.cooldown_s is None or self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self._state = self.HALF_OPEN
                self.stats["half_opened"] += 1
                self._probing = True
                return True
            # HALF_OPEN: exactly one probe in flight
            if self._probing:
                return False
            self._probing = True
            return True

    def success(self) -> None:
        with self._mu:
            self._consecutive_failures = 0
            self._probing = False
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self.stats["closed"] += 1

    def failure(self) -> None:
        with self._mu:
            self._probing = False
            if self._state == self.HALF_OPEN:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.stats["opened"] += 1
                return
            self._consecutive_failures += 1
            if self._state == self.CLOSED and self._consecutive_failures >= self.fail_threshold:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.stats["opened"] += 1


# ----------------------------------------------------------- retry counter

_RETRY_MU = threading.Lock()
_RETRY_BY_SEAM: dict[str, int] = {}


def note_retry(seam: str, n: int = 1) -> None:
    """Count a retry taken at a named seam — surfaced on /metrics as
    ``retry_attempts_total{seam}``.  A retry is a degradation the run
    survived; like every other fallback in this repo, it is counted,
    never silent."""
    with _RETRY_MU:
        _RETRY_BY_SEAM[seam] = _RETRY_BY_SEAM.get(seam, 0) + int(n)


def retry_stats() -> dict[str, int]:
    with _RETRY_MU:
        return dict(_RETRY_BY_SEAM)


def reset_retry_stats() -> None:
    """Test hook: clear the per-seam counters."""
    with _RETRY_MU:
        _RETRY_BY_SEAM.clear()
