"""Per-wave stage profiler — where does the wall go?

Always-on (``KSS_PROFILE=0`` opts out), near-zero overhead: one dict
bump and one histogram-bucket increment per stamp, a handful of stamps
per wave.  The stages partition a scheduling wave's HOST timeline:

- ``admit``        — streamed-path admission: queue drain, gate checks,
                     and the store listings feeding the wave (zero on
                     the direct ``schedule()`` path)
- ``encode``       — cluster state -> padded host problem (ops/encode,
                     delta or full) + lowering to device-dtype planes
- ``upload``       — host planes -> device (DevicePlacer scatter/put or
                     the direct host-to-device copy)
- ``dispatch``     — executable resolution (jit cache / AOT load; cold
                     waves pay tracing+compile here) + the async kernel
                     dispatch call
- ``device_blocked`` — host blocked on the scan's packed per-pod fetch
                     (device time the host PAID; overlapped device time
                     never shows up)
- ``trace_fetch``  — trace compaction blob fetch + unpack + host-side
                     trace reconstruction
- ``annotate``     — trace -> annotation bytes (the wave-capsule C
                     renderer, or the per-pod Python path)
- ``commit``       — the commit block's GLUE after carve-outs:
                     ResultStore merge, binding decisions, reflector
                     wave assembly — minus the nested sub-stages below
- ``store_mutate`` — ClusterStore mutation bodies (create/update/patch/
                     delete/bulk_update/bind_pod): bucket writes, rv
                     stamping, event fan-out — minus journal time
- ``journal_append`` — WAL bytes: frame build + append + txn publish
                     (carved out of the surrounding mutation)
- ``watch_render`` — wire-bytes rendering for watch/list consumers
                     (server/wirecache.py misses and the uncached
                     renderer; HTTP-thread stamps aggregate ambiently)
- ``queue_maint``  — scheduling-queue maintenance inside admission:
                     waiting-pod processing, backoff gates, QueueSort
- ``snapshot_rv``  — Snapshot builds + waiting-pod assume bookkeeping
                     (the rv-consistent state capture commits replay
                     against)
- ``host_other``   — the remainder of the wave's wall, computed at
                     close so the stage vector always sums EXACTLY to
                     the wall

``admit``/``commit`` are stamped EXCLUSIVE of the sub-stages nested
inside their intervals (``note_excl`` subtracts the nested seconds), so
the stamps stay disjoint single-thread host intervals and per wave
``sum(named stages) <= wall`` must hold; a negative ``host_other``
means a double-counted stamp and fails the tier-1 invariant test
(tests/test_profile.py).  Records are dicts carried through
``BatchEngine._prep`` -> ``PendingBatch`` -> ``BatchResult`` -> the
commit path; overlapped streamed waves each own their record (wave
k+1's encode interval lies inside wave k's wall but is attributed to
k+1 — attribution follows the work, not the clock).

Two aggregate denominators, because overlapped records OVERLAP:

- ``wall_s``  — sum of per-record walls (legacy; double-counts the
                overlap of streamed prefetch on purpose — it is the
                per-wave latency aggregate)
- ``span_s``  — the UNION of record walls (a monotonic coverage cursor
                advances at each close) plus ``orphan_s``, ambient
                stamps landed outside any record (between-wave snapshot
                builds, HTTP-thread renders).  ``span_s`` is the honest
                attribution denominator: scripts/perf_smoke.py requires
                named stages >= 95% of the fused leg's span.

Surfaces: ``SchedulerService.metrics()["profile"]`` (aggregate totals,
per-stage max, log4 latency histogram, the last closed wave) rendered
as a Prometheus histogram family by server/metrics.py, and
``bench.py --profile-report`` / ``--hostpath-report`` (the cfg5/cfg9/
cfg12/cfg13b stage attribution tables).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

# the stage vector (order = presentation order); host_other is derived
STAGES = (
    "admit",
    "encode",
    "upload",
    "dispatch",
    "device_blocked",
    "trace_fetch",
    "annotate",
    "commit",
    "store_mutate",
    "journal_append",
    "watch_render",
    "queue_maint",
    "snapshot_rv",
    "host_other",
)

# sub-stages carved out of an enclosing admit/commit interval: noting
# one also accrues the record's ``_nested`` seconds, which ``note_excl``
# subtracts from the parent stamp so the vector stays a partition
SUB_STAGES = frozenset(
    ("store_mutate", "journal_append", "watch_render", "queue_maint", "snapshot_rv")
)

# log4 latency buckets (seconds), Prometheus-style upper bounds; the
# last implicit bucket is +Inf.  100 us floor: stamps below it are
# bookkeeping noise, not optimization targets.
BUCKETS = tuple(1e-4 * (4.0**i) for i in range(9))  # 100us .. ~6.6s


def _enabled_from_env() -> bool:
    return os.environ.get("KSS_PROFILE", "1") != "0"


class WaveProfiler:
    """Aggregates per-wave stage stamps; one instance per
    SchedulerService, shared by its engines and streaming pipelines.

    Single-writer discipline (the scheduling thread); the metrics
    scrape copies under the GIL like every other stats surface.
    ``current`` is thread-owned: the setter records the owning thread,
    and ambient stamps from OTHER threads (HTTP watch renders) fall
    through to the orphan aggregate instead of corrupting the record."""

    def __init__(self, enabled: "bool | None" = None):
        self.enabled = _enabled_from_env() if enabled is None else enabled
        self.waves = 0
        self.wall_s = 0.0
        # seconds attributed outside any wave record (between-wave
        # snapshot builds, HTTP-thread renders) — still named time
        self.orphan_s = 0.0
        # union-of-record-walls coverage cursor (see module docstring)
        self._span_s = 0.0
        self._span_cursor = 0.0
        # stage -> [count, total_s, max_s]
        self.totals: dict[str, list] = {s: [0, 0.0, 0.0] for s in STAGES}
        # stage -> per-bucket counts (len(BUCKETS)+1, last is +Inf)
        self.hist: dict[str, list] = {s: [0] * (len(BUCKETS) + 1) for s in STAGES}
        self.last_wave: dict[str, Any] = {}
        # ambient record for stamp sites that can't thread one through
        # (store mutations, ResultStore.add_wave_results) — set around
        # the admission and commit blocks by the scheduling thread
        self._current: "dict | None" = None
        self._current_tid = 0

    # ---------------------------------------------------- ambient record

    @property
    def current(self) -> "dict | None":
        return self._current

    @current.setter
    def current(self, rec: "dict | None") -> None:
        self._current = rec
        self._current_tid = threading.get_ident() if rec is not None else 0

    # ------------------------------------------------------------ waves

    def open(self) -> "dict | None":
        """Start a wave record at the first host touch (engine _prep)."""
        if not self.enabled:
            return None
        return {"_t0": time.perf_counter(), "_walled": 0.0, "_closed": False}

    def note(self, rec: "dict | None", stage: str, dt: float) -> None:
        """Attribute ``dt`` seconds to ``stage`` (disjoint intervals!)."""
        if rec is None or not self.enabled:
            return
        rec[stage] = rec.get(stage, 0.0) + dt
        if stage in SUB_STAGES:
            rec["_nested"] = rec.get("_nested", 0.0) + dt
        self._agg(stage, dt)

    def note_current(self, stage: str, dt: float) -> None:
        rec = self._current
        if rec is not None and self._current_tid != threading.get_ident():
            return  # another thread's wave — don't corrupt its record
        self.note(rec, stage, dt)

    def nested(self, rec: "dict | None") -> float:
        """The record's accrued sub-stage seconds — capture before an
        enclosing interval, pass to ``note_excl`` after."""
        return 0.0 if rec is None else rec.get("_nested", 0.0)

    def note_excl(
        self, rec: "dict | None", stage: str, dt: float, nested0: float = 0.0
    ) -> None:
        """Stamp an enclosing interval EXCLUSIVE of the sub-stages that
        landed inside it since ``nested0`` (clamped at zero — a clock
        ordering wobble must not make the partition sum exceed wall)."""
        if rec is None or not self.enabled:
            return
        carved = rec.get("_nested", 0.0) - nested0
        self.note(rec, stage, dt - carved if dt > carved else 0.0)

    def ambient(self, stage: str, dt: float) -> None:
        """Attribute ``dt`` to ``stage`` against the current record when
        one is open on THIS thread, else to the orphan aggregate — the
        stamp is never lost and never corrupts another thread's wave."""
        if not self.enabled:
            return
        rec = self._current
        if rec is not None and self._current_tid == threading.get_ident():
            self.note(rec, stage, dt)
            return
        self.orphan_s += dt
        self._agg(stage, dt)

    def close(self, rec: "dict | None", pods: int = 0) -> None:
        """Close (idempotently re-close) a wave at commit end: the wall
        extends to now, ``host_other`` re-derives as wall - sum(named),
        and only the DELTA since the previous close aggregates — the
        windowed round path closes once per committed window."""
        if rec is None or not self.enabled:
            return
        now = time.perf_counter()
        wall = now - rec["_t0"]
        named = sum(rec.get(s, 0.0) for s in STAGES if s != "host_other")
        prev_other = rec.get("host_other", 0.0)
        other = wall - named
        rec["host_other"] = other
        self._agg("host_other", other - prev_other, count=not rec["_closed"])
        self.wall_s += wall - rec["_walled"]
        rec["_walled"] = wall
        rec["wall"] = wall
        # span: only the part of this wall not already covered by an
        # earlier close (overlapped streamed waves share clock time)
        fresh_from = rec["_t0"] if rec["_t0"] > self._span_cursor else self._span_cursor
        if now > fresh_from:
            self._span_s += now - fresh_from
            self._span_cursor = now
        if pods:
            rec["pods"] = rec.get("pods", 0) + pods
        if not rec["_closed"]:
            self.waves += 1
            rec["_closed"] = True
        self.last_wave = {
            k: v for k, v in rec.items() if not k.startswith("_")
        }

    # -------------------------------------------------------- internals

    def _agg(self, stage: str, dt: float, count: bool = True) -> None:
        t = self.totals.setdefault(stage, [0, 0.0, 0.0])
        if count:
            t[0] += 1
        t[1] += dt
        if dt > t[2]:
            t[2] = dt
        h = self.hist.setdefault(stage, [0] * (len(BUCKETS) + 1))
        for i, ub in enumerate(BUCKETS):
            if dt <= ub:
                h[i] += 1
                break
        else:
            h[-1] += 1

    # --------------------------------------------------------- surfaces

    @property
    def span_s(self) -> float:
        """Union of record walls + orphan seconds: the honest
        attribution denominator (see module docstring)."""
        return self._span_s + self.orphan_s

    def coverage(self) -> "tuple[float, float]":
        """(named_total_s, span_s) — the >= 95% invariant's two sides."""
        named = sum(
            self.totals[s][1] for s in STAGES if s != "host_other"
        )  # STAGES only: ad-hoc series (resultstore_s) overlap commit
        return named, self.span_s

    def snapshot(self) -> dict:
        """The metrics()/bench view — plain data, copy-on-read."""
        return {
            "enabled": int(self.enabled),
            "waves": self.waves,
            "wall_s": self.wall_s,
            "span_s": self.span_s,
            "orphan_s": self.orphan_s,
            "stages": {
                s: {"count": t[0], "total_s": t[1], "max_s": t[2]}
                for s, t in self.totals.items()
            },
            "hist_buckets": list(BUCKETS),
            "hist": {s: list(h) for s, h in self.hist.items()},
            "last_wave": dict(self.last_wave),
        }

    def report(self) -> str:
        """Human-readable attribution table (bench --profile-report)."""
        lines = [f"{'stage':<15}{'count':>8}{'total_s':>10}{'max_s':>9}{'share':>8}"]
        denom = self.span_s or 1.0
        for s in STAGES:
            c, tot, mx = self.totals.get(s, [0, 0.0, 0.0])
            lines.append(
                f"{s:<15}{c:>8}{tot:>10.3f}{mx:>9.3f}{tot / denom:>7.1%}"
            )
        named, span = self.coverage()
        lines.append(f"{'wall':<15}{self.waves:>8}{self.wall_s:>10.3f}")
        lines.append(
            f"{'span':<15}{'':>8}{span:>10.3f}{'':>9}"
            f"{(named / span if span else 1.0):>7.1%} named"
        )
        return "\n".join(lines)
