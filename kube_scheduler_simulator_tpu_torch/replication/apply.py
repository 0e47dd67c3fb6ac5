"""Replica apply loop: shipped journal records → a live ClusterStore.

A :class:`ReplicaApplier` owns one :class:`~replication.ship.JournalTailer`
and feeds everything it ships through :func:`state.recovery.apply_record`
— the SAME code path boot-time recovery replays through, so a follower's
store is, by construction, the state a crashed primary would recover to.
The differences from boot recovery are operational, not semantic:

- records apply INCREMENTALLY against a store that is already serving
  readers (each wave-atomic record applies under the store lock as one
  unit — a gang release is never half-visible to a replica ``list``);
- ``notify=True`` dispatches replayed events to the replica's OWN
  subscribers, so watch streams opened against the replica advance as
  records arrive (riding the replica's event log and resourceVersions);
- nothing is ever truncated, and damage never raises: a torn tail is
  counted and the follower keeps serving its last-good state;
- compaction pruning the follower's segment triggers a REBASE — buckets
  reset, newest checkpoint loaded, pre-checkpoint watch versions
  expired so the replica's watchers 410-relist.

Lag model: one journal record IS one commit wave (store.journal_txn),
so ``lag_records`` — complete-but-unapplied records after a drain — is
the follower's distance in waves; "within one wave" is
``lag_records <= 1`` under churn.  ``lag_seconds`` is how long that
backlog has been nonzero (0.0 whenever a drain reaches the live tail).
"""

from __future__ import annotations

import time
from typing import Any

from kube_scheduler_simulator_tpu_torch.replication.ship import JournalTailer, SegmentPruned
from kube_scheduler_simulator_tpu_torch.resilience import RetryPolicy, note_retry
from kube_scheduler_simulator_tpu_torch.state import journal as J
from kube_scheduler_simulator_tpu_torch.state.recovery import (
    RecoveryReport,
    apply_record,
    load_checkpoint,
)


class ReplicaApplier:
    """Tail one journal directory into one live store.

    Single-threaded by contract: ``bootstrap()``/``step()``/``finalize()``
    are called from the follower's poll loop (replication/replica.py runs
    one daemon thread; fuzz/crash_child.py polls inline).  The ``stats``
    dict is published as ``store.replication_stats`` — the presence gate
    the /metrics endpoint keys the ``replication_*`` family off.
    """

    def __init__(self, store: Any, directory: str, notify: bool = True):
        self.store = store
        self.directory = directory
        self.notify = notify
        self.report = RecoveryReport()
        self.tailer = JournalTailer(directory)
        self.stats: dict[str, Any] = {
            "records_shipped": 0,
            "events_applied": 0,
            "lag_records": 0,
            "lag_seconds": 0.0,
            "torn_records": 0,
            "rebases": 0,
            "promotions": 0,
            "read_requests": 0,
            "read_errors": 0,
            "read_errors_by_errno": {},
            "backoffs": 0,
        }
        store.replication_stats = self.stats
        # wall-clock moment the pending backlog last became nonzero
        self._pending_since: "float | None" = None
        # transient read faults on the primary's directory (EACCES/EIO —
        # classified by the tailer, never conflated with "not created
        # yet") pace the poll loop through a seeded deterministic
        # backoff instead of hammering a broken mount at poll_s
        self.retry = RetryPolicy(base_s=0.05, factor=2.0, max_s=2.0, jitter=0.25, attempts=8)
        self._error_streak = 0
        self._backoff_until = 0.0

    # ----------------------------------------------------------- bootstrap

    def bootstrap(self) -> bool:
        """Seed the store from the newest VALID checkpoint (if any) and
        park the tailer at that checkpoint's segment index — records in
        segments >= it replay on top, exactly as in boot recovery.
        Returns True when a checkpoint loaded."""
        for idx, path in reversed(J.list_checkpoints(self.directory)):
            payload = J.read_checkpoint(path)
            if payload is None:
                self.report.bad_checkpoints += 1
                continue
            load_checkpoint(self.store, payload, self.report)
            self.report.checkpoint_loaded = True
            self.report.checkpoint_index = idx
            self.tailer.rebase_to(idx)
            return True
        return False

    # ---------------------------------------------------------- apply loop

    def step(self) -> int:
        """Drain everything currently shippable into the store; returns
        the number of records applied.  Never raises on journal damage —
        a prune rebases, a torn live tail waits, and a read-side I/O
        fault (EACCES/EIO on the primary's directory) backs off through
        the seeded RetryPolicy: consecutive faulty polls space out
        exponentially (counted — ``replication_backoffs_total`` and
        ``retry_attempts_total{seam="replication"}``), and the first
        clean poll resets the streak."""
        if time.monotonic() < self._backoff_until:
            return 0
        applied = 0
        errors_before = self.tailer.stats["read_errors"]
        while True:
            try:
                payloads = self.tailer.poll()
            except SegmentPruned:
                self._rebase()
                continue
            if not payloads:
                break
            for payload in payloads:
                if apply_record(self.store, payload, self.report, notify=self.notify):
                    applied += 1
        if self.tailer.stats["read_errors"] > errors_before:
            delay = self.retry.delay(min(self._error_streak, self.retry.attempts - 1))
            self._error_streak += 1
            self._backoff_until = time.monotonic() + delay
            self.stats["backoffs"] += 1
            note_retry("replication")
            # skip the gauge refresh: pending_records() re-reads the
            # faulty files and would double-count the same fault
            self._sync_error_stats()
            return applied
        self._error_streak = 0
        self._refresh_gauges()
        return applied

    def _rebase(self) -> None:
        """Compaction pruned the segment under the tailer: reset the
        buckets and reload from the newest checkpoint.  The checkpoint's
        ``expire_events_before`` makes every watcher holding a
        pre-rebase resourceVersion 410-relist — the replica-side mirror
        of a primary watcher crossing a compaction."""
        for idx, path in reversed(J.list_checkpoints(self.directory)):
            payload = J.read_checkpoint(path)
            if payload is None:
                self.report.bad_checkpoints += 1
                continue
            with self.store.lock:
                self.store.clear_for_replay()
                load_checkpoint(self.store, payload, self.report)
            self.report.checkpoint_loaded = True
            self.report.checkpoint_index = idx
            self.tailer.rebase_to(idx)
            self.stats["rebases"] += 1
            return
        # a prune implies compaction, and compaction always writes its
        # checkpoint BEFORE deleting segments — so this is unreachable
        # unless the directory itself was damaged out-of-band
        raise SegmentPruned(
            f"segment pruned but no readable checkpoint remains in {self.directory}"
        )

    def _sync_error_stats(self) -> None:
        self.stats["read_errors"] = self.tailer.stats["read_errors"]
        self.stats["read_errors_by_errno"] = dict(self.tailer.read_errors_by_errno)

    def _refresh_gauges(self) -> None:
        self.stats["records_shipped"] = self.report.replayed_records
        self.stats["events_applied"] = self.report.replayed_events
        self.stats["torn_records"] = self.tailer.stats["torn_records"]
        self._sync_error_stats()
        pending = self.tailer.pending_records()
        self.stats["lag_records"] = pending
        if pending <= 0:
            self._pending_since = None
            self.stats["lag_seconds"] = 0.0
        else:
            if self._pending_since is None:
                self._pending_since = time.monotonic()
            self.stats["lag_seconds"] = time.monotonic() - self._pending_since

    # ----------------------------------------------------------- promotion

    def finalize(self) -> RecoveryReport:
        """Promotion step one: the primary is known dead — drain the
        remaining tail (any outstanding partial write is counted torn,
        never truncated) and hand back the report the promotion path
        restores scheduler state from."""
        try:
            payloads = self.tailer.finalize()
        except SegmentPruned:
            self._rebase()
            payloads = self.tailer.finalize()
        for payload in payloads:
            apply_record(self.store, payload, self.report, notify=self.notify)
        self._refresh_gauges()
        return self.report
