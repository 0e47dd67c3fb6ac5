"""Replicated control plane: live journal shipping + hot standby.

The write-ahead journal (state/journal.py) turns every store mutation
into an ordered, CRC-framed, wave-atomic record stream; this package
tails it.  The reference architecture backs its
apiserver with etcd — replaced here by process memory — and this layer
restores the fan-out half of that story:

- :mod:`replication.ship` — ``JournalTailer``: incrementally follows a
  live ``KSS_JOURNAL_DIR`` across rotation/compaction, CRC-validating
  each frame, distinguishing a mid-write partial tail (wait, re-poll)
  from a torn one (crash) — and NEVER truncating the primary's files.
- :mod:`replication.apply` — ``ReplicaApplier``: applies shipped
  records one wave-atomic record at a time to a live ``ClusterStore``
  through :func:`state.recovery.apply_record`, with measured lag.
- :mod:`replication.replica` — ``KSS_REPLICA_OF`` read-replica server
  mode: the echo server boots read-only over the replica store (writes
  405), serving list/get/watch/SSE traffic off the primary.
- :mod:`replication.promote` — failover: finalize replay, partial-gang
  scan, scheduler-state restore, restart from the journaled config —
  the promoted follower must byte-match an uninterrupted run.
"""

from kube_scheduler_simulator_tpu_torch.replication.apply import ReplicaApplier
from kube_scheduler_simulator_tpu_torch.replication.promote import PromotionReport, promote_replica
from kube_scheduler_simulator_tpu_torch.replication.replica import ReplicaContainer, replica_knobs
from kube_scheduler_simulator_tpu_torch.replication.ship import JournalTailer, SegmentPruned

__all__ = [
    "JournalTailer",
    "SegmentPruned",
    "ReplicaApplier",
    "PromotionReport",
    "promote_replica",
    "ReplicaContainer",
    "replica_knobs",
]
