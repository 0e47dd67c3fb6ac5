"""Failover: promote a caught-up follower into the primary.

Promotion is boot-time recovery's tail, executed against a store that
was kept warm by live shipping instead of rebuilt from disk:

1. **Finalize replay** — drain the last shippable records; an
   outstanding partial write at the dead primary's tail is counted torn
   (the applier never truncates — if the old primary comes back, ITS
   boot recovery owns the truncation).
2. **Counters + invariants** — restore the durability counters from the
   last record's meta, then run the partial-gang scan: gang releases
   journal atomically, so a partially-bound PodGroup at the promotion
   point is a replication bug, and the chaos drill asserts 0.
3. **Scheduler restore** — build a FRESH SchedulerService over the
   replica store (a read replica never had a real one: a scheduler
   subscribing pre-promotion would double-apply shipped events), start
   it from the journaled config, and re-arm rotation counters, queue
   states, clocks and weights via ``restore_scheduler_state``.
4. **Watch epoch** — expire every event at or below the promotion
   resourceVersion: watchers that followed the replica get the
   410-relist path instead of straddling the ownership change
   (post-promotion versions are minted by a different writer).

The bar, enforced by the failover chaos drill (fuzz/chaos.py) and
scripts/replica_smoke.py: a run continued on the promoted follower must
BYTE-MATCH the same scenario run uninterrupted in one process.
"""

from __future__ import annotations

from typing import Any, Callable

from kube_scheduler_simulator_tpu_torch.state.recovery import (
    RecoveryManager,
    RecoveryReport,
    restore_scheduler_state,
)


class PromotionReport:
    """What failover finalized and restored."""

    def __init__(self, service: Any, recovery: RecoveryReport, applier: Any):
        self.service = service
        self.recovery = recovery
        self.records_shipped = applier.stats["records_shipped"]
        self.torn_records = applier.stats["torn_records"]
        self.rebases = applier.stats["rebases"]

    def stats(self) -> dict[str, int]:
        out = self.recovery.stats()
        out["records_shipped"] = self.records_shipped
        out["torn_records"] = self.torn_records
        out["rebases"] = self.rebases
        return out


def promote_replica(
    applier: Any,
    build_service: Callable[[Any], Any],
    config_fallback: "dict[str, Any] | None" = None,
) -> PromotionReport:
    """Turn ``applier``'s store into a primary.  ``build_service`` gets
    the store and must return an UNSTARTED SchedulerService (the caller
    chooses controllers, clocks and tie-break exactly as its boot path
    would); ``config_fallback`` covers a journal too young to carry a
    config record.  The caller owns what follows promotion: attaching a
    fresh Journal epoch (seeded with ``recovery.last_mark``) and
    starting background loops."""
    store = applier.store
    report = applier.finalize()
    counters = report.last_meta.get("counters")
    if counters:
        store.restore_durability_counters(counters)
    store.recovery_stats = report.stats()
    RecoveryManager(applier.directory).scan_partial_gangs(store, report)
    svc = build_service(store)
    svc.start_scheduler(report.scheduler_config or config_fallback)
    restore_scheduler_state(svc, report)
    # new watch epoch: replica-fed watchers must relist under the new
    # writer, mirroring recovery's re-numbered-log 410 contract
    store.expire_events_before(store.resource_version)
    applier.stats["promotions"] += 1
    applier.stats["lag_records"] = 0
    applier.stats["lag_seconds"] = 0.0
    return PromotionReport(svc, report, applier)
