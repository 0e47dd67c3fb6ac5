"""Read-replica server mode: ``KSS_REPLICA_OF=<journal dir>``.

A :class:`ReplicaContainer` duck-types the DI container surface the
HTTP server consumes (server/di.py), but backs it with a store that is
FED, not driven: a follower thread tails the primary's journal through
:class:`~replication.apply.ReplicaApplier` and every shipped record
applies with ``notify=True``, so list/get/watch/SSE traffic served off
the replica rides the replica's own event log and resourceVersions.

Read-only is enforced at the HTTP layer (server/server.py returns 405
for POST/PUT/DELETE when ``di.read_only``) and structurally here: no
scheduler, no controllers, no operators subscribe to the replica store
pre-promotion — a live scheduler reacting to shipped events would
double-schedule work the primary already placed.  The scheduler-shaped
read routes (``/api/v1/schedulerconfiguration``, ``/api/v1/tuning``…)
are served by a detached FACADE service over a throwaway empty store,
started with the journaled configuration once one ships.

``promote()`` flips the container into a primary: the follower stops,
:func:`replication.promote.promote_replica` finalizes replay and builds
the real scheduler over the replica store, controllers and operators
start, a fresh journal epoch attaches (the promoted node keeps
journaling into the SAME directory — its successor can follow it), and
writes unlock.
"""

from __future__ import annotations

import os
import threading
from typing import Any

from kube_scheduler_simulator_tpu_torch.replication.apply import ReplicaApplier
from kube_scheduler_simulator_tpu_torch.replication.promote import PromotionReport, promote_replica
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

Obj = dict[str, Any]

DEFAULT_POLL_S = 0.05


def replica_knobs() -> "Obj | None":
    """The documented ``KSS_REPLICA_*`` env knobs, validated so a typo
    fails loudly at boot (docs/environment-variables.md).  Returns None
    when replica mode is off (``KSS_REPLICA_OF`` unset) — the default,
    under which nothing in this package runs."""
    directory = os.environ.get("KSS_REPLICA_OF", "").strip()
    if not directory:
        return None
    poll_raw = os.environ.get("KSS_REPLICA_POLL_S", "").strip()
    poll_s = DEFAULT_POLL_S
    if poll_raw:
        try:
            poll_s = float(poll_raw)
        except ValueError:
            raise ValueError(f"KSS_REPLICA_POLL_S must be a number, got {poll_raw!r}")
        if poll_s <= 0:
            raise ValueError(f"KSS_REPLICA_POLL_S must be > 0, got {poll_raw!r}")
    return {"directory": directory, "poll_s": poll_s}


class ReplicaContainer:
    """DIContainer-shaped wiring for a read replica.

    Matches the surface server/server.py touches; the services it hands
    out are built lazily over the replica store (watcher, snapshot) or
    over a detached facade (scheduler reads).  ``read_only`` is the
    HTTP-layer write gate; it flips with :meth:`promote`.
    """

    def __init__(
        self,
        journal_dir: str,
        poll_s: float = DEFAULT_POLL_S,
        use_batch: str = "off",
        seed: int = 0,
        device: Any = None,
    ):
        """``device``: the scheduler services' device (the port's rule: the
        card unless the caller passes "cpu")."""
        self.journal_dir = journal_dir
        self.poll_s = float(poll_s)
        self.use_batch = use_batch
        self.seed = int(seed)
        self.device = device
        self.read_only = True
        self.cluster_store = ClusterStore()
        self.applier = ReplicaApplier(self.cluster_store, journal_dir, notify=True)
        self.applier.bootstrap()
        self.applier.step()
        self.promotion: "PromotionReport | None" = None
        self._scheduler_service: Any = None  # the real one, post-promotion
        self._facade_service: Any = None
        self._controller_manager: Any = None
        self._scenario_operator: Any = None
        self._journal: Any = None
        self._snapshot_service: Any = None
        self._reset_service: Any = None
        self._watcher_service: Any = None
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ follower

    def start_following(self) -> None:
        # lock-free: called once at replica boot, before the HTTP server
        # (and thus any promote()) exists — no concurrent writer yet
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._follow, daemon=True)
        self._thread.start()

    def stop_following(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _follow(self) -> None:
        while not self._stop.is_set():
            self.applier.step()
            self._stop.wait(self.poll_s)

    # ----------------------------------------------------------- promotion

    def promote(self) -> PromotionReport:
        """Failover: finalize replay and become a primary.  Idempotent —
        a second call returns the first promotion's report."""
        with self._lock:
            if self.promotion is not None:
                return self.promotion
            self.stop_following()
            from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService

            promotion = promote_replica(
                self.applier,
                lambda store: SchedulerService(
                    store, seed=self.seed, use_batch=self.use_batch, device=self.device
                ),
                config_fallback=None,
            )
            svc = promotion.service
            self._scheduler_service = svc
            # fresh journal epoch into the SAME directory: the promoted
            # node is now the writer, and a NEXT follower can tail it
            from kube_scheduler_simulator_tpu_torch.state.journal import (
                Journal,
                on_error_from_env,
            )
            from kube_scheduler_simulator_tpu_torch.state.recovery import (
                build_checkpoint,
                scheduler_meta_provider,
            )

            self._journal = Journal(self.journal_dir, on_error=on_error_from_env())
            self._journal.last_mark = promotion.recovery.last_mark
            self._journal.add_meta_provider(scheduler_meta_provider(svc))
            self.cluster_store.attach_journal(self._journal)
            self._journal.checkpoint_provider = lambda: build_checkpoint(
                self.cluster_store, self.snapshot_service()
            )
            self.cluster_store.journal_append("boot", {"promoted": True})
            from kube_scheduler_simulator_tpu_torch.controllers import ControllerManager
            from kube_scheduler_simulator_tpu_torch.scenario import ScenarioOperator

            self._controller_manager = ControllerManager(self.cluster_store)
            self._controller_manager.start()
            self._scenario_operator = ScenarioOperator(
                self.cluster_store, svc, self._controller_manager
            )
            self._scenario_operator.start()
            # snapshot/reset rebuilt over the REAL service; reset's
            # baseline is the promotion-point cluster, which is what a
            # rebooted primary's reset baseline would be too
            self._snapshot_service = None
            self._reset_service = None
            svc.start_background()
            self.read_only = False
            self.promotion = promotion
            return promotion

    # ------------------------------------------------------------- surface

    def scheduler_service(self) -> Any:
        """Post-promotion: the real scheduler over the replica store.
        Pre-promotion: a DETACHED facade over a throwaway empty store —
        it serves the config/tuning read routes without ever
        subscribing to the replica store (a subscribed scheduler would
        react to shipped events the primary already acted on)."""
        if self._scheduler_service is not None:
            return self._scheduler_service
        if self._facade_service is None:
            from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService

            facade = SchedulerService(ClusterStore(), seed=self.seed, use_batch="off", device=self.device)
            facade.start_scheduler(self.applier.report.scheduler_config)
            self._facade_service = facade
        return self._facade_service

    def scenario_operator(self):
        # lock-free: flips once at promotion (None -> instance), GIL-atomic
        # reference read; a request racing the flip gets either valid surface
        return self._scenario_operator

    def simulator_operator(self):
        # a replica never reconciles Simulator/SchedulerSimulation CRs
        # (the primary's operator owns them); the server therefore
        # disables those kinds, like the KEP-159 ephemeral containers
        return None

    def controller_manager(self):
        # lock-free: flips once at promotion (None -> instance), GIL-atomic
        # reference read; a request racing the flip gets either valid surface
        return self._controller_manager

    def extender_service(self):
        return self.scheduler_service().extender_service

    def snapshot_service(self):
        if self._snapshot_service is None:
            from kube_scheduler_simulator_tpu_torch.services.snapshot import SnapshotService

            self._snapshot_service = SnapshotService(
                self.cluster_store, self.scheduler_service()
            )
        return self._snapshot_service

    def reset_service(self):
        # lock-free: promotion only RESETS the cache to None (GIL-atomic);
        # a request racing it rebuilds over whichever service is current
        if self._reset_service is None:
            from kube_scheduler_simulator_tpu_torch.services.reset import ResetService

            self._reset_service = ResetService(self.cluster_store, self.scheduler_service())
        return self._reset_service

    def resource_watcher_service(self):
        if self._watcher_service is None:
            from kube_scheduler_simulator_tpu_torch.services.resourcewatcher import (
                ResourceWatcherService,
            )

            self._watcher_service = ResourceWatcherService(self.cluster_store)
        return self._watcher_service

    def import_cluster_resource_service(self):
        return None

    def tpu_scorer_bridge(self):
        if getattr(self, "_scorer_bridge", None) is None:
            from kube_scheduler_simulator_tpu_torch.scheduler.scorer_bridge import TPUScorerBridge

            self._scorer_bridge = TPUScorerBridge(self.scheduler_service())
        return self._scorer_bridge

    # ------------------------------------------------------------- replica

    def note_replica_read(self) -> None:
        """Called by the HTTP layer per GET served — the
        ``replica_read_requests_total`` counter's source."""
        self.applier.stats["read_requests"] += 1

    def replication_status(self) -> Obj:
        # lock-free: read_only is a GIL-atomic bool read — a status call
        # racing the promotion reports one of the two valid roles
        s = self.applier.stats
        return {
            "role": "replica" if self.read_only else "primary",
            "journalDir": self.journal_dir,
            "recordsShipped": s["records_shipped"],
            "eventsApplied": s["events_applied"],
            "lagRecords": s["lag_records"],
            "lagSeconds": s["lag_seconds"],
            "tornRecords": s["torn_records"],
            "rebases": s["rebases"],
            "promotions": s["promotions"],
            "readRequests": s["read_requests"],
        }

    def close(self) -> None:
        # lock-free: shutdown path, invoked after the HTTP server stopped
        # serving — single-threaded teardown, no concurrent promote()
        self.stop_following()
        if self._scenario_operator is not None:
            self._scenario_operator.stop()
        if self._controller_manager is not None:
            self._controller_manager.stop()
        if self._scheduler_service is not None:
            self._scheduler_service.stop_background()
        if self._journal is not None:
            self._journal.close()
