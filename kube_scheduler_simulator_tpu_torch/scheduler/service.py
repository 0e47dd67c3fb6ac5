"""Scheduler service: lifecycle, configuration and the scheduling rounds.

Port of the JAX package's ``scheduler/service.py`` for the batch round as
users run it: ``start_scheduler`` builds one Framework per profile of the
(defaulted) KubeSchedulerConfiguration and wires its result store into the
shared reflector; ``schedule_pending`` drains the queue, running each round
through the port's ``BatchEngine`` on the card when the profile and the
workload are supported (``use_batch="auto"``) and through the sequential
cycle otherwise.  Kernel decisions are replayed in queue order and
committed in waves of ``commit_wave`` pods; on the card a round with more
pods than that runs ``BatchEngine.schedule_waves``, so the host commits
window k while the card scans window k+1.

A kernel-failed pod under upstream's PostFilter, DefaultPreemption, stays
on the batch round: at a kernel run's first failure the service builds the
victim-search tables of preemption/ (``prepare_round``), and each replay
window makes ONE victim-search dispatch for all of its failed pods (the
CUDA kernel ``csrc/preempt.cu`` on the card, its plain version on the CPU);
the decision commits from the kernel trace, its victims are evicted in one
bulk store update, and a nomination restarts the kernel on the tail.  Pods
and rounds outside the search's exactness envelope (a preemptor with host
ports, volumes, required spread or pod (anti-)affinity; a cluster with
required anti-affinity; another PostFilter) take the exact sequential
cycle, counted by reason in ``stats["preempt_fallbacks"]``.

A profile whose permit point is exactly the Coscheduling gang oracle (the
gang profile, ``gang.gang_scheduler_config()``) stays on the batch round
too: the round's gang context (gang/engine.py) parks each kernel-placed
member at Permit, the member completing its group's quorum commits the
whole gang in one transaction, and each replay window makes ONE gang-verdict
dispatch (K6, csrc/gang.cu on the card) whose answer is checked against
host arithmetic (``stats["gang_verdict_mismatch"]`` stays 0).  Gate
failures, ``KSS_GANG_BATCH=0`` and any other permit plugin take the
sequential round, counted by reason.  Parked pods hold their reservations
(the snapshot and the encoder see them on their nodes) until released,
rejected or expired (``process_waiting_pods``).

A round whose resource values would go inexact in float32 runs in float64
on the card (ops/batch.round_dtype), counted by reason in
``stats["f64_promotions"]``.

The capacity engine (autoscaler/) hooks in as the reference's does:
``autoscale`` "on" or "scenario" builds a ``ClusterAutoscaler`` lazily
(``autoscaler``), and ``schedule_pending_autoscaled`` loops drain, one
autoscaler pass, drain, while the autoscaler acts.  Its scale-up estimate
is one launch of the lane scan (K8) on the service's device and dtype.

A plugin-weight override (``weights=``, ``set_plugin_weights``: the
tuner's learned scoring head, tuning/) applies to every profile: the
sequential cycle's weighted sum, the result stores' finalScore rendering
and the batch engines, whose scan takes the vector as its weight argument.
The scale-up estimator keeps its own packing profile.  ``note_tuning_run``
absorbs a ``run_tuning`` report into the ``tuning_*`` counters.

``schedule_stream`` runs the streaming wave pipeline (scheduler/stream.py)
and ``pause_streams`` parks its sessions at a wave boundary; the streamed
waves' counters are ``stats["stream_*"]``.

The lifecycle is the reference's: ``restart_scheduler`` swaps the
configuration and rolls back to the previous one when the new one fails to
build, ``reset_scheduler_configuration`` restarts from the first
configuration started, ``shutdown_scheduler`` stops the loop and drops the
frameworks.  ``start_background`` runs the always-on loop on a thread of its
own: each tick expires permit waits, flushes the queue's stuck pods and runs
one round with backoff respected, and under ``autoscale="on"`` an
autoscaler pass at most every ``autoscale_interval_s`` (idle ticks too, so
scale-down advances).  One deliberate difference: the reference's loop
swallows every exception; the port's stops at its first one, and
``stop_background()`` re-raises it in the caller's thread.  A kernel error
never gets there, since the round degrades it (below): what stops the loop
is a build or load error, a kernel that does not launch, a lost CUDA
context or a fault of the host code, none of which a next tick would cure.  A second: each tick of the port's
loop holds the quiesce gate of ``pause_streams``, so a snapshot load lands
whole before the next round.  ``metrics()`` returns the reference's keys.

The configuration's extender webhooks (scheduler/extender.py) run in the
sequential cycle, as in the reference: a round whose profile has extenders
takes that cycle, counted as ``"extender webhooks configured"``, and the
batched PostFilter declines preempt-verb extenders.  With a write-ahead
journal attached to the store (state/journal.py), the configuration is
journaled at every (re)start, each commit wave, gang release and sequential
attempt is one atomic record, and ``metrics()`` reads the journal's
counters; state/recovery.py rebuilds a crashed store and
``restore_scheduler_state`` re-arms a fresh service from it, and
replication/ promotes a live follower the same way.

A kernel error mid-round (a failing launch, or a window's fetch) degrades
the round as the reference's does (``_degrade_segment``): the windows
committed before it stand, and the round's other pods finish on the exact
sequential cycle, counted in ``batch_fallbacks`` as ``kernel error:
<type>`` and logged.  It never gives way to a kernel's plain version, and
``kernels.degradable`` lets a library build or load error, a kernel
wrapper's own failure (``kernels.KernelLaunchError``: a launch's cudaError,
an argument the kernel refuses), or a CUDA context that no longer answers
a synchronize, propagate.

A mesh shards the node axis: ``mesh="auto"`` (the default) reads
``KSS_MESH_DEVICES`` through ops/mesh.py, whose bad values raise
``MeshConfigError`` as the reference's do; an explicit ``NodeMesh`` may
place several shards on one device.  The batch engine, the victim search
and the scale-up estimate then run over the shards
(``metrics()["shard_devices"]``, ``sharded_dispatches_total``,
``plane_shard_bytes_per_device``); the stream over a mesh is not ported
(ROADMAP 7c) and raises.  The one-card
worker ensemble (``KSS_MESH_PROCESSES``, ops/procmesh.py) serves the
engine's one-launch rounds and streamed waves; ``metrics()["procmesh"]``
reads its counters once the knob has been read.
"""

from __future__ import annotations

import copy
import gc
import logging
import os
import threading
import time
from typing import Any, Callable

import torch

from kube_scheduler_simulator_tpu_torch.config import scheduler_config as sc
from kube_scheduler_simulator_tpu_torch.device import resolve_device
from kube_scheduler_simulator_tpu_torch.gang import prepare_round as gang_prepare
from kube_scheduler_simulator_tpu_torch.models.snapshot import Snapshot, has_pending_nomination
from kube_scheduler_simulator_tpu_torch.models.wrapped import WrappedPlugin, original_name
from kube_scheduler_simulator_tpu_torch.ops import kernels as K
from kube_scheduler_simulator_tpu_torch.ops.mesh import mesh_devices, resolve_mesh
from kube_scheduler_simulator_tpu_torch.ops.profile import WaveProfiler
from kube_scheduler_simulator_tpu_torch.plugins.intree import in_tree_registry
from kube_scheduler_simulator_tpu_torch.plugins.resultstore import SUCCESS_MESSAGE, ResultStore
from kube_scheduler_simulator_tpu_torch.plugins.storereflector import RESULT_STORE_KEY, StoreReflector
from kube_scheduler_simulator_tpu_torch.preemption import nomination_gate, prepare_round
from kube_scheduler_simulator_tpu_torch.resilience import retry_stats
from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine
from kube_scheduler_simulator_tpu_torch.scheduler.framework_runner import (
    Framework,
    FrameworkHandle,
    ScheduleResult,
)
from kube_scheduler_simulator_tpu_torch.scheduler.queue import SchedulingQueue
from kube_scheduler_simulator_tpu_torch.state.store import BULK_DELETE
from kube_scheduler_simulator_tpu_torch.utils.keys import pod_key as _pod_key

logger = logging.getLogger(__name__)
Obj = dict[str, Any]


class SchedulerService:
    def __init__(
        self,
        cluster_store: Any,
        seed: int = 0,
        tie_break: str = "reservoir",
        use_batch: str = "off",
        batch_min_work: int = 2048,
        batch_max_restarts: int = 8,
        clock: "Callable[[], float] | None" = None,
        mesh: Any = "auto",
        commit_wave: int = 256,
        pipeline: "bool | str" = "auto",
        autoscale: str = "off",
        autoscaler_opts: "dict | None" = None,
        autoscale_interval_s: float = 10.0,
        weights: Any = None,
        device: "str | torch.device | None" = None,
        dtype: "torch.dtype | None" = None,
    ):
        """The reference's signature, plus ``device`` (the card unless the
        caller passes "cpu"; a missing card raises) and ``dtype`` (the batch
        engines' working dtype: float32 on the card, float64 on the CPU).

        ``use_batch``: "off" = sequential cycle only; "auto" = whole pending
        rounds through the batch engine when the profile × workload is
        supported; "force" = always batch (kernel failures are recorded
        without preemption).  ``batch_min_work``: in auto mode, rounds with
        pods × nodes below this take the sequential cycle.  ``commit_wave``:
        pods per bulk-commit wave.  ``pipeline``: the double-buffered
        windowed round; "auto" turns it on on the card, and on the CPU
        where the host has at least 4 cores (the reference's rule).
        ``autoscale``: "off" = no capacity engine; "on" = the synchronous
        autoscaled drain (``schedule_pending_autoscaled``), scenario
        replays AND the background loop run autoscaler passes between
        rounds; "scenario" = the synchronous drain and scenario replays
        do, the background loop does not (it behaves as "off").
        ``autoscaler_opts`` forwards to ``ClusterAutoscaler``;
        ``weights``: the plugin-weight override (a vector in the profile's
        score-plugin order or a name → weight mapping), validated at
        ``start_scheduler`` (WeightValidationError), changed live by
        ``set_plugin_weights``; ``autoscale_interval_s`` throttles the
        background loop's autoscaler passes (the synchronous drains are
        never throttled)."""
        if autoscale not in ("off", "on", "scenario"):
            raise ValueError(f"autoscale must be off|on|scenario, got {autoscale!r}")
        self.cluster_store = cluster_store
        self.seed = seed
        self.tie_break = tie_break
        self._clock = clock
        self.use_batch = use_batch
        self.device = resolve_device(device)
        # the node-axis mesh is validated at this boundary (ops/mesh.py: a
        # bad KSS_MESH_DEVICES raises MeshConfigError)
        self.mesh = resolve_mesh(mesh, device=self.device)
        self.dtype = dtype
        self.batch_min_work = batch_min_work
        self.commit_wave = max(int(commit_wave), 1)
        self.pipeline = pipeline
        self._pipeline_resolved: "bool | None" = None if pipeline == "auto" else bool(pipeline)
        # successful preemptions free resources mid-round, forcing a kernel
        # re-run on the remaining tail; past this many re-runs the round
        # finishes on the (equally exact) sequential cycle
        self.batch_max_restarts = batch_max_restarts
        self.reflector = StoreReflector()
        self.reflector.register_to_cluster_store(cluster_store)
        # upstream-shaped scheduling queue (activeQ/backoffQ/unschedulableQ
        # with event-driven requeue), subscribed for the service's lifetime
        self.queue = SchedulingQueue(clock=clock)
        cluster_store.subscribe(["pods", "nodes"], self.queue.note_event)
        self._out_of_tree: dict[str, Callable[[Obj | None, Any], Any]] = {}
        self._profile_names: set[str] = {"default-scheduler"}
        # one Framework per profile, keyed by schedulerName; ``framework``
        # is the default profile's
        self.frameworks: dict[str, Framework] = {}
        self.framework: "Framework | None" = None
        self.result_store: "ResultStore | None" = None
        # the configuration's extender webhooks, shared by every profile
        # (set by start_scheduler)
        self.extender_service: Any = None
        self._result_store_keys: list[str] = []
        # the configuration running, and the first one started (the reset
        # target)
        self._current_cfg: "Obj | None" = None
        self._initial_cfg: "Obj | None" = None
        # the background loop: its thread, stop and wake-up signals, and the
        # first exception of a loop that died (re-raised by stop_background)
        self._bg_thread: "threading.Thread | None" = None
        self._bg_stop = threading.Event()
        self._wakeup = threading.Event()
        self._bg_error: "BaseException | None" = None
        self._bg_unsubscribe: "Callable[[], None] | None" = None
        self._batch_engine: "BatchEngine | None" = None
        self._batch_engines: dict[str, BatchEngine] = {}
        # wait-start move_seq of each pod parked at Permit: events fired
        # while it waits count if the wait ends in failure
        self._wait_move_seq: dict[str, int] = {}
        self.stats: dict[str, Any] = {
            "batch_commits": 0,
            "batch_pods": 0,
            "batch_fallbacks": {},
            "batch_restarts": 0,
            "sequential_pods": 0,
            # host seconds of batch commits and of the pods a batch round
            # routed through the sequential cycle
            "commit_s": 0.0,
            "commit_waves": 0,
            "last_wave_commit_s": 0.0,
            "last_wave_pods": 0,
            # batched PostFilter (preemption/): attempts, nominations and
            # victims committed from the victim search, its dispatches and
            # their host-clock seconds (uploads, search, fetch); pods the
            # search declined run the sequential cycle, counted by reason
            "preempt_attempts": 0,
            "preempt_nominations": 0,
            "preempt_victims": 0,
            "preempt_dispatches": 0,
            "preempt_sharded_dispatches": 0,
            "preempt_kernel_s": 0.0,
            "preempt_fallbacks": {},
            # gang engine (gang/): all-or-nothing PodGroup placement on the
            # batch round; gang_fallbacks counts the rounds that took the
            # sequential Coscheduling oracle instead, by reason;
            # gang_verdict_mismatch (device verdict vs host arithmetic)
            # must stay 0
            "gang_rounds": 0,
            "gang_parked": 0,
            "gang_released_groups": 0,
            "gang_released_pods": 0,
            "gang_kernel_dispatches": 0,
            "gang_kernel_s": 0.0,
            "gang_verdict_mismatch": 0,
            "gang_fallbacks": {},
            # permit waits that expired and were rejected
            "permit_wait_expired": 0,
            # the streaming wave pipeline (scheduler/stream.py): waves
            # committed through it and their pods, host seconds spent while a
            # kernel was in flight (overlap) and blocked on the card (stall),
            # and the exactness gates that drained or serialized the
            # pipeline, by reason
            "stream_waves": 0,
            "stream_pods": 0,
            "stream_overlap_s": 0.0,
            "stream_stall_s": 0.0,
            "stream_drains": {},
            # kernel runs promoted to float64 because their resource values
            # would go inexact in float32, by reason (column and magnitude)
            "f64_promotions": {},
            # the tuner (tuning/): runs absorbed by note_tuning_run, their
            # rollouts (hard objective evaluations) and value-and-grad
            # dispatches, and each objective's last tuned value
            "tuning_runs": 0,
            "tuning_rollouts": 0,
            "tuning_grad_dispatches": 0,
            "tuning_objective": {},
            # host seconds of the sequential tails of rounds degraded by a
            # kernel error (batch_fallbacks "kernel error: <type>")
            "degrade_s": 0.0,
            # the differential fuzzer (fuzz/): scenarios judged through this
            # service, byte divergences by comparison kind (nonzero is a
            # bug), and accepted shrinker reductions (note_fuzz_report)
            "fuzz_scenarios": 0,
            "fuzz_divergences": {},
            "fuzz_shrink_steps": 0,
        }
        # the weight override asked for (at construction or by
        # set_plugin_weights), resolved and validated when frameworks exist
        self._weights_requested = weights
        self._weights_override: "dict[str, float] | None" = None
        self._last_tuning_report: "Obj | None" = None
        self._stats_lock = threading.Lock()
        # stream quiesce machinery (pause_streams): an exclusive store
        # operation drains every active StreamSession to a wave boundary
        # (counted per reason) and holds it parked until the operation ends
        self._stream_cv = threading.Condition()
        self._stream_busy = 0
        self._stream_pause_reason: "str | None" = None
        self._pause_mu = threading.Lock()
        # one per-wave stage profiler shared by every profile engine and the
        # commit path; the store stamps its mutations against it too
        self.profiler = WaveProfiler()
        self.cluster_store.profiler = self.profiler
        # capacity engine (autoscaler/): built lazily on first use, so
        # autoscale="off" services never import the package
        self.autoscale = autoscale
        self._autoscaler_opts = dict(autoscaler_opts or {})
        self._autoscaler: Any = None
        self._autoscaler_build_lock = threading.Lock()
        self.autoscale_interval_s = float(autoscale_interval_s)
        self._last_autoscale_ts = float("-inf")

    # ----------------------------------------------------------- autoscaler

    @property
    def autoscaler(self) -> Any:
        """The capacity engine (None when ``autoscale="off"``)."""
        if self._autoscaler is None and self.autoscale != "off":
            from kube_scheduler_simulator_tpu_torch.autoscaler import ClusterAutoscaler

            with self._autoscaler_build_lock:
                if self._autoscaler is None:
                    self._autoscaler = ClusterAutoscaler(self.cluster_store, self, **self._autoscaler_opts)
        return self._autoscaler

    @autoscaler.setter
    def autoscaler(self, value: Any) -> None:
        self._autoscaler = value
        if value is not None and self.autoscale == "off":
            self.autoscale = "on"

    def scenario_autoscaler(self) -> Any:
        """The autoscaler a scenario replay should drive (None unless the
        knob enables it for scenarios — "on" or "scenario")."""
        return self.autoscaler if self.autoscale in ("on", "scenario") else None

    def schedule_pending_autoscaled(
        self,
        max_rounds: int = 3,
        respect_backoff: bool = False,
        max_passes: int = 8,
    ) -> dict[str, ScheduleResult]:
        """The converged autoscale→schedule→autoscale loop: drain the queue,
        run one autoscaler pass, and repeat while the autoscaler keeps
        acting (its node adds and drains re-activate pods through the
        queue's move machinery).  With ``autoscale="off"`` this IS
        ``schedule_pending``."""
        results: dict[str, ScheduleResult] = {}
        for _ in range(max(max_passes, 1)):
            results.update(self.schedule_pending(max_rounds=max_rounds, respect_backoff=respect_backoff))
            asc = self.autoscaler
            if asc is None or not asc.run_once()["actions"]:
                break
        return results

    # ----------------------------------------------------------- extension

    def set_out_of_tree_registries(self, registry: dict[str, Callable[[Obj | None, Any], Any]]) -> None:
        self._out_of_tree.update(registry)

    # ------------------------------------------------------------ lifecycle

    def start_scheduler(self, cfg: "Obj | None" = None) -> None:
        """Build one Framework per profile of the configuration, keyed by
        schedulerName, all sharing one ExtenderService (scheduler/extender.py)
        for the configuration's extender webhooks.  With a journal attached
        the configuration is journaled as a ``config`` record."""
        from kube_scheduler_simulator_tpu_torch.scheduler.extender import ExtenderService

        cfg = self._filter_allowed_changes(cfg)
        profiles = cfg.get("profiles") or [{}]
        names = [p.get("schedulerName") or "default-scheduler" for p in profiles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicated profile schedulerName in {names}")
        # drop the previous build's stores before registering new ones
        for key in self._result_store_keys:
            self.reflector.remove_result_store(key)
        self._result_store_keys = []
        extender_service = ExtenderService(cfg.get("extenders"), self.reflector)
        frameworks: dict[str, Framework] = {}
        for idx, (name, profile) in enumerate(zip(names, profiles)):
            store_key = RESULT_STORE_KEY if idx == 0 else f"{RESULT_STORE_KEY}/{name}"
            fw = self._build_framework(cfg, profile, store_key)
            fw.extender_service = extender_service
            self._result_store_keys.append(store_key)
            frameworks[name] = fw
        self._profile_names = set(names)
        self.frameworks = frameworks
        self.framework = frameworks.get("default-scheduler") or frameworks[names[0]]
        # parked waiting pods do not survive a framework rebuild, nor do
        # their wait-start marks
        self._wait_move_seq.clear()
        self.result_store = self.framework.result_store
        self.extender_service = extender_service
        self._batch_engine = None  # rebuilt lazily for the new profiles
        self._batch_engines = {}
        # re-apply a requested weight override onto the fresh frameworks
        self._weights_override = None
        if self._weights_requested is not None:
            self.set_plugin_weights(self._weights_requested)
        self._current_cfg = cfg
        if getattr(self.cluster_store, "journal", None) is not None:
            # the active configuration is process state the journal carries:
            # recovery restarts from the LAST journaled config
            self.cluster_store.journal_append("config", {"config": cfg})
        # a scheduler (re)build is a scheduling-relevant event
        self.queue.move_all()
        if self._initial_cfg is None:
            self._initial_cfg = copy.deepcopy(cfg)

    def restart_scheduler(self, cfg: "Obj | None") -> None:
        """Swap the configuration; when the new one fails to build, the
        previous one is started again and the error raised."""
        old = self._current_cfg
        try:
            self.start_scheduler(cfg)
        except Exception:
            if old is not None:
                self.start_scheduler(old)
            raise

    def reset_scheduler_configuration(self) -> None:
        """Restart from the first configuration this service started."""
        self.restart_scheduler(copy.deepcopy(self._initial_cfg))

    def shutdown_scheduler(self) -> None:
        """Stop the background loop (re-raising its error, if it died of
        one) and drop the frameworks."""
        try:
            self.stop_background()
        finally:
            self.framework = None
            self.frameworks = {}

    def get_scheduler_config(self) -> Obj:
        assert self._current_cfg is not None, "scheduler not started"
        return copy.deepcopy(self._current_cfg)

    # ------------------------------------------------------- weight override

    def score_plugin_names(self, profile: "str | None" = None) -> list[str]:
        """The score plugins of a profile (default profile when None), in
        profile order — the arity a weight vector must match."""
        fw = self.frameworks.get(profile) if profile else self.framework
        assert fw is not None, "scheduler not started"
        return [wp.original.name for wp in fw.plugins["score"]]

    def set_plugin_weights(self, weights: Any) -> "dict[str, float] | None":
        """Install (or clear, with None) a plugin-weight override across
        every profile: the sequential cycle's weighted sum, the result
        stores' finalScore rendering and the batch engines all pick it up.
        Every profile is validated before any is touched
        (WeightValidationError leaves the previous override in place).
        Returns the resolved default-profile mapping."""
        assert self.framework is not None, "scheduler not started"
        if weights is None:
            self._weights_requested = None
            self._weights_override = None
            for fw in self.frameworks.values():
                fw.score_weight_override = None
                fw.result_store.set_weights(fw.score_weights)
        else:
            resolved: "dict[str, float] | None" = None
            for fw, mapping in self.check_plugin_weights(weights):
                fw.score_weight_override = mapping
                fw.result_store.set_weights(mapping)
                if fw is self.framework:
                    resolved = mapping
            self._weights_requested = weights
            self._weights_override = resolved
        # a live engine swaps its weight vector; none is rebuilt
        for name, fw in self.frameworks.items():
            eng = self._batch_engines.get(name)
            if eng is not None:
                eng.set_weight_override(fw.score_weight_override)
        return self._weights_override

    def check_plugin_weights(self, weights: Any) -> "list[tuple[Any, dict[str, float]]]":
        """Validate a weight vector against EVERY profile without applying
        it: (framework, resolved name → weight mapping) per profile;
        WeightValidationError names the offending profile."""
        from kube_scheduler_simulator_tpu_torch.tuning.validate import validate_plugin_weights

        plans = []
        for name, fw in self.frameworks.items():
            names = [wp.original.name for wp in fw.plugins["score"]]
            try:
                vec = validate_plugin_weights(weights, names, defaults=fw.score_weights)
            except Exception as e:
                raise type(e)(f"profile {name}: {e}") from None
            plans.append((fw, dict(zip(names, vec.tolist()))))
        return plans

    def plugin_weights(self) -> "dict[str, float] | None":
        """The active default-profile weight override (None = defaults)."""
        return self._weights_override

    def note_fuzz_report(self, report: Obj) -> None:
        """Absorb one fuzz session's outcome into the service counters
        (``metrics()``' ``fuzz_*`` keys): ``{"scenarios": n, "divergences":
        {kind: n}, "shrink_steps": n}``, the shape ``python -m
        kube_scheduler_simulator_tpu_torch.fuzz`` reports after its sweep."""
        with self._stats_lock:
            self.stats["fuzz_scenarios"] += int(report.get("scenarios", 0))
            fd = dict(self.stats["fuzz_divergences"])
            for kind, n in (report.get("divergences") or {}).items():
                fd[kind] = fd.get(kind, 0) + int(n)
            self.stats["fuzz_divergences"] = fd
            self.stats["fuzz_shrink_steps"] += int(report.get("shrink_steps", 0))

    def note_tuning_run(self, session: Any, report: Obj) -> None:
        """Absorb one tuning run's dispatch counts and outcome into the
        ``tuning_*`` counters."""
        with self._stats_lock:
            self.stats["tuning_runs"] += 1
            self.stats["tuning_rollouts"] += int(getattr(session, "rollouts", 0))
            self.stats["tuning_grad_dispatches"] += int(getattr(session, "grad_dispatches", 0))
            self.stats["tuning_objective"] = {
                **self.stats["tuning_objective"],
                report["objective"]: float(report["tunedObjective"]),
            }
        self._last_tuning_report = report

    def schedule_stream(
        self,
        feed: "Callable[[int], bool] | None" = None,
        duration_s: "float | None" = None,
        max_waves: "int | None" = None,
        wave_pods: "int | None" = None,
        streaming: "bool | None" = None,
        idle_sleep_s: float = 0.002,
    ) -> dict[str, ScheduleResult]:
        """Continuous streaming drain (scheduler/stream.py): a wave pipeline
        where wave k+1's encode/upload/launch overlaps wave k's in-flight
        kernel and host commit, fed by an admission queue drained fresh
        every wave.  Commit order and bytes are the serial path's;
        out-of-envelope waves (gang, nominations, preemption, node/config
        changes, unsupported workloads) drain to ``schedule_pending``,
        counted in ``stats["stream_drains"]``.  ``streaming=None`` resolves
        the ``KSS_STREAM_PIPELINE`` knob (default on); False keeps the same
        admission loop strictly serial.  A kernel error drains the dying
        wave (nothing of it committed) to the sequential path, counted as
        ``kernel error: <type>``."""
        from kube_scheduler_simulator_tpu_torch.scheduler.stream import StreamSession

        return StreamSession(
            self,
            feed=feed,
            duration_s=duration_s,
            max_waves=max_waves,
            wave_pods=wave_pods,
            streaming=streaming,
            idle_sleep_s=idle_sleep_s,
        ).run()

    def pause_streams(self, reason: str):
        """Context manager: quiesce every active StreamSession before an
        exclusive store operation (a wholesale store reset must never
        interleave with an in-flight wave commit).  Each parked session
        counts ONE drain under ``reason`` in ``stats["stream_drains"]``;
        with no session active this is free.  Pausers queue on
        ``_pause_mu``.

        The quiesce wait is BOUNDED (a session stuck inside a feed callback
        can never park), but a fallthrough is never silent: it logs and
        counts ``stream_drains["pause timeout"]``."""
        import contextlib
        import logging

        @contextlib.contextmanager
        def _pause():
            with self._pause_mu:
                with self._stream_cv:
                    self._stream_pause_reason = reason
                    quiesced = self._stream_cv.wait_for(lambda: self._stream_busy == 0, timeout=60.0)
                if not quiesced:
                    logging.getLogger(__name__).warning(
                        "pause_streams(%r): %d stream session(s) failed to park within 60s; "
                        "proceeding WITHOUT exclusivity",
                        reason,
                        self._stream_busy,
                    )
                    with self._stats_lock:
                        d = self.stats["stream_drains"]
                        d["pause timeout"] = d.get("pause timeout", 0) + 1
                try:
                    yield
                finally:
                    with self._stream_cv:
                        self._stream_pause_reason = None
                        self._stream_cv.notify_all()

        return _pause()

    # -------------------------------------------------------------- builder

    def _filter_allowed_changes(self, cfg: "Obj | None") -> Obj:
        """Only .profiles, .extenders and .percentageOfNodesToScore of user
        configs are honored."""
        base = sc.default_scheduler_config()
        if cfg is None:
            return base
        if cfg.get("profiles"):
            base["profiles"] = copy.deepcopy(cfg["profiles"])
        if cfg.get("extenders"):
            base["extenders"] = copy.deepcopy(cfg["extenders"])
        if cfg.get("percentageOfNodesToScore") is not None:
            base["percentageOfNodesToScore"] = cfg["percentageOfNodesToScore"]
        return base

    def framework_for(self, pod: Obj) -> Framework:
        """The Framework owning ``pod`` by its spec.schedulerName."""
        name = (pod.get("spec") or {}).get("schedulerName") or "default-scheduler"
        fw = self.frameworks.get(name)
        if fw is None:
            fw = self.framework
        assert fw is not None, "scheduler not started"
        return fw

    def _all_waiting_keys(self) -> set[str]:
        keys: set[str] = set()
        for fw in self.frameworks.values():
            keys.update(fw.waiting_pods)
        return keys

    def _sync_rotation(self, src: Framework) -> None:
        """Upstream keeps ONE rotating start index and attempt counter per
        scheduler process, shared by all profiles: mirror the source
        framework's onto the rest after it schedules."""
        for fw in self.frameworks.values():
            if fw is not src:
                fw.next_start_node_index = src.next_start_node_index
                fw.sched_counter = src.sched_counter

    def _build_framework(self, cfg: Obj, profile: "Obj | None" = None, store_key: str = RESULT_STORE_KEY) -> Framework:
        if profile is None:
            profile = (cfg.get("profiles") or [{}])[0]
        registry = in_tree_registry()
        registry.update(self._out_of_tree)
        for point_set in (profile.get("plugins") or {}).values():
            if not isinstance(point_set, dict):
                continue
            for p in point_set.get("enabled") or []:
                name = original_name(p.get("name", ""))
                if name and name != "*" and name not in registry:
                    raise KeyError(f"registry for {name} is not found")
        args_by_name = sc.plugin_args_by_name(profile)
        handle = FrameworkHandle(cluster_store=self.cluster_store)
        instances: dict[str, Any] = {}

        def instance(name: str) -> Any:
            name = original_name(name)
            if name not in instances:
                if name not in registry:
                    raise KeyError(f"registry for {name} is not found")
                instances[name] = registry[name](args_by_name.get(name), handle)
            return instances[name]

        capabilities: dict[str, set[str]] = {}
        all_names = set(registry.keys())
        for p in (profile.get("plugins") or {}).get("multiPoint", {}).get("enabled") or []:
            all_names.add(original_name(p["name"]))
        for name in all_names:
            try:
                inst = instance(name)
            except KeyError:
                continue
            capabilities[name] = {point for point, method in sc.POINT_METHODS.items() if hasattr(inst, method)}
        norm_profile = copy.deepcopy(profile)
        _normalize_names(norm_profile)
        per_point = sc.effective_plugins(norm_profile, capabilities)
        # weights from the effective (merged) score set; zero weight → 1
        score_weights = {original_name(p["name"]): int(p.get("weight") or 0) or 1 for p in per_point["score"]}
        result_store = ResultStore(score_plugin_weight=score_weights)
        self.reflector.add_result_store(result_store, store_key)
        wrapped_cache: dict[str, WrappedPlugin] = {}

        def wrapped(name: str) -> WrappedPlugin:
            name = original_name(name)
            if name not in wrapped_cache:
                orig = instance(name)
                wrapped_cache[name] = WrappedPlugin(result_store, orig, None)
            return wrapped_cache[name]

        plugins = {
            point: [wrapped(p["name"]) for p in per_point[key]]
            for point, key in (
                ("queue_sort", "queueSort"), ("pre_filter", "preFilter"), ("filter", "filter"),
                ("post_filter", "postFilter"), ("pre_score", "preScore"), ("score", "score"),
                ("reserve", "reserve"), ("permit", "permit"), ("pre_bind", "preBind"),
                ("bind", "bind"), ("post_bind", "postBind"),
            )
        }
        fw = Framework(
            plugins,
            handle,
            score_weights=score_weights,
            percentage_of_nodes_to_score=int(cfg.get("percentageOfNodesToScore") or 0),
            seed=self.seed,
            profile_name=profile.get("schedulerName") or "default-scheduler",
            tie_break=self.tie_break,
            clock=self._clock,
        )
        fw.result_store = result_store
        return fw

    # ------------------------------------------------------------- run loop

    def pending_pods(self) -> list[Obj]:
        """Unbound, undeleted pods of a declared profile that are not parked
        at Permit."""
        waiting = self._all_waiting_keys()
        profiles = self._profile_names or {"default-scheduler"}
        return [
            p
            for p in self.cluster_store.list("pods", copy_objects=False)
            if not (p.get("spec") or {}).get("nodeName")
            and not p["metadata"].get("deletionTimestamp")
            and ((p.get("spec") or {}).get("schedulerName") or "default-scheduler") in profiles
            and _pod_key(p) not in waiting
        ]

    def _ready_pending(self, respect_backoff: bool = False) -> list[Obj]:
        """The store-pending pods the queue allows a round to attempt."""
        cands = self.pending_pods()
        q = self.queue
        for p in cands:
            q.ensure_tracked(_pod_key(p))
        ready = q.ready(ignore_backoff=not respect_backoff)
        return [p for p in cands if _pod_key(p) in ready]

    def build_snapshot(self) -> Snapshot:
        t0 = time.perf_counter()
        snap = Snapshot(
            self.cluster_store.list("nodes", copy_objects=False),
            self.cluster_store.list("pods", copy_objects=False),
            self.cluster_store.list("namespaces", copy_objects=False),
        )
        # pods parked at Permit hold their reservation (upstream keeps
        # assumed pods in the scheduler cache until bound)
        for fw in self.frameworks.values():
            for w in fw.waiting_pods.values():
                snap.assume(w.pod, w.node_name)
        self.profiler.ambient("snapshot_rv", time.perf_counter() - t0)
        return snap

    def _pods_with_waiting_assumed(self) -> list[Obj]:
        """Store pods with waiting pods shown as bound to their reserved
        node (the batch encoder's node-usage seeding)."""
        pods = self.cluster_store.list("pods", copy_objects=False)
        waiting: dict[str, Any] = {}
        for fw in self.frameworks.values():
            waiting.update(fw.waiting_pods)
        if not waiting:
            return pods
        out = []
        for p in pods:
            w = waiting.get(_pod_key(p))
            if w is not None:
                out.append({**p, "spec": {**(p.get("spec") or {}), "nodeName": w.node_name}})
            else:
                out.append(p)
        return out

    def schedule_pending(self, max_rounds: int = 3, respect_backoff: bool = False) -> dict[str, ScheduleResult]:
        """Drain the pending queue: sort by QueueSort and schedule each pod
        in order, a round at a time (batch rounds when ``use_batch`` allows,
        with outcomes identical to the sequential cycle's)."""
        assert self.framework is not None, "scheduler not started"
        results: dict[str, ScheduleResult] = {}
        # big rounds allocate millions of short-lived strings next to a store
        # holding millions of live ones: generational GC scans cost seconds
        # per round for nothing (refcounting frees the garbage)
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            # a parked pod whose permit deadline passed releases its
            # reservation before this drain
            self.process_waiting_pods()
            for _ in range(max_rounds):
                round_results: "dict[str, ScheduleResult] | None" = None
                if self.use_batch in ("auto", "force"):
                    round_results = self._schedule_pending_batch(respect_backoff)
                if round_results is None:
                    pending = self.framework.sort_pods(self._ready_pending(respect_backoff))
                    if not pending:
                        break
                    snapshot = self.build_snapshot()
                    round_results = {}
                    for pod in pending:
                        round_results[_pod_key(pod)] = self.schedule_one(pod, snapshot)
                if not round_results:
                    break
                results.update(round_results)
                if not any(r.success or r.nominated_node or r.waiting_on for r in round_results.values()):
                    break
        finally:
            if gc_was_enabled:
                gc.enable()
        return results

    # ------------------------------------------------------- waiting pods

    def allow_waiting_pod(self, namespace: str, name: str, plugin: str) -> "ScheduleResult | None":
        """Approve a waiting pod on ``plugin``'s behalf; when that was the
        last pending permit plugin, the bind cycle runs and the full result
        set (the recorded Wait included) flushes to annotations."""
        assert self.framework is not None, "scheduler not started"
        for fw in self.frameworks.values():
            with self.cluster_store.journal_txn("attempt"):
                res = fw.allow_waiting_pod(namespace, name, plugin)
                if res is not None:
                    self._drain_resolved_waiting()
                    self.reflector.flush_all(self.cluster_store, skip_keys=self._all_waiting_keys())
                    return res
        return None

    def reject_waiting_pod(self, namespace: str, name: str, message: str = "rejected") -> "ScheduleResult | None":
        assert self.framework is not None, "scheduler not started"
        for fw in self.frameworks.values():
            with self.cluster_store.journal_txn("attempt"):
                res = fw.reject_waiting_pod(namespace, name, message)
                if res is not None:
                    self._drain_resolved_waiting()
                    self.reflector.flush_all(self.cluster_store, skip_keys=self._all_waiting_keys())
                    return res
        return None

    def process_waiting_pods(self, now: "float | None" = None) -> dict[str, ScheduleResult]:
        """Expire waiting pods whose permit deadline passed, recording the
        rejection like any scheduling failure.  Cascades an expiry's
        unreserve triggers (a gang member's timeout rejecting its whole
        group) resolve more pods than the expiry set; the drain records
        them all."""
        expired: dict[str, ScheduleResult] = {}
        with self.cluster_store.journal_txn("attempt"):
            for fw in self.frameworks.values():
                if fw.waiting_pods:
                    expired.update(fw.expire_waiting_pods(now))
            if expired:
                with self._stats_lock:
                    self.stats["permit_wait_expired"] += len(expired)
            if self._drain_resolved_waiting():
                self.reflector.flush_all(self.cluster_store, skip_keys=self._all_waiting_keys())
        return expired

    def _drain_resolved_waiting(self) -> int:
        """Record every waiting-pod resolution the frameworks collected
        since the last drain (service calls and plugin cascades): pop the
        wait-start move_seq, record failures like any scheduling failure
        (a successful resolution needs no record).  Returns the number
        drained (callers flush the reflector when nonzero)."""
        drained = 0
        for fw in self.frameworks.values():
            if not fw.resolved_waiting:
                continue
            resolved, fw.resolved_waiting = fw.resolved_waiting, []
            for pod, res in resolved:
                drained += 1
                seq = self._wait_move_seq.pop(_pod_key(pod), None)
                if not res.success:
                    self._record_failure(pod, res, seq)
        return drained

    # ------------------------------------------------------------ batch path

    def _engine_for(self, fw: Framework) -> BatchEngine:
        """The (lazily built) batch engine of a profile, on the service's
        device."""
        eng = self._batch_engines.get(fw.profile_name)
        if eng is None:
            eng = BatchEngine.from_framework(fw, trace=True, device=self.device, dtype=self.dtype, mesh=self.mesh)
            eng.profiler = self.profiler
            self._batch_engines[fw.profile_name] = eng
            if fw is self.framework:
                self._batch_engine = eng
        return eng

    def _schedule_pending_batch(self, respect_backoff: bool = False) -> "dict[str, ScheduleResult] | None":
        """One round on the batch engine; None when the whole round must run
        sequentially (nothing committed, so falling back is exact).  Kernel
        decisions are replayed in queue order; multi-profile rounds run as
        segments of same-profile pods, each on its profile's engine, with
        the rotation and attempt counters synced after each."""
        fw0 = self.framework
        assert fw0 is not None
        tq = time.perf_counter()
        pending_all = fw0.sort_pods(self._ready_pending(respect_backoff))
        self.profiler.ambient("queue_maint", time.perf_counter() - tq)
        if not pending_all:
            return {}
        nodes = self.cluster_store.list("nodes", copy_objects=False)
        if self.use_batch == "auto" and len(pending_all) * max(len(nodes), 1) < self.batch_min_work:
            self._count_fallback("below batch_min_work")
            return None
        # pending nominations store-wide: a nominee in the round is only
        # modeled by the sequential cycle; one outside it is filter-only
        # usage on its node when the gate holds
        noms = self._pending_nominations()
        if noms:
            pending_keys = {_pod_key(p) for p in pending_all}
            if any(_pod_key(p) in pending_keys for p, _nn in noms):
                self._count_fallback("nominated pods present (preemption in flight)")
                return None
            reason = nomination_gate(noms, pending_all)
            if reason is not None:
                self._count_fallback(f"nominations not batchable: {reason}")
                return None
        segments: list[tuple[Framework, list[Obj]]] = []
        for pod in pending_all:
            fw = self.framework_for(pod)
            if segments and segments[-1][0] is fw:
                segments[-1][1].append(pod)
            else:
                segments.append((fw, [pod]))
        results: dict[str, ScheduleResult] = {}
        any_batched = False
        for fw, pending in segments:
            eng = self._engine_for(fw)
            volumes = eng._volumes()
            ok, why = eng.supported(pending, nodes, volumes=volumes)
            if ok and len(segments) > 1 and self.use_batch == "auto" and (
                len(pending) * max(len(nodes), 1) < self.batch_min_work
            ):
                ok, why = False, "segment below batch_min_work"
            gang_ctx = None
            if ok and fw.plugins["permit"]:
                # a permit-bearing profile passes supported() only when its
                # permit point is exactly the Coscheduling oracle: the gang
                # context replays its decisions; gate failures (quorum,
                # missing group, KSS_GANG_BATCH=0) take the sequential oracle
                gang_ctx, gang_why = gang_prepare(self, fw, eng, pending, nodes)
                if gang_ctx is None:
                    with self._stats_lock:
                        gf = self.stats["gang_fallbacks"]
                        gf[gang_why] = gf.get(gang_why, 0) + 1
                    ok, why = False, f"gang: {gang_why}"
            if not ok:
                if len(segments) == 1:
                    self._count_fallback(why)
                    return None
                self._count_fallback(f"{why} [profile {fw.profile_name}]")
                snapshot = self.build_snapshot()
                tc = time.perf_counter()
                for pod in pending:
                    results[_pod_key(pod)] = self.schedule_one(pod, snapshot)
                # lock-free: single-writer scalar bumps on the scheduling thread (the
                # multi-key dicts are written under _stats_lock)
                self.stats["commit_s"] += time.perf_counter() - tc
            else:
                if gang_ctx is not None and gang_ctx.engaged:
                    self.stats["gang_rounds"] += 1
                self._run_segment_batch(fw, eng, pending, nodes, volumes, results, noms, gang_ctx)
                any_batched = True
                self._sync_rotation(fw)
        if any_batched:
            self.stats["batch_commits"] += 1
        self.reflector.flush_all(self.cluster_store, skip_keys=self._all_waiting_keys())
        return results

    def _run_segment_batch(
        self,
        fw: Framework,
        eng: BatchEngine,
        pending: list[Obj],
        nodes: list[Obj],
        volumes: "dict[str, list[Obj]]",
        results: dict,
        nominated: "list[tuple[Obj, str]] | None" = None,
        gang_ctx: Any = None,
    ) -> None:
        seq_failures = bool(fw.plugins["post_filter"]) and self.use_batch != "force"
        point_names = {
            p: [wp.original.name for wp in fw.plugins[p]]
            for p in ("pre_filter", "pre_score", "reserve", "permit", "pre_bind", "bind")
        }
        i = 0  # index of the tail's first pod within `pending`
        restarts = 0
        # round-start nominations only: the sequential cycle's snapshot
        # freezes its nominated map at round build
        noms = list(nominated or [])
        while i < len(pending):
            tail = pending[i:]
            args = (
                nodes,
                self._pods_with_waiting_assumed(),
                tail,
                self.cluster_store.list("namespaces", copy_objects=False),
            )
            kw = dict(
                base_counter=fw.sched_counter,
                start_index=fw.next_start_node_index,
                volumes=volumes,
                nominated=noms or None,
            )
            # the unpipelined round's launch and fetch run in this try;
            # ``schedule_waves`` is a generator, so the pipelined round's
            # encode and launches run at ``next()`` below and its try
            # catches them: here only a fault raised at the call itself
            # (fuzz/chaos.py's engine proxy ticks there).  Either way
            # nothing is committed yet
            try:
                if self._pipeline_on() and len(tail) > self.commit_wave:
                    # pipelined round: window k+1 runs on the card while the
                    # host commits window k
                    windows = iter(eng.schedule_waves(*args, **kw, wave_pods=max(self.commit_wave, 256)))
                else:
                    windows = iter([(eng.schedule(*args, **kw), 0, len(tail))])
            except Exception as e:
                if not K.degradable(e, self.device, "round"):
                    raise
                self._degrade_segment(fw, tail, results, noms, e)
                return
            snapshot = None
            restart_at = None
            # batched-PostFilter context, built lazily at the run's first
            # kernel failure (its victim tables read the snapshot at build
            # time, so earlier windows' commits are already accounted)
            pholder: "dict | None" = None
            if seq_failures:
                pholder = {"build": lambda: self._prepare_preemption(fw, eng, snapshot, nodes, tail, noms)}
            while True:
                try:
                    result, off, cnt = next(windows)
                except StopIteration:
                    break
                except Exception as e:
                    # a window's encode, launch or fetch failed (the first
                    # window's too, when pipelined): every window committed
                    # so far is the sequential cycle's prefix, and nothing of
                    # this window or any after it is committed, so the tail
                    # finishes on the sequential cycle
                    if not K.degradable(e, self.device, "round"):
                        raise
                    self._flush_pctx_stats(pholder)
                    self._degrade_segment(fw, tail, results, noms, e)
                    return
                if snapshot is None:
                    # after the round's encode captured the cluster state
                    snapshot = self.build_snapshot()
                    self._prune_mid_round_nominations(snapshot, noms)
                    if eng.last_promotion is not None:
                        self._count_promotion(eng.last_promotion)
                restart_at = self._replay_window(
                    result, i, off, cnt, snapshot, point_names, fw, seq_failures, results, pholder, gang_ctx
                )
                if restart_at is not None:
                    break  # abandon the remaining windows (state changed)
                fw.next_start_node_index = result.final_start
            self._flush_pctx_stats(pholder)
            pctx = (pholder or {}).get("ctx")
            if restart_at is None:
                break
            i = restart_at
            restarts += 1
            if i >= len(pending):
                break
            # lock-free: single-writer scalar bumps on the scheduling thread (the
            # multi-key dicts are written under _stats_lock)
            self.stats["batch_restarts"] += 1
            if pctx is None and restarts >= self.batch_max_restarts:
                # a preemption-heavy round whose PostFilter runs on the
                # sequential path (the batched search declined the round):
                # finish it on the exact sequential cycle.  With the batched
                # search active every restart strictly advances ``i``
                snapshot = self.build_snapshot()
                self._prune_mid_round_nominations(snapshot, noms)
                for pod in pending[i:]:
                    results[_pod_key(pod)] = self.schedule_one(pod, snapshot)
                break

    def _degrade_segment(
        self,
        fw: Framework,
        pods: list[Obj],
        results: dict,
        noms: "list[tuple[Obj, str]]",
        err: Exception,
    ) -> None:
        """A kernel error mid-round (a failing launch or window fetch on the
        card, or one injected by fuzz/chaos.py): the failing window
        committed nothing and every window before it is the sequential
        cycle's prefix, so the round's uncommitted pods finish on the exact
        sequential cycle.  Counted in ``batch_fallbacks`` as ``kernel error:
        <type>`` and logged every time; its seconds land in ``degrade_s``
        (and ``commit_s``, as the reference counts them).  Only errors that
        ``kernels.degradable`` passes get here: a build or load error, a
        wrapper's own launch failure, or a lost CUDA context, propagates."""
        self._count_fallback(f"kernel error: {type(err).__name__}")
        logger.error("batch round degraded to the sequential cycle (%d pods): %r", len(pods), err, exc_info=err)
        snapshot = self.build_snapshot()
        self._prune_mid_round_nominations(snapshot, noms)
        tc = time.perf_counter()
        for pod in pods:
            if _pod_key(pod) in results:
                continue  # committed (or parked at Permit) before the error
            results[_pod_key(pod)] = self.schedule_one(pod, snapshot)
        dt = time.perf_counter() - tc
        # lock-free: single-writer scalar bumps on the scheduling thread (the
        # multi-key dicts are written under _stats_lock)
        self.stats["commit_s"] += dt
        self.stats["degrade_s"] += dt

    def _pipeline_on(self) -> bool:
        """Resolve ``pipeline="auto"`` once: on on the card, where the scan
        runs while the host commits; on the CPU only with at least 4 cores
        (the reference's rule: the plain scan and the commit share them)."""
        if self._pipeline_resolved is None:
            self._pipeline_resolved = self.device.type == "cuda" or (os.cpu_count() or 1) >= 4
        return self._pipeline_resolved

    def _replay_window(
        self,
        result: Any,
        base_i: int,
        off: int,
        cnt: int,
        snapshot: Snapshot,
        point_names: dict[str, list[str]],
        fw: Framework,
        seq_failures: bool,
        results: dict,
        pholder: "dict | None" = None,
        gang_ctx: Any = None,
    ) -> "int | None":
        """Replay one kernel window's decisions in queue order: successes
        accumulate into bulk-commit waves; gang members park or release
        their whole gang through the gang context; kernel failures commit
        from the trace, with their PostFilter resolved by the batched victim
        search (preemption/) or, outside its envelope, by the exact
        sequential cycle (force mode records the failure alone).  Returns
        the pending index to restart the kernel from after a successful
        preemption, else None."""
        window = result.pending
        sample_start = result.out["sample_start"]
        if gang_ctx is not None:
            # ONE gang-verdict dispatch per replay window, for every group
            gang_ctx.note_window(result, cnt)
        wave_js: list[int] = []
        decisions: dict = {}
        if seq_failures and pholder is not None and any(int(result.selected[j]) < 0 for j in range(cnt)):
            # ONE victim-search dispatch covers every kernel failure of this
            # window (the context is built at first use)
            if "ctx" not in pholder:
                pholder["ctx"] = pholder["build"]()
            if pholder["ctx"] is not None:
                decisions = pholder["ctx"].decide(result, off, cnt)

        def flush_wave() -> None:
            if not wave_js:
                return
            tc = time.perf_counter()
            with self.cluster_store.journal_txn("wave"):
                self._commit_batch_wave(result, wave_js, window, snapshot, point_names, fw, results)
                fw.sched_counter += len(wave_js)
                nj = wave_js[-1] + 1
                fw.next_start_node_index = int(sample_start[nj]) if nj < cnt else result.final_start
            dt = time.perf_counter() - tc
            # lock-free: single-writer scalar bumps on the scheduling thread (the
            # multi-key dicts are written under _stats_lock)
            self.stats["commit_s"] += dt
            self.stats["commit_waves"] += 1
            self.stats["last_wave_commit_s"] = dt
            self.stats["last_wave_pods"] = len(wave_js)
            self.stats["batch_pods"] += len(wave_js)
            wave_js.clear()

        for j in range(cnt):
            pod = window[j]
            key = _pod_key(pod)
            if int(result.selected[j]) >= 0:
                gk = gang_ctx.group_of(pod) if gang_ctx is not None else None
                if gk is not None:
                    # gang member: park at Permit, or release the whole gang
                    # when it completes the quorum; earlier commits flush
                    # first so the store matches the oracle's at this pod
                    flush_wave()
                    node_name = result.node_names[int(result.selected[j])]
                    tc = time.perf_counter()
                    if gang_ctx.completes(gk):
                        res = gang_ctx.commit_release(result, j, pod, node_name, snapshot, point_names)
                    else:
                        res = gang_ctx.park(result, j, pod, node_name, snapshot, point_names)
                    self.stats["commit_s"] += time.perf_counter() - tc
                    results[key] = res
                    fw.sched_counter += 1
                    self.stats["batch_pods"] += 1
                    continue
                wave_js.append(j)
                if len(wave_js) >= self.commit_wave:
                    flush_wave()
            elif not seq_failures:
                # force mode (or no PostFilter): record the kernel's failure
                flush_wave()
                tc = time.perf_counter()
                results[key] = self._commit_batch_pod(result, j, pod, snapshot, point_names, fw)
                self.stats["commit_s"] += time.perf_counter() - tc
                fw.sched_counter += 1
                self.stats["batch_pods"] += 1
            else:
                dec = decisions.get(j)
                if dec is not None and not isinstance(dec, str):
                    # batched PostFilter: the failure trace commits from the
                    # kernel result and the preemption decision applies
                    # inside the commit
                    flush_wave()
                    tc = time.perf_counter()
                    res = self._commit_batch_pod(result, j, pod, snapshot, point_names, fw, preempt=dec)
                    self.stats["commit_s"] += time.perf_counter() - tc
                    fw.sched_counter += 1
                    self.stats["batch_pods"] += 1
                    results[key] = res
                    if res.nominated_node:
                        # preemption restarts the kernel: this window's
                        # record ends here
                        self.profiler.close(getattr(result, "prof_rec", None))
                        return base_i + off + j + 1
                    continue
                # exact sequential cycle for this pod: same snapshot state
                # (earlier commits assumed), attempt counter and rotation
                if isinstance(dec, str):
                    self._count_preempt_fallback(dec)
                flush_wave()
                fw.next_start_node_index = int(sample_start[j])
                tc = time.perf_counter()
                res = self.schedule_one(pod, snapshot)
                self.stats["commit_s"] += time.perf_counter() - tc
                results[key] = res
                if res.nominated_node:
                    self.profiler.close(getattr(result, "prof_rec", None))
                    return base_i + off + j + 1
        flush_wave()
        # the wave record closes even when nothing committed
        self.profiler.close(getattr(result, "prof_rec", None))
        pctx = (pholder or {}).get("ctx")
        if pctx is not None:
            # later windows' dry runs must see this window's commits
            for j in range(cnt):
                if int(result.selected[j]) >= 0:
                    pctx.note_success(off + j, int(result.selected[j]))
        return None

    def _flush_pctx_stats(self, pholder: "dict | None") -> None:
        pctx = (pholder or {}).get("ctx")
        if pctx is None:
            return
        with self._stats_lock:
            self.stats["preempt_dispatches"] += pctx.dispatches
            self.stats["preempt_sharded_dispatches"] += pctx.sharded_dispatches
            self.stats["preempt_kernel_s"] += pctx.kernel_s

    def _count_fallback(self, reason: str) -> None:
        with self._stats_lock:
            fb = self.stats["batch_fallbacks"]
            fb[reason] = fb.get(reason, 0) + 1

    def _count_preempt_fallback(self, reason: str) -> None:
        with self._stats_lock:
            fb = self.stats["preempt_fallbacks"]
            fb[reason] = fb.get(reason, 0) + 1

    def _count_promotion(self, reason: str) -> None:
        with self._stats_lock:
            pm = self.stats["f64_promotions"]
            pm[reason] = pm.get(reason, 0) + 1

    def _prune_mid_round_nominations(self, snapshot: Snapshot, round_noms: "list[tuple[Obj, str]]") -> None:
        """Restrict a (re)built snapshot's nominated map to the round-start
        nominations, as the sequential cycle's one snapshot per round sees."""
        keep = {(p["metadata"].get("namespace", "default"), p["metadata"]["name"]) for p, _nn in round_noms}
        pruned: dict[str, list[Obj]] = {}
        for nn, lst in snapshot.nominated.items():
            kept = [q for q in lst if (q["metadata"].get("namespace", "default"), q["metadata"]["name"]) in keep]
            if kept:
                pruned[nn] = kept
        snapshot.nominated = pruned

    def _pending_nominations(self) -> "list[tuple[Obj, str]]":
        """Unbound pods carrying a preemption nomination, store-wide."""
        return [
            (p, p["status"]["nominatedNodeName"])
            for p in self.cluster_store.list("pods", copy_objects=False)
            if has_pending_nomination(p)
        ]

    def _prepare_preemption(
        self,
        fw: Framework,
        eng: BatchEngine,
        snapshot: Snapshot,
        nodes: list[Obj],
        tail: list[Obj],
        noms: "list[tuple[Obj, str]]",
    ) -> Any:
        """Build the batched victim-search context for one kernel run, or
        None (with a counted reason): the round then keeps the exact
        sequential PostFilter path."""
        if self._all_waiting_keys():
            self._count_preempt_fallback("waiting pods parked at Permit")
            return None
        pctx, reason = prepare_round(fw, eng, snapshot, self.cluster_store, nodes, tail, nominated=noms or None)
        if pctx is None and reason:
            self._count_preempt_fallback(reason)
        return pctx

    def _apply_preemption_victims(self, decision: Any, snapshot: "Snapshot | None") -> None:
        """Evict one decision's victims in one bulk store update: per-victim
        DELETED events in the oracle's eviction order (each drives the
        queue's move request as a per-victim ``store.delete`` would), then
        the oracle's snapshot mutation so later pods in the round see the
        freed capacity."""
        self.cluster_store.bulk_update(
            "pods",
            [
                (v["metadata"]["name"], v["metadata"].get("namespace", "default"), lambda cur: BULK_DELETE)
                for v in decision.victims
            ],
            allow_delete=True,
        )
        if snapshot is not None:
            ni = snapshot.get(decision.node_name)
            if ni is not None:
                for v in decision.victims:
                    ni.remove_pod(v)
        with self._stats_lock:
            self.stats["preempt_nominations"] += 1
            self.stats["preempt_victims"] += len(decision.victims)

    def _commit_batch_wave(
        self,
        result: Any,
        js: list[int],
        tail: list[Obj],
        snapshot: "Snapshot | None",
        point_names: dict[str, list[str]],
        fw: Framework,
        results: dict,
    ) -> None:
        """Commit a wave of kernel-scheduled pods in bulk: every pod's
        annotation documents, the result store filled under one lock, the
        binds, and one reflector flush of the whole wave.  Byte-identical
        to committing each pod through ``_commit_batch_pod``."""
        rs = fw.result_store
        prof = self.profiler
        prof_rec = getattr(result, "prof_rec", None)
        t_ann = time.perf_counter()
        pf_names = point_names["pre_filter"]
        # per-wave shared category maps, identical for every pod
        pf_status = {pn: SUCCESS_MESSAGE for pn in pf_names}
        pre_score = {pn: SUCCESS_MESSAGE for pn in point_names["pre_score"]}
        reserve = {pn: SUCCESS_MESSAGE for pn in point_names["reserve"]}
        # a gang profile's wrapped Permit records success and "0s" for
        # singleton pods (the Coscheduling oracle returns (None, 0))
        permit = {pn: SUCCESS_MESSAGE for pn in point_names["permit"]}
        permit_to = {pn: "0s" for pn in point_names["permit"]}
        prebind = {pn: SUCCESS_MESSAGE for pn in point_names["pre_bind"]}
        bind = {point_names["bind"][0]: SUCCESS_MESSAGE} if point_names["bind"] else None
        entries: list[tuple[str, str, dict]] = []
        bound: list[tuple[Obj, str, str, str]] = []
        wave_docs = result.materialize_wave(js)
        for j in js:
            pod = tail[j]
            ns = pod["metadata"].get("namespace", "default")
            name = pod["metadata"]["name"]
            node_name = result.node_names[int(result.selected[j])]
            docs = wave_docs.get(j) if wave_docs is not None else None
            cats: dict = {}
            if pf_names:
                cats["preFilterStatus"] = pf_status
                if "NodeAffinity" in pf_names:
                    names = result._engine.prefilter_node_names(pod)
                    if names is not None:
                        cats["preFilterResult"] = {"NodeAffinity": sorted(names)}
            cats["filter"] = docs["filter"] if docs is not None else result.filter_annotation_pair(j)
            if int(result.feasible_count[j]) > 1:
                if pre_score:
                    cats["preScore"] = pre_score
                if docs is not None:
                    score_pair, final_pair = docs["score"], docs["finalScore"]
                else:
                    score_pair, final_pair = result.score_annotations_pairs(j)
                cats["score"] = score_pair
                cats["finalScore"] = final_pair
            if reserve:
                # selected-node is recorded by the wrapped Reserve hooks
                cats["selectedNode"] = node_name
                cats["reserve"] = reserve
            if permit:
                cats["permit"] = permit
                cats["permitTimeout"] = permit_to
            if prebind:
                cats["prebind"] = prebind
            if bind:
                cats["bind"] = bind
            entries.append((ns, name, cats))
            bound.append((pod, ns, name, node_name))
        t_commit = time.perf_counter()
        prof.note(prof_rec, "annotate", t_commit - t_ann)
        rs.profiler = prof
        nested0 = prof.nested(prof_rec)
        prof.current = prof_rec
        try:
            rs.add_wave_results(entries)
            committed: list[tuple[Obj, str, str, str]] = []
            for pod, ns, name, node_name in bound:
                try:
                    self.cluster_store.bind_pod(ns, name, node_name)
                except KeyError:
                    # deleted between the kernel's decision and this commit
                    continue
                if snapshot is not None:
                    snapshot.assume(pod, node_name)
                results[_pod_key(pod)] = ScheduleResult(selected_node=node_name)
                committed.append((pod, ns, name, node_name))
            self.reflector.flush_wave(self.cluster_store, [p for p, *_ in committed])
            for pod, ns, name, node_name in committed:
                self._record_event(pod, "Normal", "Scheduled", f"Successfully assigned {ns}/{name} to {node_name}")
        finally:
            prof.current = None
        prof.note_excl(prof_rec, "commit", time.perf_counter() - t_commit, nested0)
        prof.close(prof_rec, pods=len(js))

    def _commit_batch_pod(
        self,
        result: Any,
        i: int,
        pod: Obj,
        snapshot: "Snapshot | None" = None,
        point_names: "dict[str, list[str]] | None" = None,
        fw: "Framework | None" = None,
        preempt: Any = None,
    ) -> ScheduleResult:
        """Write one pod's batch trace into the result store (the categories
        the wrapped plugins record) and bind it, or record its failure and,
        with ``preempt`` (a preemption/ Decision), its PostFilter outcome;
        with ``snapshot``, assume the bind for later sequential cycles of
        the round."""
        with self.cluster_store.journal_txn("attempt"):
            return self._commit_batch_pod_txn(result, i, pod, snapshot, point_names, fw, preempt)

    def _commit_batch_pod_txn(
        self,
        result: Any,
        i: int,
        pod: Obj,
        snapshot: "Snapshot | None" = None,
        point_names: "dict[str, list[str]] | None" = None,
        fw: "Framework | None" = None,
        preempt: Any = None,
    ) -> ScheduleResult:
        from kube_scheduler_simulator_tpu_torch.models.framework import PreFilterResult, Status

        if fw is None:
            fw = self.framework
        assert fw is not None
        rs = fw.result_store
        # this pod's attempt starts at its commit, as in schedule_one
        attempt_move_seq = self.queue.move_seq
        if point_names is None:
            point_names = {
                p: [wp.original.name for wp in fw.plugins[p]]
                for p in ("pre_filter", "pre_score", "reserve", "permit", "pre_bind", "bind")
            }
        ns = pod["metadata"].get("namespace", "default")
        name = pod["metadata"]["name"]
        sel = int(result.selected[i])
        feasible_count = int(result.feasible_count[i])
        for pn in point_names["pre_filter"]:
            narrowed = None
            if pn == "NodeAffinity":
                names = result._engine.prefilter_node_names(pod)
                if names is not None:
                    narrowed = PreFilterResult(names)
            rs.add_pre_filter_result(ns, name, pn, SUCCESS_MESSAGE, narrowed)
        rs.add_batch_results(ns, name, filter=result.filter_annotation_pair(i))
        if feasible_count > 1:
            for pn in point_names["pre_score"]:
                rs.add_pre_score_result(ns, name, pn, SUCCESS_MESSAGE)
            score_pair, final_pair = result.score_annotations_pairs(i)
            rs.add_batch_results(ns, name, score=score_pair, finalScore=final_pair)
        if sel >= 0:
            node_name = result.node_names[sel]
            if point_names["reserve"]:
                rs.add_selected_node(ns, name, node_name)
            for pn in point_names["reserve"]:
                rs.add_reserve_result(ns, name, pn, SUCCESS_MESSAGE)
            for pn in point_names["permit"]:
                # the gang profile's Coscheduling permit returns (None, 0)
                # for singleton pods: success, "0s" timeout
                rs.add_permit_result(ns, name, pn, SUCCESS_MESSAGE, 0)
            for pn in point_names["pre_bind"]:
                rs.add_pre_bind_result(ns, name, pn, SUCCESS_MESSAGE)
            if point_names["bind"]:
                rs.add_bind_result(ns, name, point_names["bind"][0], SUCCESS_MESSAGE)
            self.cluster_store.bind_pod(ns, name, node_name)
            if snapshot is not None:
                snapshot.assume(pod, node_name)
            self.reflector.flush_pod(self.cluster_store, pod)
            self._record_event(pod, "Normal", "Scheduled", f"Successfully assigned {ns}/{name} to {node_name}")
            return ScheduleResult(selected_node=node_name)
        diagnosis = result.diagnosis(i)
        nominated_node = None
        if preempt is not None:
            # batched PostFilter: victims are deleted before the annotation
            # lands — the oracle's post_filter evicts, then the wrapped
            # recorder writes the nomination over the diagnosis node set
            with self._stats_lock:
                self.stats["preempt_attempts"] += 1
            if preempt.node_name:
                self._apply_preemption_victims(preempt, snapshot)
                nominated_node = preempt.node_name
            plug = fw.plugins["post_filter"][0].original.name
            rs.add_post_filter_result(ns, name, nominated_node or "", plug, sorted(diagnosis.keys()))
        res = ScheduleResult(
            diagnosis=diagnosis,
            status=Status.unschedulable(f"0/{result.problem.N_true} nodes are available"),
            nominated_node=nominated_node,
        )
        self._record_failure(pod, res, attempt_move_seq)
        self.reflector.flush_pod(self.cluster_store, pod)
        return res

    def schedule_one(self, pod: Obj, snapshot: "Snapshot | None" = None) -> ScheduleResult:
        """One pod through the exact sequential cycle."""
        assert self.framework is not None, "scheduler not started"
        if snapshot is None:
            snapshot = self.build_snapshot()
        fw = self.framework_for(pod)
        attempt_move_seq = self.queue.move_seq
        with self.cluster_store.journal_txn("attempt"):
            result = fw.schedule_one(pod, snapshot)
            self._sync_rotation(fw)
            # lock-free: single-writer scalar bumps on the scheduling thread (the
            # multi-key dicts are written under _stats_lock)
            self.stats["sequential_pods"] += 1
            # gang cascades inside the cycle (Coscheduling permit releases,
            # PostFilter rejections) resolve OTHER waiting pods: record
            # their outcomes before the flush
            self._drain_resolved_waiting()
            if result.waiting_on:
                # the attempt continues through the Permit wait
                self._wait_move_seq[_pod_key(pod)] = attempt_move_seq
            elif not result.success:
                self._record_failure(pod, result, attempt_move_seq)
            else:
                ns = pod["metadata"].get("namespace", "default")
                self._record_event(
                    pod, "Normal", "Scheduled",
                    f"Successfully assigned {ns}/{pod['metadata']['name']} to {result.selected_node}",
                )
            # waiting pods keep their results queued until permit resolves
            self.reflector.flush_all(self.cluster_store, skip_keys=self._all_waiting_keys())
        return result

    def _record_event(self, pod: Obj, type_: str, reason: str, message: str) -> None:
        """Record a scheduling Event like upstream's recorder; best-effort,
        as client-go's fire-and-forget recorder."""
        meta = pod["metadata"]
        ns = meta.get("namespace", "default")
        self._event_seq = getattr(self, "_event_seq", 0) + 1
        component = self.framework_for(pod).profile_name
        try:
            self.cluster_store.create(
                "events",
                {
                    "metadata": {"name": f"{meta['name']}.{self._event_seq:x}", "namespace": ns},
                    "involvedObject": {"kind": "Pod", "namespace": ns, "name": meta["name"], "uid": meta.get("uid", "")},
                    "reason": reason,
                    "message": message,
                    "type": type_,
                    "count": 1,
                    "source": {"component": component},
                    "reportingComponent": component,
                },
            )
        except Exception:  # noqa: BLE001 - the recorder is fire-and-forget
            pass

    def _record_failure(self, pod: Obj, result: ScheduleResult, attempt_move_seq: "int | None" = None) -> None:
        """Update pod status like upstream's failure handler: PodScheduled
        condition and, for a new nomination, nominatedNodeName."""
        ns = pod["metadata"].get("namespace", "default")
        name = pod["metadata"]["name"]
        self.queue.on_failure(f"{ns}/{name}", attempt_move_seq)
        message = self._failure_message(result)
        patch: Obj = {
            "status": {
                "phase": "Pending",
                "conditions": [
                    {"type": "PodScheduled", "status": "False", "reason": "Unschedulable", "message": message}
                ],
            }
        }
        if result.nominated_node:
            patch["status"]["nominatedNodeName"] = result.nominated_node
        try:
            # skip no-op patches: an identical failure would wake the queue
            current = self.cluster_store.get("pods", name, ns)
            cur_status = current.get("status") or {}
            if (cur_status.get("conditions") or []) == patch["status"]["conditions"] and (
                result.nominated_node is None or cur_status.get("nominatedNodeName") == result.nominated_node
            ):
                return
            self.cluster_store.patch("pods", name, patch, ns)
            self._record_event(pod, "Warning", "FailedScheduling", message)
        except KeyError:
            pass

    @staticmethod
    def _failure_message(result: ScheduleResult) -> str:
        counts: dict[str, int] = {}
        for status in result.diagnosis.values():
            msg = status.message() if status is not None else ""
            counts[msg] = counts.get(msg, 0) + 1
        num = len(result.diagnosis)
        parts = [f"{counts[m]} {m}" for m in sorted(counts) if m]
        if not parts:
            return result.status.message() if result.status else "no nodes available"
        return f"0/{num} nodes are available: {', '.join(parts)}."

    # ------------------------------------------------------------- metrics

    @staticmethod
    def _procmesh_stats() -> "dict[str, Any] | None":
        """The scan ensemble's counters (ops/procmesh.py), or None while
        the ``KSS_MESH_PROCESSES`` knob has never been exercised: the
        common case stays out of the metrics payload."""
        from kube_scheduler_simulator_tpu_torch.ops import procmesh

        s = procmesh.stats()
        if not s["requested_processes"] and not s["fallbacks_by_reason"] and not s["run_fallbacks_by_reason"]:
            return None
        return s

    def metrics(self) -> dict[str, Any]:
        """Observability snapshot: the reference's keys, no more and no
        fewer, with the port's counters in the reference's meaning.

        The ``journal_*`` and ``checkpoint_compactions_total`` keys read the
        attached journal's counters, ``recovery_*`` the store's last
        recovery (0 with no journal), ``retry_by_seam`` the retries counted
        by resilience/, and the ``aot_cache_*`` keys this process's
        kernel-library cache (ops/aot.py: hits, misses, saves and fallbacks
        by reason; per process, not per engine as in the reference, since a
        library is loaded once a process; ``aot.stats()`` also counts the
        hits whose toolchain no compiler could check), ``procmesh`` the
        scan ensemble's counters (ops/procmesh.py; None until
        ``KSS_MESH_PROCESSES`` has been read).  Keys of subsystems the port has
        not ported report what the reference reports with the subsystem off:
        ``shard_devices``, ``sharded_dispatches_total`` and
        ``plane_shard_bytes_per_device`` 0 (the mesh);
        ``placer_bank_rotations_total`` 0 and ``placer_banks`` {}
        (the plane banks).

        The engine keys read the default profile's engine:
        ``engine_rounds`` its rounds (one per ``schedule``, windowed round
        or ``PendingBatch``); ``engine_compiles`` the kernel libraries
        this process has built or loaded (``ops/kernels.build``: nvcc, once
        per source; 0 on the CPU, where the plain versions run);
        ``engine_cache_entries`` the launch plans the compaction kernel
        has cached, one per trace manifest and shape (0 on the CPU).  The
        last two are the process's, shared by every engine.
        ``stats["f64_promotions"]`` stays in ``stats``."""
        from kube_scheduler_simulator_tpu_torch.ops import aot, kernels

        eng = self._batch_engine
        # lock-free: the multi-key dicts are copied under the lock; the
        # scalar reads are GIL-atomic reads of single-writer counters
        with self._stats_lock:
            fallbacks = dict(self.stats["batch_fallbacks"])
            preempt_fallbacks = dict(self.stats["preempt_fallbacks"])
            gang_fallbacks = dict(self.stats["gang_fallbacks"])
            stream_drains = dict(self.stats["stream_drains"])
            fuzz_divergences = dict(self.stats["fuzz_divergences"])
            tuning_objective = dict(self.stats["tuning_objective"])
        last_t = dict(eng.last_timings) if eng else {}
        # the fraction of the last pipelined round's device time hidden
        # under host commits (0 for rounds in one launch)
        est = last_t.get("device_est_s", 0.0)
        overlap = max(0.0, min(1.0, 1.0 - last_t.get("device_s", 0.0) / est)) if est > 1e-9 else 0.0
        last_wave_s = self.stats["last_wave_commit_s"]
        aot_counts = aot.stats()
        enc: dict[str, Any] = {
            "encode_full_total": 0,
            "encode_delta_total": 0,
            "encode_rows_reencoded_total": 0,
            "encode_fallbacks_by_reason": {},
            "device_bytes_uploaded_total": 0,
            "device_plane_reuses_total": 0,
            "device_scatter_updates_total": 0,
            "sharded_dispatches_total": 0,
            "plane_shard_bytes_per_device": 0,
            "placer_bank_rotations_total": 0,
            "placer_banks": {},
            **{k: aot_counts[k] for k in aot.METRIC_KEYS},
        }
        for e in list(self._batch_engines.values()) or ([eng] if eng else []):
            es = e.encode_stats()
            for k in ("encode_full_total", "encode_delta_total", "encode_rows_reencoded_total",
                      "device_bytes_uploaded_total", "device_plane_reuses_total", "device_scatter_updates_total",
                      "sharded_dispatches_total", "plane_shard_bytes_per_device"):
                enc[k] += es.get(k, 0)
            for reason, n in es.get("encode_fallbacks_by_reason", {}).items():
                enc["encode_fallbacks_by_reason"][reason] = enc["encode_fallbacks_by_reason"].get(reason, 0) + n
        # node-axis sharding: the victim search and the estimate shard over
        # the same mesh as the rounds, and count into the same pair
        enc["sharded_dispatches_total"] += self.stats["preempt_sharded_dispatches"]
        asc_m = self._autoscaler.metrics() if self._autoscaler is not None else None
        if asc_m is not None:
            enc["sharded_dispatches_total"] += asc_m["estimate_sharded_dispatches"]
            enc["plane_shard_bytes_per_device"] += asc_m["estimate_shard_plane_bytes_per_device"]
        # the write-ahead journal's write-side counters and the last
        # recovery's outcome: zero with no journal attached
        journal = getattr(self.cluster_store, "journal", None)
        jstats = dict(journal.stats) if journal is not None else {}
        rstats = dict(getattr(self.cluster_store, "recovery_stats", None) or {})
        return {
            **enc,
            "journal_enabled": int(journal is not None),
            "journal_records_total": jstats.get("records", 0),
            "journal_bytes_written_total": jstats.get("bytes", 0),
            "journal_fsyncs_total": jstats.get("fsyncs", 0),
            "journal_wedges_total": jstats.get("wedges", 0),
            "journal_records_dropped_total": jstats.get("records_dropped", 0),
            "journal_degraded_by_errno": dict(getattr(journal, "degraded_by_errno", None) or {}),
            "checkpoint_compactions_total": jstats.get("compactions", 0),
            "recovery_replayed_records_total": rstats.get("replayed_records", 0),
            "recovery_truncated_records_total": rstats.get("truncated_records", 0),
            "recovery_partial_gangs_total": rstats.get("partial_gangs", 0),
            "shard_devices": mesh_devices(self.mesh),
            "batch_commits": self.stats["batch_commits"],
            "batch_pods": self.stats["batch_pods"],
            "batch_restarts": self.stats["batch_restarts"],
            "sequential_pods": self.stats["sequential_pods"],
            "batch_fallbacks": fallbacks,
            "commit_s": self.stats["commit_s"],
            "commit_waves": self.stats["commit_waves"],
            "wave_commit_s": last_wave_s,
            "commit_pods_per_s": self.stats["last_wave_pods"] / last_wave_s if last_wave_s > 1e-9 else 0.0,
            "overlap_efficiency": overlap,
            "preempt_attempts": self.stats["preempt_attempts"],
            "preempt_nominations": self.stats["preempt_nominations"],
            "preempt_victims": self.stats["preempt_victims"],
            "preempt_dispatches": self.stats["preempt_dispatches"],
            "preempt_kernel_s": self.stats["preempt_kernel_s"],
            "preempt_fallbacks": preempt_fallbacks,
            "gang_rounds": self.stats["gang_rounds"],
            "gang_parked": self.stats["gang_parked"],
            "gang_released_groups": self.stats["gang_released_groups"],
            "gang_released_pods": self.stats["gang_released_pods"],
            "gang_kernel_dispatches": self.stats["gang_kernel_dispatches"],
            "gang_kernel_s": self.stats["gang_kernel_s"],
            "gang_verdict_mismatch": self.stats["gang_verdict_mismatch"],
            "gang_fallbacks": gang_fallbacks,
            "stream_waves_total": self.stats["stream_waves"],
            "stream_pods_total": self.stats["stream_pods"],
            "stream_overlap_s": self.stats["stream_overlap_s"],
            "stream_stall_s": self.stats["stream_stall_s"],
            "stream_drains_by_reason": stream_drains,
            "tuning_runs_total": self.stats["tuning_runs"],
            "tuning_rollouts_total": self.stats["tuning_rollouts"],
            "tuning_grad_dispatches_total": self.stats["tuning_grad_dispatches"],
            "tuning_objective": tuning_objective,
            "plugin_weights_overridden": int(self._weights_override is not None),
            # what the fuzzer reported into this service (note_fuzz_report)
            "fuzz_scenarios_total": self.stats["fuzz_scenarios"],
            "fuzz_divergences_by_kind": fuzz_divergences,
            "fuzz_shrink_steps_total": self.stats["fuzz_shrink_steps"],
            "waiting_pods": len(self._all_waiting_keys()),
            "permit_wait_expired": self.stats["permit_wait_expired"],
            **self.queue.stats(),
            "engine_rounds": eng.rounds if eng else 0,
            "engine_compiles": len(kernels._LIBS) if eng else 0,
            "engine_cache_entries": len(kernels._COMPACT_PLANS) if eng else 0,
            # the engine rebinds these dicts per round: copying the captured
            # object is race-free
            "engine_last_timings": last_t,
            "engine_cum_timings": dict(eng.cum_timings) if eng else {},
            "profile": self.profiler.snapshot(),
            "procmesh": self._procmesh_stats(),
            "retry_by_seam": retry_stats(),
            "autoscaler": asc_m,
        }

    # ---------------------------------------------------------- background

    def start_background(self, poll_interval: float = 0.25) -> None:
        """Always-on mode: a thread schedules whenever pods or nodes change
        (or every ``poll_interval`` seconds, or at the queue's next backoff
        expiry).  Each tick expires permit waits, flushes the queue's stuck
        pods, then runs one round with backoff respected; under
        ``autoscale="on"`` an autoscaler pass runs at most every
        ``autoscale_interval_s`` (idle ticks included, so scale-down
        advances).  The loop stops at its first exception and keeps it for
        ``stop_background`` to re-raise; starting over a loop that died
        re-raises its exception first."""
        if self._bg_thread is not None:
            if self.is_background_running():
                return
            self.stop_background()
        self._bg_stop.clear()
        self._bg_error = None
        self._bg_unsubscribe = self.cluster_store.subscribe(["pods", "nodes"], lambda ev: self._wakeup.set())
        # the rounds run on the loop's thread: on the card the caller's
        # device (and its default stream), as the thread that built the
        # engines
        card = None
        if self.device.type == "cuda":
            card = self.device.index if self.device.index is not None else torch.cuda.current_device()

        def loop() -> None:
            if card is not None:
                torch.cuda.set_device(card)
            try:
                while not self._bg_stop.is_set():
                    wake_in = self.queue.next_wakeup_in()
                    timeout = poll_interval if wake_in is None else min(poll_interval, wake_in)
                    self._wakeup.wait(timeout=max(timeout, 0.01))
                    self._wakeup.clear()
                    if self._bg_stop.is_set():
                        break
                    self._background_tick()
            except Exception as exc:  # noqa: BLE001 - kept for stop_background to re-raise
                self._bg_error = exc

        self._bg_thread = threading.Thread(target=loop, name="scheduler-loop", daemon=True)
        self._bg_thread.start()

    def _background_tick(self) -> None:
        # the quiesce gate of pause_streams: an exclusive store operation
        # (a snapshot load: POST /api/v1/import) lands whole before the
        # loop's next round.  The reference's loop does not take it, so a
        # round of its loop can see part of an import (pods bound in the
        # snapshot missing from the nodes they hold)
        with self._pause_mu:
            self._tick()

    def _tick(self) -> None:
        if self.framework is None:
            return
        self.process_waiting_pods()
        self.queue.flush_stuck()
        now = time.monotonic()
        autoscale_due = self.autoscale == "on" and now - self._last_autoscale_ts >= self.autoscale_interval_s
        if self.pending_pods():
            # persistently unschedulable pods wait in unschedulableQ instead
            # of being filtered again on every event
            if autoscale_due:
                self._last_autoscale_ts = now
                self.schedule_pending_autoscaled(max_rounds=1, respect_backoff=True)
            else:
                self.schedule_pending(max_rounds=1, respect_backoff=True)
        elif autoscale_due and self.autoscaler is not None:
            # idle ticks advance the scale-down timers
            self._last_autoscale_ts = now
            self.autoscaler.run_once()

    def is_background_running(self) -> bool:
        """True while the loop runs: False before ``start_background``,
        after ``stop_background``, and once the loop died of an
        exception."""
        t = self._bg_thread
        return t is not None and t.is_alive() and self._bg_error is None

    def stop_background(self) -> None:
        """Stop the loop and wait for its tick in flight to end (a round is
        never cut: the store and ``metrics()`` are settled on return), then
        re-raise the exception the loop died of, if it did."""
        t = self._bg_thread
        if t is None:
            return
        self._bg_stop.set()
        self._wakeup.set()
        t.join()
        self._bg_thread = None
        if self._bg_unsubscribe is not None:
            self._bg_unsubscribe()
            self._bg_unsubscribe = None
        err, self._bg_error = self._bg_error, None
        if err is not None:
            raise err


def _normalize_names(profile: Obj) -> None:
    """Strip the Wrapped suffix from any plugin names in a profile."""
    plugins = profile.get("plugins") or {}
    for point_set in plugins.values():
        if not isinstance(point_set, dict):
            continue
        for lst in ("enabled", "disabled"):
            for p in point_set.get(lst) or []:
                if p.get("name") and p["name"] != "*":
                    p["name"] = original_name(p["name"])
    for pc in profile.get("pluginConfig") or []:
        if pc.get("name"):
            pc["name"] = original_name(pc["name"])
