"""Prometheus-text-format metrics for the simulator.

The reference pulls in the upstream scheduler's Prometheus registration via
blank imports (reference pkg/debuggablescheduler/debuggable_scheduler.go:
13-15) and component-base metrics; this build exposes the simulator's own
counters natively: scheduling-round counts per path, batch-engine fallback
reasons, kernel library loads and compaction plans, and per-phase timings
(encode/lower/device), plus cluster-store object counts.

The port's copy of the JAX package's ``server/metrics.py``: the same metric
names, types and label sets, with the port's own values
(``SchedulerService.metrics()`` has the reference's key set).  Help texts
say what the port counts; the mesh, AOT-cache and process-ensemble families
read 0, as the port has none of these.

Served at ``GET /api/v1/metrics`` (and ``/metrics``, the conventional
scrape path) in Prometheus text exposition format v0.0.4.
"""

from __future__ import annotations

from typing import Any

_PREFIX = "simulator"


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_session(text: str, session: str) -> str:
    """Stamp every sample line with a ``session`` label (the per-session
    ``/metrics`` view: ``/api/v1/sessions/<id>/metrics``).  Text-level so
    the histogram block and every counter family need no plumbing."""
    out = []
    for line in text.splitlines():
        if line.startswith("#") or not line:
            out.append(line)
            continue
        head, _, value = line.rpartition(" ")
        if head.endswith("}"):
            head = head[:-1] + f',session="{_esc(session)}"}}'
        else:
            head = head + f'{{session="{_esc(session)}"}}'
        out.append(f"{head} {value}")
    return "\n".join(out) + "\n"


def render_metrics(di: Any, session: "str | None" = None, sessions: Any = None) -> str:
    """Render the whole registry from the DI container's live services.

    ``session`` labels every sample with the session id (the container
    passed in is that session's).  ``sessions`` is the server's
    SessionManager; once the session plane has ever been used, the
    DEFAULT render additionally exposes the plane's lifecycle counters
    and the shared-substrate hit/miss counters — before first use the
    output stays byte-for-byte what a sessionless server rendered."""
    svc = di.scheduler_service()
    m = svc.metrics()
    lines: list[str] = []

    def counter(name: str, help_: str, value: float, labels: "dict[str, str] | None" = None, typ: str = "counter"):
        full = f"{_PREFIX}_{name}"
        if not any(ln.startswith(f"# HELP {full} ") for ln in lines):
            lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} {typ}")
        lab = ""
        if labels:
            lab = "{" + ",".join(f'{k}="{_esc(str(v))}"' for k, v in sorted(labels.items())) + "}"
        lines.append(f"{full}{lab} {value}")

    counter("scheduled_pods_total", "Pods scheduled, by path.", m["batch_pods"], {"path": "batch"})
    counter("scheduled_pods_total", "Pods scheduled, by path.", m["sequential_pods"], {"path": "sequential"})
    counter("batch_rounds_total", "Scheduling rounds that ran on the batch engine (the hand-written scan kernel on the card).", m["batch_commits"])
    counter("batch_kernel_runs_total", "Batch-kernel invocations (>= rounds: mid-round preemptions re-run the kernel on the tail).", m["engine_rounds"])
    counter("batch_restarts_total", "Mid-round kernel re-runs forced by successful preemptions.", m["batch_restarts"])
    for reason, n in sorted(m["batch_fallbacks"].items()):
        counter(
            "batch_fallbacks_total",
            "Rounds that fell back to the sequential cycle, by reason.",
            n,
            {"reason": reason},
        )
    if not m["batch_fallbacks"]:
        counter(
            "batch_fallbacks_total",
            "Rounds that fell back to the sequential cycle, by reason.",
            0,
            {"reason": "none"},
        )
    # scheduling-queue state (activeQ/backoffQ/unschedulableQ)
    counter("queue_pods", "Pods tracked by the scheduling queue, by state.", m["queue_active"], {"state": "active"}, typ="gauge")
    counter("queue_pods", "Pods tracked by the scheduling queue, by state.", m["queue_backoff"], {"state": "backoff"}, typ="gauge")
    counter("queue_pods", "Pods tracked by the scheduling queue, by state.", m["queue_unschedulable"], {"state": "unschedulable"}, typ="gauge")
    counter("queue_moves_total", "Unschedulable-queue moves triggered by cluster events.", m["queue_moves"])
    counter("queue_flushes_total", "Stuck unschedulable pods flushed by timeout.", m["queue_flushes"])
    # commit-pipeline trajectory (the bench's cfg5 columns, live — a
    # scrape can catch commit-path regressions between bench rounds)
    counter("commit_seconds_total", "Cumulative host-side commit wall within batch rounds.", round(m["commit_s"], 6))
    counter("commit_waves_total", "Bulk-commit waves flushed on the batch path.", m["commit_waves"])
    counter("wave_commit_seconds", "Host commit wall of the last bulk-commit wave.", round(m["wave_commit_s"], 6), typ="gauge")
    counter("commit_pods_per_s", "Pods committed per host-commit second (last wave).", round(m["commit_pods_per_s"], 3), typ="gauge")
    counter("overlap_efficiency", "Fraction of the last pipelined round's device time hidden under host commits (0 when un-pipelined).", round(m["overlap_efficiency"], 4), typ="gauge")
    # vectorized preemption engine (preemption/): batched PostFilter work
    counter("preemption_attempts_total", "Kernel-failed pods whose PostFilter ran on the batched victim-search engine.", m["preempt_attempts"])
    counter("preemption_nominations_total", "Successful batched preemptions (nominatedNodeName set).", m["preempt_nominations"])
    counter("preemption_victims_total", "Victims evicted by batched preemptions.", m["preempt_victims"])
    counter("preemption_dispatches_total", "Vmapped victim-search dispatches (one per replay window with kernel failures).", m["preempt_dispatches"])
    counter("preemption_kernel_seconds_total", "Cumulative victim-search kernel wall.", round(m["preempt_kernel_s"], 6))
    for reason, n in sorted(m["preempt_fallbacks"].items()):
        counter(
            "preemption_fallbacks_total",
            "PostFilter work that took the sequential DefaultPreemption path, by reason.",
            n,
            {"reason": reason},
        )
    if not m["preempt_fallbacks"]:
        counter(
            "preemption_fallbacks_total",
            "PostFilter work that took the sequential DefaultPreemption path, by reason.",
            0,
            {"reason": "none"},
        )
    # gang engine (gang/): all-or-nothing PodGroup placement
    counter("gang_rounds_total", "Batch rounds with the gang replay engaged (PodGroups present).", m["gang_rounds"])
    counter("gang_parked_pods_total", "Gang members parked at Permit by the batch replay.", m["gang_parked"])
    counter("gang_released_groups_total", "PodGroups released as atomic all-or-nothing waves.", m["gang_released_groups"])
    counter("gang_released_pods_total", "Gang members bound through atomic release waves.", m["gang_released_pods"])
    counter("gang_kernel_dispatches_total", "Gang-kernel verdict dispatches (one per replay window, not per group).", m["gang_kernel_dispatches"])
    counter("gang_kernel_seconds_total", "Cumulative gang-kernel wall.", round(m["gang_kernel_s"], 6))
    counter("gang_verdict_mismatch_total", "Device-vs-host gang verdict disagreements (nonzero = bug).", m["gang_verdict_mismatch"])
    for reason, n in sorted(m["gang_fallbacks"].items()):
        counter(
            "gang_fallbacks_total",
            "Gang rounds that took the sequential Coscheduling oracle, by reason.",
            n,
            {"reason": reason},
        )
    if not m["gang_fallbacks"]:
        counter(
            "gang_fallbacks_total",
            "Gang rounds that took the sequential Coscheduling oracle, by reason.",
            0,
            {"reason": "none"},
        )
    # streaming wave pipeline (scheduler/stream.py): wave k+1's
    # encode/upload/dispatch overlapped with wave k's kernel + commit
    counter("stream_waves_total", "Waves committed through the streaming pipeline's overlapped path.", m["stream_waves_total"])
    counter("stream_pods_total", "Pods committed by streamed waves.", m["stream_pods_total"])
    counter("stream_overlap_seconds_total", "Host seconds spent encoding/committing while a streamed kernel was in flight (hidden work).", round(m["stream_overlap_s"], 6))
    counter("stream_stall_seconds_total", "Host seconds blocked waiting on a streamed wave's device results.", round(m["stream_stall_s"], 6))
    for reason, n in sorted(m["stream_drains_by_reason"].items()):
        counter(
            "stream_drains_total",
            "Pipeline drains by exactness-gate reason (most reasons route the wave to the sequential path; kernel-failure and node-change gates only serialize the streamed boundary).",
            n,
            {"reason": reason},
        )
    if not m["stream_drains_by_reason"]:
        counter(
            "stream_drains_total",
            "Pipeline drains by exactness-gate reason (most reasons route the wave to the sequential path; kernel-failure and node-change gates only serialize the streamed boundary).",
            0,
            {"reason": "none"},
        )
    # learned scoring head (tuning/): on-device tuner activity + the
    # live weight-override state
    counter("tuning_runs_total", "Weight-tuning runs completed (one per family per /api/v1/tuning or bench invocation).", m["tuning_runs_total"])
    counter("tuning_rollouts_total", "On-device rollouts evaluated by the tuners (CEM counts every population member).", m["tuning_rollouts_total"])
    counter("tuning_grad_dispatches_total", "Straight-through value-and-grad dispatches (gradient tuner).", m["tuning_grad_dispatches_total"])
    for objective, v in sorted(m["tuning_objective"].items()):
        counter(
            "tuning_objective",
            "Tuned objective value of the most recent run, by objective name (higher = better).",
            round(float(v), 6),
            {"name": objective},
            typ="gauge",
        )
    counter("plugin_weights_overridden", "1 while a plugin-weight override (learned scoring head) is active on the live profiles.", m["plugin_weights_overridden"], typ="gauge")
    # differential fuzzer (fuzz/): sweep outcomes reported through
    # service.note_fuzz_report (scripts/fuzz_smoke.py, nightlong-haul runs)
    counter("fuzz_scenarios_total", "Composite fuzz scenarios judged through the differential runner.", m["fuzz_scenarios_total"])
    for kind, n in sorted(m["fuzz_divergences_by_kind"].items()):
        counter(
            "fuzz_divergences_total",
            "Unexplained byte divergences between differential paths, by comparison kind (nonzero = bug).",
            n,
            {"kind": kind},
        )
    if not m["fuzz_divergences_by_kind"]:
        counter(
            "fuzz_divergences_total",
            "Unexplained byte divergences between differential paths, by comparison kind (nonzero = bug).",
            0,
            {"kind": "none"},
        )
    counter("fuzz_shrink_steps_total", "Accepted shrinker reductions while minimizing diverging scenarios.", m["fuzz_shrink_steps_total"])
    # Permit wait machinery (waiting-pod map)
    counter("waiting_pods", "Pods parked at Permit holding a reservation.", m["waiting_pods"], typ="gauge")
    counter("permit_wait_expired_total", "Permit waits rejected on deadline expiry.", m["permit_wait_expired"])
    # incremental encoder + device-resident problem (delta re-encode
    # across waves — ops/encode.EncodeCache + ops/batch.DevicePlacer)
    counter("encode_rounds_total", "Encode passes, by mode (full cold encode vs incremental delta).", m["encode_full_total"], {"mode": "full"})
    counter("encode_rounds_total", "Encode passes, by mode (full cold encode vs incremental delta).", m["encode_delta_total"], {"mode": "delta"})
    counter("encode_rows_reencoded_total", "Per-object rows re-encoded on the delta path (changed bound pods + class-row cache misses).", m["encode_rows_reencoded_total"])
    for reason, n in sorted(m["encode_fallbacks_by_reason"].items()):
        counter(
            "encode_fallbacks_total",
            "Encode passes that fell back to a cold full encode, by exactness-gate reason.",
            n,
            {"reason": reason},
        )
    if not m["encode_fallbacks_by_reason"]:
        counter(
            "encode_fallbacks_total",
            "Encode passes that fell back to a cold full encode, by exactness-gate reason.",
            0,
            {"reason": "none"},
        )
    counter("device_bytes_uploaded_total", "Host-to-device bytes actually shipped for problem placement (reused resident planes upload nothing).", m["device_bytes_uploaded_total"])
    counter("device_plane_reuses_total", "Device-resident planes reused unchanged across rounds.", m["device_plane_reuses_total"])
    counter("device_scatter_updates_total", "Resident planes updated in place by the row-scatter kernel.", m["device_scatter_updates_total"])
    # the streaming double buffer's per-bank view (DevicePlacer banks):
    # rotations plus scatter traffic / resident bytes per bank, so a
    # stuck rotation (one bank starving while the other churns) shows up
    # in a scrape
    counter("placer_bank_rotations_total", "DevicePlacer bank alternations (streamed waves flip banks so scatter-donations never touch an in-flight kernel's buffers).", m["placer_bank_rotations_total"])
    banks = m["placer_banks"] or {0: {"scatter_updates": 0, "resident_plane_bytes_per_device": 0, "planes": 0}}
    for bank, bs in sorted(banks.items()):
        counter(
            "placer_bank_scatter_updates_total",
            "Scatter-updates applied to resident planes, by DevicePlacer bank.",
            bs.get("scatter_updates", 0),
            {"bank": bank},
        )
        counter(
            "placer_bank_plane_bytes_per_device",
            "Per-device bytes of a bank's resident problem planes (node-sharded planes split across the mesh, replicated planes in full).",
            bs.get("resident_plane_bytes_per_device", 0),
            {"bank": bank},
            typ="gauge",
        )
        counter(
            "placer_bank_resident_planes",
            "Resident device planes held, by DevicePlacer bank.",
            bs.get("planes", 0),
            {"bank": bank},
            typ="gauge",
        )
    # the kernel-library cache (ops/aot.py, KSS_AOT_CACHE_DIR): the
    # process's counters
    counter("aot_cache_hits_total", "Kernel libraries loaded from the on-disk library cache (nvcc skipped).", m["aot_cache_hits_total"])
    counter("aot_cache_misses_total", "Kernel libraries with no entry in the library cache (built, then saved).", m["aot_cache_misses_total"])
    counter("aot_cache_saves_total", "Kernel libraries saved into the library cache.", m["aot_cache_saves_total"])
    for reason, n in sorted(m["aot_cache_fallbacks_by_reason"].items()):
        counter(
            "aot_cache_fallbacks_total",
            "Library cache entries rejected (the library rebuilt), or saves that failed, by reason.",
            n,
            {"reason": reason},
        )
    if not m["aot_cache_fallbacks_by_reason"]:
        counter(
            "aot_cache_fallbacks_total",
            "Library cache entries rejected (the library rebuilt), or saves that failed, by reason.",
            0,
            {"reason": "none"},
        )
    # durability layer (state/journal.py + state/recovery.py): the
    # write-ahead journal's write side and the last boot's recovery —
    # all zeros when KSS_JOURNAL_DIR is unset (the default)
    counter("journal_enabled", "1 while a write-ahead journal is attached to the cluster store (KSS_JOURNAL_DIR).", m["journal_enabled"], typ="gauge")
    counter("journal_records_total", "Records appended to the write-ahead journal (one per mutation event, or one per atomic wave/gang/bulk transaction).", m["journal_records_total"])
    counter("journal_bytes_written_total", "Bytes appended to journal segments (record headers + payloads).", m["journal_bytes_written_total"])
    counter("journal_fsyncs_total", "Journal records synced to disk (KSS_JOURNAL_FSYNC=1).", m["journal_fsyncs_total"])
    # disk faults as policy (KSS_JOURNAL_ON_ERROR — docs/resilience.md)
    counter("journal_wedges_total", "Disk faults that wedged the journal (KSS_JOURNAL_ON_ERROR=wedge): the commit failed loudly and all further mutations are refused.", m["journal_wedges_total"])
    counter("journal_records_dropped_total", "Journal appends skipped while running non-durable after a degrade-mode disk fault.", m["journal_records_dropped_total"])
    for label, n in sorted(m["journal_degraded_by_errno"].items()):
        counter(
            "journal_degraded_total",
            "Disk faults absorbed by KSS_JOURNAL_ON_ERROR=degrade (journal marked torn at a record boundary, store continues non-durable), by errno.",
            n,
            {"errno": label},
        )
    counter("checkpoint_compactions_total", "Journal compactions: checkpoint written (SnapshotService.snap shape + extras), segments rotated and pruned.", m["checkpoint_compactions_total"])
    counter("recovery_replayed_records_total", "Journal records replayed into the store by the last boot-time recovery.", m["recovery_replayed_records_total"])
    counter("recovery_truncated_records_total", "Torn journal tails truncated by recovery (counted, never raised; nonzero after a clean SIGKILL = bug).", m["recovery_truncated_records_total"])
    counter("recovery_partial_gangs_total", "PodGroups observed partially bound at the recovery point (wave/gang records are atomic, so nonzero = bug).", m["recovery_partial_gangs_total"])
    # node-axis mesh sharding (ops/mesh.py): the scale axis across chips
    counter("shard_devices", "Devices in the node-axis sharding mesh (0 = single-device).", m["shard_devices"], typ="gauge")
    counter("sharded_dispatches_total", "Kernel dispatches executed with the node axis sharded over the mesh (main scan + victim search + estimator).", m["sharded_dispatches_total"])
    counter("plane_shard_bytes_per_device", "Cumulative per-device bytes of sharded problem placements (node-sharded planes split across the mesh, replicated planes counted in full).", m["plane_shard_bytes_per_device"])
    counter("batch_compiles_total", "Kernel libraries built or loaded in this process (ops/kernels.py).", m["engine_compiles"])
    counter("batch_executable_cache_entries", "Compaction launch plans cached in this process (one per trace manifest and width).", m["engine_cache_entries"], typ="gauge")
    for phase, secs in sorted(m["engine_cum_timings"].items()):
        counter(
            "batch_phase_seconds_total",
            "Cumulative batch-engine time by phase (encode/lower/device/total).",
            round(secs, 6),
            {"phase": phase.removesuffix("_s")},
        )
    for phase, secs in sorted(m["engine_last_timings"].items()):
        counter(
            "batch_phase_seconds_last",
            "Last-round batch-engine time by phase.",
            round(secs, 6),
            {"phase": phase.removesuffix("_s")},
            typ="gauge",
        )

    # per-wave stage profiler (ops/profile.py): where the wall goes.
    # Disjoint host stamps per wave; sum over stages == committed wall.
    prof = m.get("profile")
    if prof:
        counter("wave_profile_enabled", "1 while the per-wave stage profiler is on (KSS_PROFILE).", prof["enabled"], typ="gauge")
        counter("wave_profile_waves_total", "Waves closed by the stage profiler.", prof["waves"])
        counter("wave_profile_wall_seconds_total", "Cumulative profiled wave wall (== sum of all stage seconds).", round(prof["wall_s"], 6))
        for stage, st in sorted(prof["stages"].items()):
            counter(
                "wave_stage_seconds_total",
                "Cumulative host seconds attributed to a wave stage (disjoint stamps; host_other is the derived remainder).",
                round(st["total_s"], 6),
                {"stage": stage},
            )
            counter(
                "wave_stage_stamps_total",
                "Stamp count per wave stage.",
                st["count"],
                {"stage": stage},
            )
            counter(
                "wave_stage_seconds_max",
                "Largest single stamp observed per wave stage (cold-wave compiles spike dispatch).",
                round(st["max_s"], 6),
                {"stage": stage},
                typ="gauge",
            )
        # Prometheus histogram per stage (log4 buckets, cumulative le)
        hfull = f"{_PREFIX}_wave_stage_duration_seconds"
        lines.append(f"# HELP {hfull} Per-stamp stage latency histogram (log4 buckets).")
        lines.append(f"# TYPE {hfull} histogram")
        ubs = prof["hist_buckets"]
        for stage, hs in sorted(prof["hist"].items()):
            cum = 0
            for ub, n in zip(ubs, hs):
                cum += n
                lines.append(f'{hfull}_bucket{{stage="{stage}",le="{ub:g}"}} {cum}')
            cum += hs[-1]
            lines.append(f'{hfull}_bucket{{stage="{stage}",le="+Inf"}} {cum}')
            st = prof["stages"].get(stage, {"total_s": 0.0})
            lines.append(f'{hfull}_sum{{stage="{stage}"}} {round(st["total_s"], 6)}')
            lines.append(f'{hfull}_count{{stage="{stage}"}} {cum}')

    # multi-process shard ensemble (ops/procmesh.py) — only once the
    # KSS_MESH_PROCESSES knob has been exercised
    pm = m.get("procmesh")
    if pm is not None:
        counter("procmesh_requested_processes", "KSS_MESH_PROCESSES as last read by an engine.", pm["requested_processes"], typ="gauge")
        pool = pm.get("pool")
        counter("procmesh_engaged", "1 while a live worker ensemble is serving scans.", int(bool(pool and pool["engaged"])), typ="gauge")
        if pool:
            counter("procmesh_dispatches_total", "Scan waves dispatched to the worker ensemble.", pool["dispatches"])
            counter("procmesh_scans_loaded", "Distinct AOT scan executables resolved on every worker.", pool["scans_loaded"], typ="gauge")
            # supervision (docs/resilience.md): straggler-only kills,
            # ensemble respawns, and the breaker's degradation state
            counter("procmesh_respawns_total", "Worker-ensemble respawns after a supervised failure (straggler SIGKILLed, fresh ensemble re-loaded from the AOT cache).", pool["respawns"])
            counter("procmesh_hangs_detected_total", "Workers declared hung (alive but STOPPED for a full KSS_PROCMESH_HEARTBEAT_S — e.g. SIGSTOP'd), distinguished from dead ones.", pool["hangs_detected"])
            counter("procmesh_breaker_state", "Ensemble circuit breaker: 0 closed, 1 half-open, 2 open (open = counted permanent degradation to the in-process virtual mesh).", pool["breaker_state_code"], typ="gauge")
            for verdict, n in sorted(pool["failures_by_verdict"].items()):
                counter(
                    "procmesh_worker_failures_total",
                    "Supervised worker failures, by wait verdict (died/hang/timeout/error).",
                    n,
                    {"verdict": verdict},
                )
        for reason, n in sorted(pm["fallbacks_by_reason"].items()):
            counter(
                "procmesh_fallbacks_total",
                "Ensemble bring-up failures degraded (counted) to the in-process virtual mesh.",
                n,
                {"reason": reason.split(":", 1)[0]},
            )
        for reason, n in sorted(pm["run_fallbacks_by_reason"].items()):
            counter(
                "procmesh_run_fallbacks_total",
                "Dispatch-time ensemble degrades (per scan key or per wave), by reason.",
                n,
                {"reason": reason.split(":", 1)[0]},
            )

    # capacity engine (autoscaler/) — only once it has been constructed
    asc = m.get("autoscaler")
    if asc is not None:
        counter("autoscaler_passes_total", "Autoscaler passes run.", asc["passes"])
        counter("autoscaler_scale_ups_total", "Scale-up actions taken.", asc["scale_ups"])
        counter("autoscaler_scale_downs_total", "Scale-down (node drain) actions taken.", asc["scale_downs"])
        counter("autoscaler_nodes_added_total", "Nodes materialized by scale-up.", asc["nodes_added"])
        counter("autoscaler_nodes_removed_total", "Nodes drained by scale-down.", asc["nodes_removed"])
        counter("autoscaler_estimation_dispatches_total", "Vmapped estimation-kernel dispatches (one per scale-up estimate, all groups).", asc["estimate_dispatches"])
        counter("autoscaler_estimation_compiles_total", "Distinct lane-scan shapes the estimation kernel has run.", asc["estimate_compiles"])
        counter("autoscaler_estimation_kernel_errors_total", "Kernel-path crashes degraded to the resource-only fallback (nonzero = bug).", asc["estimate_kernel_errors"])
        counter("autoscaler_estimation_sharded_dispatches_total", "Estimation dispatches executed with the template-row axis sharded over the mesh.", asc["estimate_sharded_dispatches"])
        counter("autoscaler_estimation_seconds_total", "Cumulative scale-up estimation wall.", round(asc["estimate_cum_s"], 6))
        counter("autoscaler_estimation_seconds_last", "Last scale-up estimation wall.", round(asc["estimate_last_s"], 6), typ="gauge")
        for gname, gs in sorted(asc["groups"].items()):
            for bound in ("current", "min", "max"):
                counter(
                    "autoscaler_node_group_size",
                    "Node-group size, by bound (current/min/max).",
                    gs[bound],
                    {"group": gname, "bound": bound},
                    typ="gauge",
                )

    # render-once wire-bytes cache (server/wirecache.py) — present only
    # once a DI container attached one (KSS_WIRECACHE=0 leaves it None)
    wc = getattr(di.cluster_store, "wirecache", None)
    if wc is not None:
        wcs = wc.stats()
        counter("wirecache_hits_total", "Wire renders served from the render-once byte cache (list items, watch events, single GETs).", wcs["hits"])
        counter("wirecache_misses_total", "Wire renders that had to json.dumps (first serve of an object version per groupVersion).", wcs["misses"])
        counter("wirecache_invalidations_total", "Cache entries purged by store mutations/replays (delete counts once; clear_for_replay counts each).", wcs["invalidations"])
        counter("wirecache_entries", "Object versions currently cached.", wcs["entries"], typ="gauge")

    # journal shipping / read replica (replication/) — present only on
    # a store fed by a ReplicaApplier (stays None on a primary)
    rep = getattr(di.cluster_store, "replication_stats", None)
    if rep is not None:
        counter("replication_records_shipped_total", "Journal records shipped from the primary's WAL and applied to this replica's store.", rep["records_shipped"])
        counter("replication_events_applied_total", "Store events applied by shipped records (a wave record carries many).", rep["events_applied"])
        counter("replication_lag_records", "Complete journal records readable but not yet applied (one record == one commit wave).", rep["lag_records"], typ="gauge")
        counter("replication_lag_seconds", "How long the apply backlog has been nonzero (0 when caught up with the durable stream).", round(rep["lag_seconds"], 6), typ="gauge")
        counter("replication_torn_records_total", "Partial/corrupt frames observed while tailing (counted read-only; the tailer never truncates the primary's files).", rep["torn_records"])
        counter("replication_rebases_total", "Follower rebases from a newer checkpoint after compaction pruned the segment being tailed.", rep["rebases"])
        counter("replica_promotions_total", "Failovers: this replica finalized replay and became the primary.", rep["promotions"])
        counter("replica_read_requests_total", "GET requests served by the replica's HTTP surface.", rep["read_requests"])
        # read-side disk faults on the primary's directory, classified
        # (ENOENT = not created yet, waits uncounted; everything else
        # counts here and paces the poll loop through RetryPolicy)
        counter("replication_backoffs_total", "Faulty polls that pushed the apply loop into seeded exponential backoff.", rep.get("backoffs", 0))
        for label, n in sorted((rep.get("read_errors_by_errno") or {}).items()):
            counter(
                "replication_read_errors_total",
                "Tailer read faults on the primary's journal directory (EACCES/EIO/...; never conflated with a journal that does not exist yet), by errno.",
                n,
                {"errno": label},
            )

    # per-seam retries (resilience/policy.py): every counted retry a
    # cross-process seam took and survived
    for seam, n in sorted((m.get("retry_by_seam") or {}).items()):
        counter(
            "retry_attempts_total",
            "Retries taken at a cross-process seam (procmesh re-dispatch, replication backoff, stream kernel-error drain), by seam.",
            n,
            {"seam": seam},
        )

    store = di.cluster_store
    from kube_scheduler_simulator_tpu_torch.state.store import KINDS

    for kind in sorted(KINDS):
        counter(
            "cluster_objects",
            "Objects in the cluster store, by kind.",
            len(store.list(kind)),
            {"kind": kind},
            typ="gauge",
        )

    # session plane (tenancy/) — only once a session has ever existed,
    # and only on the default (unlabeled) render: a plain single-tenant
    # scrape stays byte-identical to the pre-session-plane output
    if session is None and sessions is not None and getattr(sessions, "ever_used", False):
        st = sessions.stats()
        counter("sessions_active", "Live sessions beyond the default (tenancy/manager.py).", st["sessions_active"], typ="gauge")
        counter("sessions_created_total", "Sessions created over /api/v1/sessions.", st["sessions_created_total"])
        counter("sessions_destroyed_total", "Sessions explicitly destroyed (journal namespace purged).", st["sessions_destroyed_total"])
        counter("sessions_expired_total", "Sessions reaped by the idle TTL (KSS_SESSION_TTL_S).", st["sessions_expired_total"])
        counter("sessions_rejected_total", "Session creations rejected by the admission cap (KSS_MAX_SESSIONS, HTTP 429).", st["sessions_rejected_total"])
        counter("sessions_recovered_total", "Sessions restored at boot from per-session journal namespaces.", st["sessions_recovered_total"])
        from kube_scheduler_simulator_tpu_torch.tenancy.substrate import SUBSTRATE

        ss = SUBSTRATE.stats()
        counter("substrate_fn_hits_total", "Kernel entries and compaction plans another launch already published to the shared substrate (tenancy/substrate.py).", ss["substrate_fn_hits_total"])
        counter("substrate_fn_misses_total", "Substrate lookups that found nothing published (the first launch to resolve a key).", ss["substrate_fn_misses_total"])
        counter("substrate_fn_entries", "Entries in the process-wide shared substrate, across families (kernel entries, compaction plans).", ss["substrate_fn_entries"], typ="gauge")

    text = "\n".join(lines) + "\n"
    if session is not None:
        return _label_session(text, session)
    return text
