"""The streaming wave pipeline: overlap wave k+1's encode/upload/launch with
wave k's in-flight kernel and host commit, fed by a continuously draining
admission queue (port of the JAX package's ``scheduler/stream.py``).

The batch round is round-oriented: freeze a pending snapshot, encode,
launch, wait, commit; the host idles while the kernel runs, the card idles
while the host formats annotations.  A StreamSession dissolves the round
boundary:

- **Admission** drains the scheduling queue fresh at every wave (pods that
  arrived while the previous wave was in flight join the very next encode)
  instead of freezing one pending set per round.
- **Overlap**: as soon as wave k's packed decisions are fetched (a small
  [5, P] int32 copy, ``PendingBatch.decisions()``, which also launches wave
  k's compaction and enqueues its blob's copy behind an event), wave k+1 is
  admitted, delta-encoded against a synthesized view of the store with wave
  k's placements applied, placed on the card and launched.  Wave k's blob
  wait (on its event only), annotation rendering and
  ``add_wave_results``/``flush_wave`` then run while wave k+1's kernel is
  in flight.
- **Exactness**: commit order is strict (wave k commits fully before any of
  wave k+1), the next wave's ``base_counter``/``start_index`` are the
  values the sequential path would have reached (every attempted pod
  advances the counter by one; the rotation start is wave k's
  ``final_start``), and the synthesized encode view differs from the
  post-commit store only in fields the encoder ignores (resourceVersion
  bumps, status conditions, annotations), so a streamed run's annotation
  bytes are byte-identical to the serial path's (tests/test_torch_stream.py
  holds them against the JAX package's).

Anything outside that envelope **drains the pipeline**, counted per reason
in ``stats["stream_drains"]``.  Most reasons route the wave to the
sequential path: gang profiles and parked waiting pods ("gang": a gang
round's atomic commit must never interleave with a streamed wave), pending
preemption nominations, multi-profile rounds, unsupported workloads,
trace-less engines, and kernel failures on profiles whose PostFilter could
preempt (a successful preemption rewrites cluster state mid-round); those
waves run through ``SchedulerService.schedule_pending``, the exact
machinery, and streaming resumes at the next wave.  Three gates only
SERIALIZE the streamed boundary: a mid-stream node/config change commits
wave k first and re-launches the gated pods streamed against the settled
store; force-mode kernel failures stream their commit but hold the next
admission until after it (so the failed pods' requeue lands on the serial
cadence); and a pod parked in unschedulableQ holds the overlap admission
until wave k's commit has fired its events (binds move_all parked pods: an
admission taken before the commit could miss the reactivation the serial
cadence would see).  All three still count a drain: the counter tracks
pipeline serialization points, not sequential-path rounds.

Two deliberate differences from the reference:

- **No mesh.** The reference streams mesh-sharded engines too (the stream
  x mesh fusion); the port's service refuses a mesh, so that path is not
  ported.  Nor are the reference's two placer banks: the port launches and
  copies on one CUDA stream, so wave k+1's row scatter into the resident
  planes is ordered after wave k's kernels (``BatchEngine.schedule_async``).
- **A kernel or launch error propagates** out of ``schedule_stream``, as it
  does out of the port's round and its scale-up estimate.  The reference
  catches it at the launch, the decision fetch and the blob wait, and
  drains the wave's pods to the sequential path as ``kernel error:
  <type>``.  Here the dying wave has committed nothing (its pods stay
  pending), and ``run()`` still flushes the reflector and hands back the
  session's busy slot.

``KSS_STREAM_PIPELINE=0`` (or ``streaming=False``) keeps the admission loop
but runs every wave strictly serially: the A/B baseline
(``time_stream.py``'s ``stream_off`` mode).
"""

from __future__ import annotations

import gc
import os
import time
from typing import Any, Callable

from kube_scheduler_simulator_tpu_torch.utils.keys import pod_key as _pod_key

Obj = dict[str, Any]


def stream_pipeline_enabled() -> bool:
    """Resolve the ``KSS_STREAM_PIPELINE`` env knob ("0"/"off"/"false"/"no"
    disables the overlap; anything else, unset included, keeps it on)."""
    return os.environ.get("KSS_STREAM_PIPELINE", "").strip().lower() not in ("0", "off", "false", "no")


class StreamSession:
    """One continuous streaming run over a SchedulerService.

    ``feed``: called once per admission tick with the tick index; it may
    create/delete store objects (the arrival stream) and returns False when
    the source is exhausted (the session then runs until the queue and the
    pipeline are empty).  ``duration_s`` bounds the admission phase by wall
    clock instead (an external feeder thread); ``max_waves`` bounds the
    streamed wave count; ``wave_pods`` caps the pods admitted per wave (None
    = drain everything ready).  ``streaming`` overrides the
    ``KSS_STREAM_PIPELINE`` knob."""

    def __init__(
        self,
        service: Any,
        feed: "Callable[[int], bool] | None" = None,
        duration_s: "float | None" = None,
        max_waves: "int | None" = None,
        wave_pods: "int | None" = None,
        streaming: "bool | None" = None,
        idle_sleep_s: float = 0.002,
        gc_every_waves: int = 32,
    ):
        self.svc = service
        self.feed = feed
        self.duration_s = duration_s
        self.max_waves = max_waves
        self.wave_pods = wave_pods
        self.streaming = stream_pipeline_enabled() if streaming is None else bool(streaming)
        self.idle_sleep_s = idle_sleep_s
        # gc is disabled for the whole session (a collection pause mid-wave
        # would serialize the pipeline at a random point), but a long stream
        # allocates continuously: collect at wave BOUNDARIES, every this
        # many commits, where the pause overlaps the next wave's kernel
        self.gc_every_waves = gc_every_waves
        self._commits_since_gc = 0
        # waves committed by THIS session: ``max_waves`` is a per-session
        # budget, while stats["stream_waves"] accumulates over the
        # service's lifetime
        self._session_waves = 0
        self.results: dict[str, Any] = {}
        self._feed_alive = feed is not None
        self._tick = 0
        self._t0 = 0.0
        # set when an overlap admission was GATED: its pods were drained
        # from the queue conceptually but not launched; the next admission
        # re-drains them without consuming a new feed tick, so wave
        # composition stays aligned with the serial cadence
        self._feed_hold = False

    # ------------------------------------------------------------- stats

    def _count_drain(self, reason: str) -> None:
        with self.svc._stats_lock:
            d = self.svc.stats["stream_drains"]
            d[reason] = d.get(reason, 0) + 1

    def _note_wave(self, cnt: int) -> None:
        # single writer (the session thread), fixed keys
        self._session_waves += 1
        self.svc.stats["stream_waves"] += 1
        self.svc.stats["stream_pods"] += cnt

    # --------------------------------------------------------- admission

    def _admitting(self) -> bool:
        """Is the arrival stream still open?"""
        if self.duration_s is not None:
            return time.perf_counter() - self._t0 < self.duration_s
        return self._feed_alive

    def _admit(self, exclude: "frozenset[str] | set[str]") -> list[Obj]:
        """One admission tick: pull the feed, expire permits, and drain
        everything the queue allows minus the in-flight wave."""
        svc = self.svc
        if self._feed_hold:
            # re-draining a gated admission: its feed tick already fired
            self._feed_hold = False
        elif self._feed_alive and self.feed is not None and (
            self.duration_s is None or time.perf_counter() - self._t0 < self.duration_s
        ):
            self._feed_alive = bool(self.feed(self._tick))
            self._tick += 1
        # queue maintenance carve-out: waiting-pod processing, backoff gates
        # and QueueSort stamp as their own stage (exclusive of any store
        # mutations they trigger: those stamp store_mutate)
        prof = svc.profiler
        rec = prof.current
        tq = time.perf_counter()
        n0 = prof.nested(rec)
        svc.process_waiting_pods()
        cands = svc._ready_pending(respect_backoff=False)
        if exclude:
            cands = [p for p in cands if _pod_key(p) not in exclude]
        pending = svc.framework.sort_pods(cands)
        prof.note_excl(rec, "queue_maint", time.perf_counter() - tq, n0)
        if self.wave_pods is not None:
            pending = pending[: self.wave_pods]
        return pending

    # ------------------------------------------------------------- gates

    def _gate(self, pending: list[Obj], nodes: list[Obj]) -> "tuple[str | None, dict | None]":
        """``(reason, volumes)``: why this wave must take the sequential path
        (reason None = streamable), plus the volume listing the supported()
        check already paid for, handed to the launch that follows so the
        store is not scanned twice a wave.  Mirrors
        ``_schedule_pending_batch``'s envelope, conservatively: a streamed
        wave must be committable from its trace alone."""
        svc = self.svc
        fw = svc.framework
        if svc.use_batch not in ("auto", "force"):
            return "batch disabled", None
        if any(svc.framework_for(p) is not fw for p in pending):
            return "multi-profile", None
        # gang profiles park members at Permit and commit whole groups
        # atomically: a gang round must never interleave with a streamed
        # wave's commit, so both the profile shape and any parked waiting
        # pod drain the pipeline
        if fw.plugins["permit"] or svc._all_waiting_keys():
            return "gang", None
        if svc._pending_nominations():
            return "nominated pods", None
        eng = svc._engine_for(fw)
        if not eng.trace:
            # a trace-less engine cannot commit a wave from its result
            return "trace disabled", None
        if svc.use_batch == "auto" and len(pending) * max(len(nodes), 1) < svc.batch_min_work:
            return "below batch_min_work", None
        volumes = eng._volumes()
        ok, why = eng.supported(pending, nodes, volumes=volumes)
        if not ok:
            return f"unsupported: {why}", None
        return None, volumes

    @staticmethod
    def _node_fp(nodes: list[Obj]) -> tuple:
        return tuple((n["metadata"]["name"], n["metadata"].get("resourceVersion")) for n in nodes)

    # ---------------------------------------------------------- pipeline

    def _view_pods(self, binds: "dict[str, str]") -> list[Obj]:
        """The store's pods with the in-flight wave's placements applied as
        synthesized binds: what the next wave's encode must see.  Differs
        from the post-commit store only in resourceVersion (a cache key: the
        delta encoder re-checks such rows and produces identical values) and
        status/annotation fields the encoder never reads."""
        pods = self.svc.cluster_store.list("pods", copy_objects=False)
        if not binds:
            return pods
        out = []
        for p in pods:
            nn = binds.get(_pod_key(p))
            if nn is not None and not (p.get("spec") or {}).get("nodeName"):
                out.append({**p, "spec": {**(p.get("spec") or {}), "nodeName": nn}})
            else:
                out.append(p)
        return out

    def _dispatch(
        self,
        pending: list[Obj],
        nodes: list[Obj],
        base_counter: int,
        start_index: int,
        volumes: "dict | None",
        binds: "dict[str, str] | None" = None,
        prof_rec: "dict | None" = None,
    ) -> dict:
        """Encode + place + launch one wave (non-blocking); returns the
        in-flight record the commit step consumes.  ``volumes``: the listing
        the gate's supported() check already built; ``prof_rec``: the wave
        record opened at this wave's admission (the "admit" stage accrued
        there; encode/upload/dispatch accrue inside the engine)."""
        svc = self.svc
        fw = svc.framework
        eng = svc._engine_for(fw)
        ta = time.perf_counter()
        pods_view = self._view_pods(binds or {})
        namespaces = svc.cluster_store.list("namespaces", copy_objects=False)
        eng.profiler.note(prof_rec, "admit", time.perf_counter() - ta)
        pb = eng.schedule_async(
            nodes,
            pods_view,
            pending,
            namespaces,
            base_counter=base_counter,
            start_index=start_index,
            volumes=volumes if volumes is not None else eng._volumes(),
            prof_rec=prof_rec,
        )
        return {"pb": pb, "fw": fw, "keys": {_pod_key(p) for p in pending}, "node_fp": self._node_fp(nodes)}

    def _seq_failures(self) -> bool:
        """Would the serial path route kernel failures through PostFilter
        (preemption)?  Mirrors ``_run_segment_batch``'s seq_failures."""
        fw = self.svc.framework
        return bool(fw.plugins["post_filter"]) and self.svc.use_batch != "force"

    def _fetch_result(self, flight: dict) -> None:
        """Wait for the wave's compaction blob (its event: the last device
        interaction of a wave).  The blocked wait lands in
        ``stream_stall_s`` here; the result is cached, so ``_commit`` sees no
        further device wait.  A kernel error raised here propagates: nothing
        of the wave is committed yet."""
        pb = flight["pb"]
        dev0 = pb._dev_wait
        pb.result()
        self.svc.stats["stream_stall_s"] += pb._dev_wait - dev0

    def _commit(self, flight: dict, overlapped: bool) -> None:
        """Commit one streamed wave in strict order: trace, annotation
        rendering, bulk result-store fill, binds + reflector flush; the very
        same ``_replay_window`` / ``_commit_batch_wave`` machinery as the
        serial batch round, so the bytes are its bytes."""
        svc = self.svc
        fw = flight["fw"]
        pb = flight["pb"]
        t0 = time.perf_counter()
        dev0 = pb._dev_wait
        result = pb.result()
        # seconds of that window spent BLOCKED on the device are a stall,
        # not hidden work: kept out of the overlap bucket
        dev_wait = pb._dev_wait - dev0
        svc.stats["stream_stall_s"] += dev_wait
        if pb.promotion is not None:
            svc._count_promotion(pb.promotion)
        cnt = len(pb.pending)
        point_names = {
            p: [wp.original.name for wp in fw.plugins[p]]
            for p in ("pre_filter", "pre_score", "reserve", "permit", "pre_bind", "bind")
        }
        restart = svc._replay_window(
            result, 0, 0, cnt, None, point_names, fw,
            False,  # kernel failures commit from the trace (gated earlier)
            self.results, None, None,
        )
        assert restart is None, "streamed waves never request kernel restarts"
        fw.next_start_node_index = result.final_start
        svc._sync_rotation(fw)
        svc.stats["batch_commits"] += 1
        self._note_wave(cnt)
        dt = time.perf_counter() - t0
        if overlapped:
            # host seconds spent while the NEXT wave's kernel was in flight:
            # the pipeline's hidden work (minus the stalled part)
            svc.stats["stream_overlap_s"] += max(dt - dev_wait, 0.0)

    def _maybe_gc(self) -> None:
        """A full collection every ``gc_every_waves`` committed waves, always
        at a wave boundary (a kernel may be in flight: the pause hides in
        its shadow; what it must never do is land mid-wave)."""
        self._commits_since_gc += 1
        if self._commits_since_gc >= self.gc_every_waves:
            self._commits_since_gc = 0
            gc.collect()

    def _drain_round(self, reason: "str | None") -> None:
        """Drain the (empty) pipeline to the sequential path: one full
        scheduling round with its exact preemption / gang / nomination
        machinery, counted per reason."""
        if reason is not None:
            self._count_drain(reason)
        self.results.update(self.svc.schedule_pending(max_rounds=1))
        self._maybe_gc()

    # --------------------------------------------------------------- run

    def run(self) -> dict[str, Any]:
        svc = self.svc
        assert svc.framework is not None, "scheduler not started"
        # register with the service's quiesce machinery: an exclusive store
        # operation waits until every busy session has parked at a wave
        # boundary (svc.pause_streams)
        with svc._stream_cv:
            svc._stream_busy += 1
        self._t0 = time.perf_counter()
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            self._loop()
        finally:
            # the busy slot MUST come back even if the loop or the final
            # flush raises: a leaked count would make every later
            # pause_streams stall its full timeout and proceed without the
            # exclusivity it exists to provide
            try:
                if gc_was_enabled:
                    gc.enable()
                svc.reflector.flush_all(svc.cluster_store, skip_keys=svc._all_waiting_keys())
            finally:
                with svc._stream_cv:
                    svc._stream_busy -= 1
                    svc._stream_cv.notify_all()
        return self.results

    def _park_for_pause(self) -> None:
        """An exclusive store operation asked for the pipeline idle: count
        ONE drain under its reason, hand back the busy slot, and block until
        the pause lifts.  Runs only at a wave boundary: the pipeline is
        empty here, so the operation never interleaves with a wave commit."""
        svc = self.svc
        with svc._stream_cv:
            reason = svc._stream_pause_reason
            if reason is None:
                return
            self._count_drain(reason)
            svc._stream_busy -= 1
            svc._stream_cv.notify_all()
            # no timeout: the pauser's own wait is the bounded one; a
            # session resuming early would re-enter a launch inside the
            # exclusive window, which is what the gate exists to prevent
            svc._stream_cv.wait_for(lambda: svc._stream_pause_reason is None)
            svc._stream_busy += 1

    def _waves_left(self, in_flight: int = 0) -> bool:
        """May another streamed wave be LAUNCHED?  ``in_flight`` counts
        launched-but-uncommitted waves (the overlap prefetch point has one),
        which the committed-wave counter has not seen yet."""
        return self.max_waves is None or self._session_waves + in_flight < self.max_waves

    def _loop(self) -> None:
        svc = self.svc
        flight: "dict | None" = None  # the in-flight wave
        while True:
            if flight is None:
                # an exclusive store operation may be waiting on the
                # pipeline: park here, at the empty-pipeline boundary
                if svc._stream_pause_reason is not None:
                    self._park_for_pause()
                    continue
                # pipeline empty: admit and launch without overlap.  The
                # wave budget is checked BEFORE the admission tick: _admit()
                # pulls the feed (store side effects), and a capped session
                # must not consume a tick it will never schedule
                if not self._waves_left():
                    break
                # the wave record opens at the wave's first host touch;
                # abandoned records (empty admission, gated round) are dropped
                rec = svc.profiler.open()
                ta = time.perf_counter()
                # ambient record: the feed tick's store writes and the queue
                # carve-out stamp into THIS wave while it admits
                svc.profiler.current = rec
                try:
                    pending = self._admit(frozenset())
                    gate = volumes = nodes = None
                    if pending:
                        nodes = svc.cluster_store.list("nodes", copy_objects=False)
                        gate, volumes = self._gate(pending, nodes)
                finally:
                    svc.profiler.current = None
                if not pending:
                    if not self._admitting():
                        break
                    time.sleep(self.idle_sleep_s)
                    continue
                if gate is not None:
                    self._drain_round(gate)
                    continue
                # exclusive of the sub-stages carved out above: the record's
                # stage vector stays a partition of its wall
                svc.profiler.note_excl(rec, "admit", time.perf_counter() - ta)
                fw = svc.framework
                flight = self._dispatch(
                    pending, nodes, fw.sched_counter, fw.next_start_node_index, volumes, prof_rec=rec,
                )
                continue

            # a wave is in flight: learn its decisions (small fetch)
            pb = flight["pb"]
            t0 = time.perf_counter()
            pb.decisions()
            svc.stats["stream_stall_s"] += time.perf_counter() - t0
            n_fail = int((pb.selected[: len(pb.pending)] < 0).sum())
            if n_fail and self._seq_failures():
                # a PostFilter could preempt (victim deletes, restarts):
                # outside the streamable envelope.  Nothing of this wave is
                # committed: abandon its device work and hand the SAME pods
                # to the exact sequential round
                flight = None
                self._drain_round("kernel failures (preemption path)")
                continue
            if n_fail and self.streaming:
                # trace-committable failures (force mode / no PostFilter)
                # still stream their commit, but the BOUNDARY serializes: a
                # failed pod re-enters the queue at its commit, and the next
                # admission must observe that requeue exactly when the serial
                # path would.  Commit first, admit after
                self._count_drain("kernel failures")
                self._fetch_result(flight)
                self._commit(flight, overlapped=False)
                flight = None
                self._maybe_gc()
                continue

            next_flight: "dict | None" = None
            if svc._stream_pause_reason is not None:
                # an exclusive store operation is waiting: skip the overlap
                # prefetch, commit wave k below, and park at the loop top
                # (the drain is counted there)
                pass
            elif self.streaming and self._waves_left(in_flight=1) and svc.queue.has_unschedulable():
                # a pod parked in unschedulableQ could be reactivated by wave
                # k's commit events (binds fire move_all): the serial cadence
                # admits it into wave k+1, so an overlap admission taken
                # BEFORE the commit would miss it.  Serialize this boundary:
                # commit first, admit on the next pipeline-empty pass (no
                # feed tick is consumed here)
                self._count_drain("unschedulable requeue")
            elif self.streaming and self._waves_left(in_flight=1):
                rec2 = svc.profiler.open()
                ta2 = time.perf_counter()
                svc.profiler.current = rec2
                try:
                    pending2 = self._admit(flight["keys"])
                    gate = volumes = nodes = None
                    if pending2:
                        nodes = svc.cluster_store.list("nodes", copy_objects=False)
                        gate, volumes = self._gate(pending2, nodes)
                finally:
                    svc.profiler.current = None
                if pending2:
                    if gate is None and self._node_fp(nodes) != flight["node_fp"]:
                        # the cluster changed under the in-flight wave: drain
                        # the pipeline (commit first, re-encode on the
                        # settled store); counted here because the
                        # re-admission sees a CONSISTENT node set and streams
                        gate = "node/config change"
                        self._count_drain(gate)
                    if gate is None:
                        # overlap: wave k+1's encode + place + launch runs
                        # against wave k's synthesized placements, with the
                        # counters the serial path reaches after wave k
                        sel = pb.selected
                        binds = {}
                        for j, p in enumerate(pb.pending):
                            s = int(sel[j])
                            if s >= 0:
                                binds[_pod_key(p)] = pb.node_names[s]
                        fw = flight["fw"]
                        svc.profiler.note_excl(rec2, "admit", time.perf_counter() - ta2)
                        t0 = time.perf_counter()
                        next_flight = self._dispatch(
                            pending2, nodes, fw.sched_counter + len(pb.pending), pb.final_start, volumes,
                            binds=binds, prof_rec=rec2,
                        )
                        svc.stats["stream_overlap_s"] += time.perf_counter() - t0
                    else:
                        # gated waves are NOT admitted into the overlap; the
                        # next pipeline-empty pass re-drains the SAME pods
                        # (feed tick held) and routes them: through
                        # _drain_round for sequential-path gates, or a fresh
                        # streamed launch after a node change
                        self._feed_hold = True

            # commit wave k, overlapping wave k+1's kernel when one was
            # launched (serial mode never prefetches, so the same commit
            # machinery runs un-overlapped)
            self._fetch_result(flight)
            self._commit(flight, overlapped=next_flight is not None)
            flight = next_flight
            self._maybe_gc()
