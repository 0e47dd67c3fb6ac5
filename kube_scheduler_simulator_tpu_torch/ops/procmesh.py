"""The scan ensemble: worker processes that run the engine's scans, the
``KSS_MESH_PROCESSES`` opt-in.

Port of the JAX package's ``ops/procmesh.py``.  ``KSS_MESH_PROCESSES=N``
(N >= 1) asks the batch engine to run its one-launch scans (a round's, a
streamed wave's) on an ensemble of N worker processes
(``ops/procmesh_worker.py``) on the engine's own device, the parent
driving them over pipes.  Workers load their kernel libraries from the
kernel-library cache and never compile, so the ensemble requires the cache
(``KSS_AOT_CACHE_DIR``; without it the engine counts ``aot_cache_disabled``
and runs in-process).  The scan's outputs come back as host numpy; the
parent puts them on its device and runs the trace compaction (K3) itself.

The pool ENGAGES only after a three-stage bring-up, each stage a counted
fallback to the in-process scan when it fails:

1. spawn and the init handshake from every worker
   (``distributed_init_unavailable: <reason>``);
2. the probe: a computation on the worker's device for N=1, a gloo
   ``all_gather`` round trip across the ranks for N>=2 (``probe_timeout``,
   ``collectives_unavailable: <reason>``);
3. per-scan resolution on every worker (``artifact_missing:<reasons>``
   for a missing or rejected cache entry; ``sharded_scan_unported`` for
   N>=2: the node axis sharded over the ranks is not ported yet).

The reference falls back to its in-process virtual mesh; the port falls
back to the in-process scan on the engine's one device.

Dispatch is split as in the reference: ``run`` writes the command frames
and returns a handle, and reading the reply is the fetch.

**Supervision**: every reply wait classifies its outcome, ``ok`` /
``died`` (EOF or a reaped pid) / ``hang`` (the pid alive but STOPPED, state
``T`` or ``t`` in ``/proc/<pid>/stat``, for a full
``KSS_PROCMESH_HEARTBEAT_S``) / ``timeout``.  On a failure the straggler
alone is SIGKILLed (SIGCONT first, so a stopped process never wedges the
reaper), the healthy members are asked to quit, and a replacement ensemble
respawns with a bumped generation, re-loading every scan it had loaded
from the cache.  The wave in flight is abandoned before anything of it
is committed and dispatched once more on the fresh ensemble (counted
``retry_attempts_total{seam="procmesh"}``).  ``KSS_PROCMESH_MAX_RESPAWNS``
consecutive ensemble failures with no successful wave between them open
the :class:`~resilience.policy.Breaker` (``breaker_open``): the pool is
closed and the engine scans in-process from then on.

A worker that answers a run with an error is alive and its pipe clean, so
it is not respawned.  A kernel's own failure there (``KernelLaunchError``,
``KernelArgumentError``) or a library's (``KernelBuildError``) is raised in
the parent, as the in-process scan raises it, never degraded; any other
error is counted ``worker_error:<type>`` and the wave runs in-process.

``snapshot()`` feeds ``metrics()["procmesh"]`` and ``/metrics``; every
fallback reason, respawn, detected hang and breaker transition is counted
there.  An ``atexit`` reaper SIGCONT+SIGKILLs any worker still alive at
interpreter exit.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import select
import signal
import socket
import subprocess
import threading
import time
from typing import Any

from kube_scheduler_simulator_tpu_torch.ops.procmesh_worker import command, environment, read_frame, write_frame
from kube_scheduler_simulator_tpu_torch.resilience import Breaker, note_retry

_ENV = "KSS_MESH_PROCESSES"


def procs_from_env() -> int:
    """The ``KSS_MESH_PROCESSES`` knob: 0 = disabled (default)."""
    raw = os.environ.get("KSS_MESH_PROCESSES", "").strip()
    if not raw:
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{_ENV} must be a positive integer, got {raw!r}")
    if n < 0:
        raise ValueError(f"{_ENV} must be >= 0, got {n}")
    return n


def timeout_from_env() -> float:
    """``KSS_PROCMESH_TIMEOUT_S`` (default 30): the budget of a bring-up
    and of each reply wait, in seconds."""
    return float(os.environ.get("KSS_PROCMESH_TIMEOUT_S", "30"))


def heartbeat_from_env() -> float:
    """``KSS_PROCMESH_HEARTBEAT_S`` (default 1.0): how long a worker may
    sit in the STOPPED state mid-wait before it is declared hung (and how
    long an idle ``heartbeat()`` probe waits a worker)."""
    raw = os.environ.get("KSS_PROCMESH_HEARTBEAT_S", "").strip()
    if not raw:
        return 1.0
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"KSS_PROCMESH_HEARTBEAT_S must be a number, got {raw!r}")
    if v <= 0:
        raise ValueError(f"KSS_PROCMESH_HEARTBEAT_S must be > 0, got {raw!r}")
    return v


def max_respawns_from_env() -> int:
    """``KSS_PROCMESH_MAX_RESPAWNS`` (default 3): the breaker's threshold,
    consecutive ensemble failures with no successful wave between them."""
    raw = os.environ.get("KSS_PROCMESH_MAX_RESPAWNS", "").strip()
    if not raw:
        return 3
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"KSS_PROCMESH_MAX_RESPAWNS must be an integer, got {raw!r}")
    if v < 1:
        raise ValueError(f"KSS_PROCMESH_MAX_RESPAWNS must be >= 1, got {v}")
    return v


def pool_device(device: Any = None) -> str:
    """The device a pool's workers run on: the engine's, the card unless
    the caller asks for the CPU (``device.resolve_device``), with a card's
    index made explicit (a worker is told exactly which card)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------- orphan reaping

_CHILD_MU = threading.Lock()
_CHILDREN: "set[Any]" = set()


def _register_child(proc: Any) -> None:
    with _CHILD_MU:
        _CHILDREN.add(proc)


def _forget_child(proc: Any) -> None:
    with _CHILD_MU:
        _CHILDREN.discard(proc)


def _terminate(proc: Any, timeout: float = 5.0) -> None:
    """SIGCONT → SIGKILL → reap: the teardown that is safe against a
    SIGSTOP'd worker."""
    try:
        if proc.poll() is None:
            with contextlib.suppress(OSError):
                os.kill(proc.pid, signal.SIGCONT)
            proc.kill()
        proc.wait(timeout=timeout)
        _forget_child(proc)
    except Exception:  # noqa: BLE001 - teardown never raises
        pass


def _reap_orphans() -> None:
    """atexit backstop: no worker survives the parent."""
    with _CHILD_MU:
        procs = list(_CHILDREN)
    for p in procs:
        _terminate(p, timeout=2.0)


atexit.register(_reap_orphans)


class _Worker:
    """One ensemble member: the subprocess plus its two pipe ends."""

    def __init__(self, rank: int, nprocs: int, coordinator: str, generation: int, device: str):
        r, w = os.pipe()
        os.set_inheritable(w, True)
        try:
            self.proc = subprocess.Popen(
                command(rank, nprocs, coordinator, w, generation, device),
                stdin=subprocess.PIPE,
                pass_fds=(w,),
                env=environment(os.environ),
                cwd=os.getcwd(),
            )
        except BaseException:
            os.close(r)
            raise
        finally:
            os.close(w)
        _register_child(self.proc)
        self.rank = rank
        self.generation = generation
        self.rfd = r
        self.rfile = os.fdopen(r, "rb")

    def send(self, msg: dict) -> int:
        return write_frame(self.proc.stdin, msg)

    def stat_state(self) -> "str | None":
        """The one-char process state of ``/proc/<pid>/stat`` (``T``/``t``:
        stopped or traced): how supervision tells a SIGSTOP'd worker (alive,
        never replying) from a dead one."""
        try:
            with open(f"/proc/{self.proc.pid}/stat", "rb") as f:
                data = f.read()
            return data.rsplit(b")", 1)[1].split()[0].decode("ascii")
        except Exception:  # noqa: BLE001 - a vanished pid reads as unknown
            return None

    def recv_classified(self, deadline: float, heartbeat_s: "float | None") -> "tuple[dict | None, str]":
        """One reply frame and a verdict: ``ok`` (frame read), ``died``
        (EOF, a broken frame, a reaped pid), ``hang`` (alive but STOPPED for
        a full heartbeat), ``timeout`` (the budget spent, the worker alive
        and runnable)."""
        stopped_since: "float | None" = None
        while True:
            now = time.monotonic()
            budget = deadline - now
            if budget <= 0:
                return None, "timeout"
            ready, _, _ = select.select([self.rfd], [], [], min(budget, 0.25))
            if ready:
                try:
                    msg = read_frame(self.rfile)
                except Exception:  # noqa: BLE001 - a torn frame is a dead worker
                    return None, "died"
                if msg is None:
                    return None, "died"
                return msg, "ok"
            if self.proc.poll() is not None:
                return None, "died"
            if heartbeat_s is not None:
                if self.stat_state() in ("T", "t"):
                    if stopped_since is None:
                        stopped_since = now
                    elif now - stopped_since >= heartbeat_s:
                        return None, "hang"
                else:
                    stopped_since = None

    def recv(self, deadline: float) -> "dict | None":
        """One reply frame, or None on timeout, EOF or a dead worker."""
        msg, _verdict = self.recv_classified(deadline, None)
        return msg

    def kill(self) -> None:
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
        except Exception:  # noqa: BLE001 - a severed pipe is already closed
            pass
        _terminate(self.proc)
        try:
            self.rfile.close()
        except Exception:  # noqa: BLE001
            pass


class ProcMeshPool:
    """The live ensemble: lockstep command broadcast, rank 0's outputs.

    One dispatcher drives it (the scheduling thread, as the device queue it
    stands in for); ``_mu`` only guards teardown racing a dispatch from the
    metrics and atexit paths.  ``device``: the parent engine's device, on
    which every worker runs (``pool_device``: the card unless "cpu")."""

    def __init__(self, nprocs: int, timeout_s: float, heartbeat_s: float = 1.0, max_respawns: int = 3,
                 device: Any = None):
        self.nprocs = nprocs
        self.timeout_s = timeout_s
        self.heartbeat_s = float(heartbeat_s)
        self.device = pool_device(device)
        self.coordinator = f"127.0.0.1:{_free_port()}"
        self.workers: list[_Worker] = []
        self.dead = False
        self.dispatches = 0
        self.generation = 0  # bumped a respawned ensemble
        # key -> (meta, cache_dir): what a replacement ensemble re-loads
        self.loaded: dict[str, tuple[dict, str]] = {}
        self.respawns = 0
        self.respawn_s = 0.0  # seconds spent replacing ensembles, summed
        self.hangs_detected = 0
        self.failures_by_verdict: dict[str, int] = {}
        # consecutive ensemble failures open the breaker (cooldown_s=None:
        # it never half-opens, re-probing a broken ensemble every wave
        # would stall scheduling)
        self.breaker = Breaker(fail_threshold=max_respawns, cooldown_s=None)
        self._mu = threading.Lock()
        self._inflight = 0
        # what the workers reported: kernel launches and degrades of their
        # runs, library builds and loads of their scan loads, and the last
        # run's transport and seconds
        self.worker_launches: dict[str, int] = {}
        self.worker_degrades: dict[str, int] = {}
        self.worker_builds: dict[str, int] = {}
        self.last_run: dict[str, Any] = {}
        # runs a live worker answered with an error, by exception type, and
        # the last one's reason
        self.worker_errors: dict[str, int] = {}
        self.last_error: "str | None" = None

    # ----------------------------------------------------------- bring-up

    def _spawn(self) -> None:
        self.workers = [
            _Worker(i, self.nprocs, self.coordinator, self.generation, self.device) for i in range(self.nprocs)
        ]

    def start(self) -> "str | None":
        """Spawn, handshake and probe; returns a fallback reason (the pool
        unusable and already torn down) or None (engaged)."""
        deadline = time.monotonic() + self.timeout_s
        try:
            self._spawn()
        except Exception as e:  # noqa: BLE001 - counted by the caller
            self.close()
            return f"spawn_failed: {type(e).__name__}"
        for w in self.workers:
            hello = w.recv(deadline)
            if not hello or not hello.get("ok"):
                reason = (hello or {}).get("reason", "init timeout")
                self.close()
                return f"distributed_init_unavailable: {reason}"
        replies = self._lockstep({"cmd": "probe"}, deadline=deadline)
        if replies is None:
            self.close()
            return "probe_timeout"
        bad = [r for r in replies if not r.get("ok")]
        if bad:
            self.close()
            return f"collectives_unavailable: {bad[0].get('reason', '?')}"
        return None

    def _lockstep(self, msg: dict, deadline: "float | None" = None) -> "list[dict] | None":
        """Broadcast one command and collect one reply a worker in rank
        order; None (and a dead pool) on any timeout or EOF.  The
        unsupervised form, for bring-up and respawn, where a failure means
        the candidate ensemble is unusable."""
        if self.dead:
            return None
        if deadline is None:
            deadline = time.monotonic() + self.timeout_s
        try:
            for w in self.workers:
                w.send(msg)
        except Exception:  # noqa: BLE001 - a broken pipe: the ensemble is gone
            self.close()
            return None
        out = []
        for w in self.workers:
            r = w.recv(deadline)
            if r is None:
                self.close()
                return None
            out.append(r)
        return out

    # -------------------------------------------------------- supervision

    def _handle_worker_failure(self, w: "_Worker | None", verdict: str) -> bool:
        """A worker failed a wait (``died`` / ``hang`` / ``timeout``):
        SIGKILL it alone (SIGCONT first), count the failure
        against the breaker and, unless the breaker just opened, respawn.
        True when the caller may dispatch again on the fresh ensemble."""
        if self.dead:
            return False
        if verdict == "hang":
            self.hangs_detected += 1
        self.failures_by_verdict[verdict] = self.failures_by_verdict.get(verdict, 0) + 1
        self.breaker.failure()
        if w is not None:
            w.kill()
        if self.breaker.state == Breaker.OPEN:
            count_run_fallback("breaker_open")
            self.close()
            return False
        return self._respawn()

    def _respawn(self) -> bool:
        """Replace the whole ensemble: quit the survivors, reap the rest,
        spawn N fresh workers on a fresh coordinator, handshake and probe,
        and re-load every scan loaded so far (from the cache: a worker
        never compiles)."""
        t0 = time.perf_counter()
        for ow in self.workers:
            if ow.proc.poll() is None:
                with contextlib.suppress(Exception):
                    ow.send({"cmd": "quit"})
        for ow in self.workers:
            ow.kill()
        self.generation += 1
        self.coordinator = f"127.0.0.1:{_free_port()}"
        deadline = time.monotonic() + self.timeout_s
        try:
            self._spawn()
        except Exception:  # noqa: BLE001 - counted
            count_run_fallback("respawn_failed")
            self.close()
            return False
        for w in self.workers:
            hello = w.recv(deadline)
            if not hello or not hello.get("ok"):
                count_run_fallback("respawn_failed")
                self.close()
                return False
        replies = self._lockstep({"cmd": "probe"}, deadline=deadline)
        if replies is None or any(not r.get("ok") for r in replies):
            count_run_fallback("respawn_failed")
            self.close()
            return False
        for key, (meta, cache_dir) in list(self.loaded.items()):
            replies = self._lockstep({"cmd": "load_scan", "key": key, "meta": meta, "cache_dir": cache_dir})
            if replies is None or any(not r.get("ok") for r in replies):
                count_run_fallback("respawn_failed")
                self.close()
                return False
            self._note_load(replies)
        self.respawns += 1
        self.respawn_s += time.perf_counter() - t0
        note_retry("procmesh")
        return True

    def heartbeat(self) -> bool:
        """Idle liveness probe: one ping a worker, each bounded by the
        heartbeat.  A straggler goes through the same supervision as a
        failure mid-wave.  True = every worker answered."""
        if self.dead or self._inflight:
            return not self.dead
        failed: "tuple[_Worker, str] | None" = None
        try:
            for w in self.workers:
                w.send({"cmd": "ping"})
        except Exception:  # noqa: BLE001 - a broken pipe: that worker died
            failed = (w, "died")
        if failed is None:
            # the budget must exceed heartbeat_s, or the wait times out
            # before a stopped worker earns its ``hang`` verdict
            deadline = time.monotonic() + max(2.5 * self.heartbeat_s, 1.0) * self.nprocs
            for w in self.workers:
                r, verdict = w.recv_classified(deadline, self.heartbeat_s)
                if r is None or not r.get("ok"):
                    failed = (w, verdict if r is None else "died")
                    break
        if failed is None:
            self.breaker.success()
            return True
        return self._handle_worker_failure(*failed)

    # ----------------------------------------------------------- dispatch

    def _note_load(self, replies: list) -> None:
        for r in replies:
            for k, n in (r.get("builds") or {}).items():
                self.worker_builds[k] = self.worker_builds.get(k, 0) + n

    def load_scan(self, key: str, meta: dict, cache_dir: str) -> "str | None":
        """Resolve the scan of ``meta`` on every worker; returns a fallback
        reason or None.  Memoized a pool; a worker lost mid-load goes
        through supervision (respawn, one retry) before the caller falls
        back."""
        if key in self.loaded:
            return None
        for _attempt in range(2):
            if self.dead:
                return "worker_lost"
            failed: "tuple[_Worker | None, str] | None" = None
            try:
                for w in self.workers:
                    w.send({"cmd": "load_scan", "key": key, "meta": meta, "cache_dir": cache_dir})
            except Exception:  # noqa: BLE001 - a broken pipe: that worker died
                failed = (w, "died")
            replies: list[dict] = []
            if failed is None:
                deadline = time.monotonic() + self.timeout_s
                for w in self.workers:
                    r, verdict = w.recv_classified(deadline, self.heartbeat_s)
                    if r is None:
                        failed = (w, verdict)
                        break
                    replies.append(r)
            if failed is None:
                bad = [r for r in replies if not r.get("ok")]
                if bad:
                    return str(bad[0].get("reason", "artifact_missing"))
                self._note_load(replies)
                self.loaded[key] = (meta, cache_dir)
                return None
            if not self._handle_worker_failure(*failed):
                return "worker_lost"
            # respawned: the fresh ensemble re-loaded ``loaded``, but this
            # key never landed; retry it once
        return "worker_lost"

    def run(self, key: str, payload: dict) -> "_PendingRun | None":
        """Write the ``run`` frames and return the handle whose ``fetch``
        blocks for the reply.  A worker lost mid-write goes through
        supervision; None when the ensemble is (or just went) unusable:
        the wave then runs in-process, never an error."""
        if self.dead or self._inflight:
            return None
        for _attempt in range(2):
            failed: "tuple[_Worker, str] | None" = None
            t0 = time.perf_counter()
            sent = 0
            try:
                for w in self.workers:
                    sent += w.send({"cmd": "run", "key": key, **payload})
            except Exception:  # noqa: BLE001 - a broken pipe: that worker died
                failed = (w, "died")
            if failed is None:
                self.dispatches += 1
                self._inflight = 1
                self.last_run = {"ship_bytes": sent, "ship_s": time.perf_counter() - t0}
                return _PendingRun(self, key, payload)
            if not self._handle_worker_failure(*failed):
                return None
            # respawned mid-send: dispatch the wave again on the fresh
            # ensemble
        return None

    def _worker_error(self, r: dict) -> dict:
        """A run that a live worker answered with an error (its scan raised;
        its pipe holds nothing more): no respawn.  A kernel's own failure or
        a library's is raised here as the in-process scan raises it; any
        other error is counted ``worker_error:<type>`` and returned, and
        the caller scans in-process."""
        err = str(r.get("error", "?"))
        self.worker_errors[err] = self.worker_errors.get(err, 0) + 1
        self.last_error = str(r.get("reason"))
        kind = r.get("kernel_error")
        if kind in ("KernelArgumentError", "KernelLaunchError", "KernelBuildError"):
            from kube_scheduler_simulator_tpu_torch.ops import kernels as K

            raise getattr(K, kind)(f"in the scan worker: {self.last_error}")
        count_run_fallback(f"worker_error:{err}")
        return r

    def close(self) -> None:
        with self._mu:
            if self.dead:
                return
            self.dead = True
        for w in self.workers:
            w.kill()

    def snapshot(self) -> dict:
        return {
            "processes": self.nprocs,
            "engaged": int(not self.dead),
            "dispatches": self.dispatches,
            "scans_loaded": len(self.loaded),
            "respawns": self.respawns,
            "respawn_s": self.respawn_s,
            "hangs_detected": self.hangs_detected,
            "generation": self.generation,
            "failures_by_verdict": dict(self.failures_by_verdict),
            "breaker_state": self.breaker.state,
            "breaker_state_code": self.breaker.state_code,
            "breaker_transitions": dict(self.breaker.stats),
            "device": self.device,
            "worker_launches": dict(self.worker_launches),
            "worker_degrades": dict(self.worker_degrades),
            "worker_builds": dict(self.worker_builds),
            "last_run": dict(self.last_run),
            "worker_errors": dict(self.worker_errors),
            "last_error": self.last_error,
        }


class _PendingRun:
    """The dispatch in flight; ``fetch`` is the block point.

    It keeps the wave's key and payload, so a worker failure mid-wave
    abandons the dispatch before anything of it is committed and
    dispatches the same wave again on the respawned ensemble: nothing of
    the failed attempt is ever observable."""

    def __init__(self, pool: ProcMeshPool, key: str, payload: dict):
        self.pool = pool
        self.key = key
        self.payload = payload
        self._redispatched = 0

    def fetch(self) -> "dict | None":
        """Rank 0's reply (``out``: the scan's outputs as numpy); a worker's
        error reply (``ok`` False, counted by ``_worker_error``, which
        raises a kernel's or a library's failure); or None when the wave
        could not complete on the ensemble."""
        pool = self.pool
        pool._inflight = 0
        t0 = time.perf_counter()
        deadline = time.monotonic() + pool.timeout_s
        replies: list[dict] = []
        failed: "tuple[_Worker, str] | None" = None
        for w in pool.workers:
            r, verdict = w.recv_classified(deadline, pool.heartbeat_s)
            if r is None:
                failed = (w, verdict)
                break
            replies.append(r)
        if failed is None:
            bad = [r for r in replies if not r.get("ok")]
            if bad:
                return pool._worker_error(bad[0])
            reply = replies[0]
            pool.breaker.success()
            for table, got in ((pool.worker_launches, reply.get("launches")),
                               (pool.worker_degrades, reply.get("degrades"))):
                for k, n in (got or {}).items():
                    table[k] = table.get(k, 0) + n
            pool.last_run.update(wait_s=time.perf_counter() - t0, worker=dict(reply.get("seconds") or {}),
                                 reply_bytes=sum(v.nbytes for v in reply["out"].values()))
            return reply
        # supervision runs on every failed wait: a retried wave's second
        # failure must still replace the ensemble, or a stale reply of the
        # aborted dispatch would sit in a pipe and corrupt the next read
        recovered = pool._handle_worker_failure(*failed)
        if self._redispatched == 0 and recovered:
            # the wave was abandoned before its commit: dispatch it whole
            # on the fresh ensemble, once
            self._redispatched = 1
            handle = pool.run(self.key, self.payload)
            if handle is not None:
                handle._redispatched = 1
                return handle.fetch()
        return None


# --------------------------------------------------------- module state

_LOCK = threading.Lock()
_POOL: "ProcMeshPool | None" = None
_VERDICT: "str | None" = None  # memoized bring-up fallback reason
_STATS: dict = {
    "requested_processes": 0,
    "fallbacks_by_reason": {},
    "run_fallbacks_by_reason": {},
}


def _count(table: str, reason: str) -> None:
    d = _STATS[table]
    d[reason] = d.get(reason, 0) + 1


def acquire(device: Any = None) -> "ProcMeshPool | None":
    """The engine's entry point: the shared pool when ``KSS_MESH_PROCESSES``
    is set and bring-up succeeded, else None with the reason counted.
    Bring-up runs once a process (the verdict is memoized: a broken
    ensemble is not re-probed an engine).  ``device``: the engine's device,
    the card unless "cpu" (``pool_device``); an engine on another device
    than the pool's is refused (``device_mismatch``)."""
    global _POOL, _VERDICT
    n = procs_from_env()
    if n == 0:
        return None
    dev = pool_device(device)
    with _LOCK:
        _STATS["requested_processes"] = n
        if _POOL is not None and not _POOL.dead:
            if _POOL.device != dev:
                _count("run_fallbacks_by_reason", "device_mismatch")
                return None
            return _POOL
        if _VERDICT is not None:
            return None
        pool = ProcMeshPool(n, timeout_from_env(), heartbeat_s=heartbeat_from_env(),
                            max_respawns=max_respawns_from_env(), device=dev)
        reason = pool.start()
        if reason is not None:
            _VERDICT = reason
            _count("fallbacks_by_reason", reason)
            return None
        _POOL = pool
        return pool


def count_run_fallback(reason: str) -> None:
    """A dispatch-time degrade (the pool lost mid-wave, a scan that cannot
    be resolved, the breaker opened): counted, and the engine runs the
    scan in-process, never a partial commit."""
    with _LOCK:
        _count("run_fallbacks_by_reason", reason)


def stats() -> dict:
    with _LOCK:
        s = {
            "requested_processes": _STATS["requested_processes"],
            "fallbacks_by_reason": dict(_STATS["fallbacks_by_reason"]),
            "run_fallbacks_by_reason": dict(_STATS["run_fallbacks_by_reason"]),
            "verdict": _VERDICT,
        }
        s["pool"] = _POOL.snapshot() if _POOL is not None else None
        return s


def shutdown() -> None:
    global _POOL
    with _LOCK:
        if _POOL is not None:
            _POOL.close()
            _POOL = None
    _reap_orphans()


atexit.register(shutdown)


def reset() -> None:
    """Test and chaos hook: tear the pool down and clear the memoized
    verdict and the counters (harnesses that run several legs need a clean
    slate between them)."""
    global _VERDICT
    shutdown()
    with _LOCK:
        _VERDICT = None
        _STATS["requested_processes"] = 0
        _STATS["fallbacks_by_reason"] = {}
        _STATS["run_fallbacks_by_reason"] = {}
