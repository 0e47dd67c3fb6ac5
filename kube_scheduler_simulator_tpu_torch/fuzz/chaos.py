"""The chaos layer: inject mid-run faults the system must survive.

The scheduling engines promise that a kernel failure is never fatal and
never partial: a crashed dispatch, window fetch, or streamed
decision/result fetch degrades the round (or wave) to the sequential
path, byte-identical to a run where the crash never happened, with the
event counted (``batch_fallbacks`` / ``stream_drains_by_reason`` under
``kernel error: *``).  This module is the adversary that earns that
promise: a :class:`KernelChaos` context deterministically fails chosen
*device events* — every engine interaction gets a global sequence
number — and the differential runner then byte-compares the chaotic run
against a clean oracle.

Device events, in occurrence order across the whole context:

- ``schedule`` / ``schedule_async`` / ``schedule_waves`` — one event per
  engine call, ticked BEFORE dispatch (a failing event aborts with
  nothing committed);
- ``window`` — one per window fetched from a ``schedule_waves``
  iterator (failing event k leaves windows < k committed: the mid-round
  wave-restart shape);
- ``decisions`` / ``result`` — one per streamed fetch (failing before
  any of that wave committed).

Injection is via the service's ``_engine_for`` seam, so every profile
engine — and the stream session riding on it — sees the same chaos.  The
fault is raised in Python at the proxy, on the card as on the CPU: an
injected window fault may find window k+1 already launched, and the
degrade must still commit nothing of it.

:class:`ProcessChaos` is the second adversary, pointed at *process*
crashes instead of kernel crashes: it runs a scenario in a journaled
subprocess (state/journal.py), SIGKILLs it at a seeded journal-record
index, recovers in a fresh process (state/recovery.py), finishes the
scenario, and byte-diffs the full annotation trail against an
uninterrupted run — the same parity bar, extended across a crash
boundary.  Any divergence shrinks through the existing ddmin machinery
(fuzz/shrink.py) exactly like a kernel-chaos divergence.  Its children
run on ``device`` (the card unless the caller passes "cpu"); on the card
the parent builds the kernel libraries first and each child only loads
them (``kernels.build(compile=False)``), reporting its own
``compile_count`` delta over the scenario.  :class:`FailoverChaos` adds a
hot-standby follower, :class:`DiskChaos` faults the journal's writes;
:class:`WorkerChaos` kills, stops or cuts off a worker of the scan ensemble
(ops/procmesh.py) mid-run, and ``leaked_worker_pids`` is its no-leak bar.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
from typing import Any, Iterator

Obj = dict[str, Any]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ChaosError(RuntimeError):
    """The injected device fault (looks like any other kernel crash to
    the engines — they must not special-case it)."""


class _ChaosPendingBatch:
    """Wraps a PendingBatch so the streamed fetch points tick too."""

    def __init__(self, pb: Any, chaos: "KernelChaos"):
        object.__setattr__(self, "_pb", pb)
        object.__setattr__(self, "_chaos", chaos)

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_pb"), name)

    def decisions(self) -> Any:
        self._chaos._tick("decisions")
        return self._pb.decisions()

    def result(self) -> Any:
        self._chaos._tick("result")
        return self._pb.result()


class _ChaosEngineProxy:
    """Forwards everything to the real engine; the dispatch surface
    (schedule / schedule_async / schedule_waves / window fetches) ticks
    the chaos counter first."""

    def __init__(self, eng: Any, chaos: "KernelChaos"):
        object.__setattr__(self, "_eng", eng)
        object.__setattr__(self, "_chaos", chaos)

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_eng"), name)

    def schedule(self, *a: Any, **kw: Any) -> Any:
        self._chaos._tick("schedule")
        return self._eng.schedule(*a, **kw)

    def schedule_async(self, *a: Any, **kw: Any) -> Any:
        self._chaos._tick("schedule_async")
        return _ChaosPendingBatch(self._eng.schedule_async(*a, **kw), self._chaos)

    def schedule_waves(self, *a: Any, **kw: Any) -> Iterator:
        self._chaos._tick("schedule_waves")
        return self._chaos._wrap_windows(self._eng.schedule_waves(*a, **kw))


class KernelChaos:
    """Context manager failing the device events whose global sequence
    numbers are in ``fail_events``.  ``events`` counts all events seen,
    ``trips`` the injected failures — a test asserting chaos actually
    fired checks ``trips > 0``."""

    def __init__(self, svc: Any, fail_events: "frozenset[int] | set[int]" = frozenset({0})):
        self.svc = svc
        self.fail_events = frozenset(int(e) for e in fail_events)
        self.events = 0
        self.trips = 0
        self._orig: Any = None

    def _tick(self, what: str) -> None:
        e = self.events
        self.events += 1
        if e in self.fail_events:
            self.trips += 1
            raise ChaosError(f"injected kernel failure at device event #{e} ({what})")

    def _wrap_windows(self, gen: Iterator) -> Iterator:
        for item in gen:
            self._tick("window")
            yield item

    def __enter__(self) -> "KernelChaos":
        self._orig = self.svc._engine_for  # the bound method
        self.svc._engine_for = lambda fw: _ChaosEngineProxy(self._orig(fw), self)
        return self

    def __exit__(self, *exc: Any) -> None:
        # remove the instance attribute shadowing the class method
        self.svc.__dict__.pop("_engine_for", None)
        self._orig = None


# --------------------------------------------------------------- processes


class ProcessChaosError(RuntimeError):
    """The harness itself broke (a child failed to launch, recover, or
    report) — NOT a parity divergence."""


class ProcessChaos:
    """Kill-and-recover differential over one scenario.

    For each seeded kill record index, three subprocess legs run
    (:mod:`fuzz.crash_child`): the uninterrupted baseline (once), the
    journaled run SIGKILLed at the index, and the recovery that resumes
    and finishes the scenario.  The verdict's ``divergences`` lists the
    kill points whose recovered annotation trail differed from the
    baseline's — byte parity is the whole judgment, exactly as in the
    kernel-chaos and differential legs.

    ``kill_records`` are SEEDS, normalized into ``[1, records-1]``
    against the baseline's actual record count, so a caller can pin
    "early / middle / late" without knowing the run length.  ``role``
    overrides the child service configuration
    (:data:`fuzz.crash_child.DEFAULT_ROLE` — e.g. ``use_batch="auto"``
    to exercise the wave-atomic batch commit path, ``checkpoint_every``
    to exercise compaction mid-run).  ``device`` is the children's
    (None: the card).  ``child_compiles`` lists each reporting child's
    ``compile_count`` delta over its scenario (0 is the contract),
    ``child_launches`` sums their kernel launches and ``child_degrades``
    the kernel errors they degraded (``kernels.DEGRADES``; none is
    injected, so ``{}`` is the contract).
    """

    def __init__(
        self,
        scenario: Obj,
        kill_records: "tuple[int, ...] | list[int]" = (1,),
        role: "Obj | None" = None,
        child_timeout_s: float = 300.0,
        device: "str | None" = None,
    ):
        from kube_scheduler_simulator_tpu_torch.device import resolve_device

        self.scenario = scenario
        self.kill_records = tuple(int(k) for k in kill_records)
        self.role = dict(role or {})
        self.child_timeout_s = child_timeout_s
        self.device = str(resolve_device(device))
        self.child_compiles: list[int] = []
        self.child_launches: dict[str, int] = {}
        self.child_degrades: dict[str, int] = {}

    # ------------------------------------------------------------- children

    def _note_child(self, doc: Obj) -> None:
        self.child_compiles.append(int(doc.get("compiles", 0)))
        for k, n in (doc.get("launches") or {}).items():
            self.child_launches[k] = self.child_launches.get(k, 0) + int(n)
        for k, n in (doc.get("degrades") or {}).items():
            self.child_degrades[k] = self.child_degrades.get(k, 0) + int(n)

    def _prebuild(self) -> None:
        """On the card, build (or load) every kernel library here, once, so
        the children only load them and never race to build."""
        if self.device.startswith("cuda"):
            from kube_scheduler_simulator_tpu_torch.ops import kernels

            kernels.build()

    @staticmethod
    def _child_env() -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        return env

    def _child_argv(self, mode: str, journal_dir: str, plan_path: str, out_path: str) -> list:
        return [
            sys.executable,
            "-m",
            "kube_scheduler_simulator_tpu_torch.fuzz.crash_child",
            "--mode",
            mode,
            "--journal-dir",
            journal_dir,
            "--plan",
            plan_path,
            "--out",
            out_path,
            "--device",
            self.device,
        ]

    def _child(
        self, mode: str, journal_dir: str, plan_path: str, out_path: str
    ) -> subprocess.CompletedProcess:
        try:
            return self._exec(mode, journal_dir, plan_path, out_path, self._child_env())
        except subprocess.TimeoutExpired as e:
            raise ProcessChaosError(
                f"{mode} child hung past {self.child_timeout_s:.0f}s"
            ) from e

    def _exec(
        self, mode: str, journal_dir: str, plan_path: str, out_path: str, env: dict
    ) -> subprocess.CompletedProcess:
        return subprocess.run(
            self._child_argv(mode, journal_dir, plan_path, out_path),
            cwd=_REPO_ROOT,
            env=env,
            capture_output=True,
            timeout=self.child_timeout_s,
        )

    def _read_out(self, out_path: str, leg: str, proc: subprocess.CompletedProcess) -> Obj:
        try:
            with open(out_path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            raise ProcessChaosError(
                f"{leg} child produced no report (rc={proc.returncode}): "
                f"{proc.stderr.decode(errors='replace')[-2000:]}"
            ) from None
        self._note_child(doc)
        return doc

    # ------------------------------------------------------------------ run

    def run(self) -> Obj:
        """Execute the kill/recover differential; returns the verdict:
        ``{"scenario", "records", "kill_points", "divergences",
        "truncated_records", "partial_gangs", "first_mismatch"}``."""
        verdict: Obj = {
            "scenario": self.scenario.get("name", "scenario"),
            "kill_points": [],
            "divergences": [],
            "truncated_records": 0,
            "partial_gangs": 0,
            "replayed_records": 0,
            "first_mismatch": None,
        }
        self._prebuild()
        with tempfile.TemporaryDirectory(prefix="kss-crash-") as td:
            plan_path = os.path.join(td, "plan.json")
            with open(plan_path, "w", encoding="utf-8") as f:
                json.dump({"scenario": self.scenario, "role": self.role}, f, sort_keys=True)
            base_out = os.path.join(td, "baseline.json")
            proc = self._child("run", os.path.join(td, "jr-base"), plan_path, base_out)
            if proc.returncode != 0:
                raise ProcessChaosError(
                    f"baseline child rc={proc.returncode}: "
                    f"{proc.stderr.decode(errors='replace')[-2000:]}"
                )
            baseline = self._read_out(base_out, "baseline", proc)
            records = int(baseline["records"])
            verdict["records"] = records
            verdict["journal"] = dict(baseline.get("journal") or {})

            for seed_k in self.kill_records:
                # normalize the seed into a real mid-run record index
                k = 1 + (seed_k - 1) % max(records - 1, 1)
                verdict["kill_points"].append(k)
                jdir = os.path.join(td, f"jr-kill-{k}")
                kill_plan = os.path.join(td, f"plan-kill-{k}.json")
                with open(kill_plan, "w", encoding="utf-8") as f:
                    json.dump(
                        {"scenario": self.scenario, "role": self.role, "kill_at": k},
                        f,
                        sort_keys=True,
                    )
                crash_out = os.path.join(td, f"crash-{k}.json")
                proc = self._child("crash", jdir, kill_plan, crash_out)
                if proc.returncode != -signal.SIGKILL:
                    raise ProcessChaosError(
                        f"crash child at record {k} exited rc={proc.returncode} "
                        f"instead of dying by SIGKILL: "
                        f"{proc.stderr.decode(errors='replace')[-2000:]}"
                    )
                rec_out = os.path.join(td, f"recover-{k}.json")
                proc = self._child("recover", jdir, kill_plan, rec_out)
                if proc.returncode != 0:
                    raise ProcessChaosError(
                        f"recovery child at record {k} rc={proc.returncode}: "
                        f"{proc.stderr.decode(errors='replace')[-2000:]}"
                    )
                recovered = self._read_out(rec_out, f"recover@{k}", proc)
                stats = recovered.get("recovery") or {}
                verdict["truncated_records"] += int(stats.get("truncated_records", 0))
                verdict["partial_gangs"] += int(stats.get("partial_gangs", 0))
                verdict["replayed_records"] += int(stats.get("replayed_records", 0))
                if recovered["state"] != baseline["state"]:
                    verdict["divergences"].append(k)
                    if verdict["first_mismatch"] is None:
                        verdict["first_mismatch"] = _first_state_mismatch(
                            baseline["state"], recovered["state"], k
                        )
        return verdict


class FailoverChaos(ProcessChaos):
    """Kill-the-primary-mid-wave failover drill (replication/).

    A hot-standby ``--mode follow`` child runs CONCURRENTLY with the
    primary, tailing its live journal through a ``ReplicaApplier``.
    The parent coordinates via a marker file: once the primary exits —
    SIGKILLed at a seeded record index (the failover legs) or cleanly
    (the ``kill_records=()`` churn leg) — the parent creates the plan's
    ``promote_file`` and the follower promotes, resumes the scenario,
    and reports.  The verdict extends ProcessChaos's with the
    follower's ``max_lag`` (max post-drain backlog in records — one
    record == one commit wave, so the "within one wave" bar is
    ``max_lag <= 1``), ``torn_records`` and ``records_shipped``; byte
    parity of the promoted state against the uninterrupted baseline is
    the judgment, exactly as in the kill/recover differential.
    """

    def _spawn_follow(self, journal_dir: str, plan_path: str, out_path: str) -> subprocess.Popen:
        return subprocess.Popen(
            self._child_argv("follow", journal_dir, plan_path, out_path),
            cwd=_REPO_ROOT,
            env=self._child_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )

    def _follow_leg(
        self, td: str, tag: str, jdir: str, promote_file: str
    ) -> "tuple[subprocess.Popen, str]":
        plan_path = os.path.join(td, f"plan-follow-{tag}.json")
        with open(plan_path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "scenario": self.scenario,
                    "role": self.role,
                    "promote_file": promote_file,
                    "follow_deadline_s": self.child_timeout_s,
                },
                f,
                sort_keys=True,
            )
        out_path = os.path.join(td, f"follow-{tag}.json")
        return self._spawn_follow(jdir, plan_path, out_path), out_path

    def _join_follow(
        self, follower: subprocess.Popen, out_path: str, tag: str
    ) -> Obj:
        try:
            _stdout, stderr = follower.communicate(timeout=self.child_timeout_s)
        except subprocess.TimeoutExpired:
            follower.kill()
            follower.communicate()
            raise ProcessChaosError(f"follow child {tag} hung past {self.child_timeout_s:.0f}s")
        if follower.returncode != 0:
            raise ProcessChaosError(
                f"follow child {tag} rc={follower.returncode}: "
                f"{stderr.decode(errors='replace')[-2000:]}"
            )
        try:
            with open(out_path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            raise ProcessChaosError(f"follow child {tag} produced no report") from None
        self._note_child(doc)
        return doc

    def run(self) -> Obj:
        verdict: Obj = {
            "scenario": self.scenario.get("name", "scenario"),
            "kill_points": [],
            "divergences": [],
            "truncated_records": 0,
            "torn_records": 0,
            "partial_gangs": 0,
            "replayed_records": 0,
            "records_shipped": 0,
            "max_lag": 0,
            "promotions": 0,
            "first_mismatch": None,
        }
        self._prebuild()
        with tempfile.TemporaryDirectory(prefix="kss-failover-") as td:
            plan_path = os.path.join(td, "plan.json")
            with open(plan_path, "w", encoding="utf-8") as f:
                json.dump({"scenario": self.scenario, "role": self.role}, f, sort_keys=True)
            base_jdir = os.path.join(td, "jr-base")
            churn = not self.kill_records
            follower = follow_out = None
            promote_file = os.path.join(td, "promote-base")
            if churn:
                # the churn leg follows the BASELINE primary itself —
                # clean exit, then promotion must reproduce its state
                follower, follow_out = self._follow_leg(td, "base", base_jdir, promote_file)
            base_out = os.path.join(td, "baseline.json")
            proc = self._child("run", base_jdir, plan_path, base_out)
            if proc.returncode != 0:
                raise ProcessChaosError(
                    f"baseline child rc={proc.returncode}: "
                    f"{proc.stderr.decode(errors='replace')[-2000:]}"
                )
            baseline = self._read_out(base_out, "baseline", proc)
            records = int(baseline["records"])
            verdict["records"] = records
            if churn:
                with open(promote_file, "w", encoding="utf-8") as f:
                    f.write("promote\n")
                self._absorb(verdict, baseline, self._join_follow(follower, follow_out, "base"), 0)

            for seed_k in self.kill_records:
                k = 1 + (seed_k - 1) % max(records - 1, 1)
                verdict["kill_points"].append(k)
                jdir = os.path.join(td, f"jr-kill-{k}")
                promote_file = os.path.join(td, f"promote-{k}")
                follower, follow_out = self._follow_leg(td, str(k), jdir, promote_file)
                kill_plan = os.path.join(td, f"plan-kill-{k}.json")
                with open(kill_plan, "w", encoding="utf-8") as f:
                    json.dump(
                        {"scenario": self.scenario, "role": self.role, "kill_at": k},
                        f,
                        sort_keys=True,
                    )
                crash_out = os.path.join(td, f"crash-{k}.json")
                try:
                    proc = self._child("crash", jdir, kill_plan, crash_out)
                except ProcessChaosError:
                    follower.kill()
                    follower.communicate()
                    raise
                if proc.returncode != -signal.SIGKILL:
                    follower.kill()
                    follower.communicate()
                    raise ProcessChaosError(
                        f"crash child at record {k} exited rc={proc.returncode} "
                        f"instead of dying by SIGKILL: "
                        f"{proc.stderr.decode(errors='replace')[-2000:]}"
                    )
                with open(promote_file, "w", encoding="utf-8") as f:
                    f.write("promote\n")
                self._absorb(verdict, baseline, self._join_follow(follower, follow_out, str(k)), k)
        return verdict

    @staticmethod
    def _absorb(verdict: Obj, baseline: Obj, followed: Obj, kill_point: int) -> None:
        stats = followed.get("recovery") or {}
        promo = followed.get("promotion") or {}
        verdict["truncated_records"] += int(stats.get("truncated_records", 0))
        verdict["partial_gangs"] += int(stats.get("partial_gangs", 0))
        verdict["replayed_records"] += int(stats.get("replayed_records", 0))
        verdict["torn_records"] += int(promo.get("torn_records", 0))
        verdict["records_shipped"] += int(followed.get("records_shipped", 0))
        verdict["max_lag"] = max(verdict["max_lag"], int(followed.get("max_lag", 0)))
        verdict["promotions"] += 1
        if followed["state"] != baseline["state"]:
            verdict["divergences"].append(kill_point)
            if verdict["first_mismatch"] is None:
                verdict["first_mismatch"] = _first_state_mismatch(
                    baseline["state"], followed["state"], kill_point
                )


def _first_state_mismatch(a: list, b: list, kill_point: int) -> Obj:
    """The first differing parity row between two encoded states
    (fuzz.runner.encode_state lists) — triage context for a divergence."""
    da, db = dict((k, v) for k, v in a), dict((k, v) for k, v in b)
    for key in sorted(set(da) | set(db)):
        if da.get(key) != db.get(key):
            return {
                "kill_point": kill_point,
                "pod": key,
                "baseline": da.get(key),
                "recovered": db.get(key),
            }
    return {"kill_point": kill_point, "pod": None}


# ------------------------------------------------------------ fault matrix


def _env_scope(overrides: "dict[str, str | None]"):
    """Context manager applying env overrides (None = delete) and
    restoring the previous values on exit: the chaos legs flip the
    ensemble's and the cache's knobs a leg without leaking into the
    caller."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        saved = {k: os.environ.get(k) for k in overrides}
        try:
            for k, v in overrides.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return scope()


def leaked_worker_pids(proc_root: str = "/proc") -> list[int]:
    """Every live worker of the port's scan ensemble that this process
    started: a process whose command line holds the port's worker marker
    (``ops.procmesh_worker.MARKER``) and ``--owner <this pid>`` (zombies
    have no command line: they are reaped, not leaked).  The JAX package's
    workers are not counted, nor does its scan count the port's (their
    command lines do not hold the bytes ``ops.procmesh_worker``); nor are
    another process's, so concurrent test processes do not see each
    other's.  The no-leak bar every worker-fault leg ends on.
    ``proc_root``: the process table to read."""
    from kube_scheduler_simulator_tpu_torch.ops.procmesh_worker import MARKER

    owner = [b"--owner", str(os.getpid()).encode()]
    pids = []
    for entry in os.listdir(proc_root):
        if not entry.isdigit():
            continue
        try:
            with open(os.path.join(proc_root, entry, "cmdline"), "rb") as f:
                argv = f.read().split(b"\x00")
        except OSError:
            continue
        i = argv.index(b"--owner") if MARKER.encode() in argv and b"--owner" in argv else -1
        if i >= 0 and argv[i : i + 2] == owner:
            pids.append(int(entry))
    return pids


class WorkerChaos:
    """Supervised-ensemble differential: fault a worker of the scan
    ensemble mid-run, demand byte parity plus a counted recovery.

    Two legs over the same scenario (a ``{"name", "nodes", "pods"}`` dict
    of raw store objects), each a ``SchedulerService`` on ``device`` (the
    card unless the caller passes "cpu"):

    - the BASELINE runs in-process with the kernel-library cache on; on the
      card the process's libraries are saved into it, for the workers to
      load;
    - the CHAOS leg runs with ``KSS_MESH_PROCESSES`` engaged and
      ``ProcMeshPool.run`` wrapped so dispatch #``fault_at`` first injects
      the fault into a worker: ``kill`` SIGKILLs it, ``stop`` SIGSTOPs it
      (alive, never replying), ``sever`` writes half a frame header down
      its command pipe and closes it (the worker reads a short header and
      exits; the parent's next send fails).

    The supervisor must detect the fault (``died`` or ``hang``), SIGKILL the
    straggler alone, respawn the ensemble from the cache and dispatch the
    abandoned wave again: the verdict's bar is ``divergences == []`` and a
    counted recovery (``respawns``, ``hangs_detected``, a run-fallback
    reason).  Where the ensemble cannot engage, the verdict says so
    (``engaged == 0`` with the counted bring-up reason) and the no-leak
    check still applies.  ``clean_leg=True`` first runs the ensemble once
    without the fault and reports both legs' library builds and loads in
    this process (``analysis.RecompileGuard``)."""

    def __init__(
        self,
        scenario: Obj,
        mode: str = "kill",
        fault_at: int = 1,
        worker_rank: int = 0,
        nprocs: int = 1,
        heartbeat_s: float = 0.3,
        timeout_s: float = 120.0,
        role: "Obj | None" = None,
        clean_leg: bool = False,
        device: "str | None" = None,
    ):
        from kube_scheduler_simulator_tpu_torch.device import resolve_device

        if mode not in ("kill", "stop", "sever"):
            raise ValueError(f"mode must be kill|stop|sever, got {mode!r}")
        self.scenario = scenario
        self.mode = mode
        self.fault_at = int(fault_at)
        self.worker_rank = int(worker_rank)
        self.nprocs = int(nprocs)
        self.heartbeat_s = float(heartbeat_s)
        self.timeout_s = float(timeout_s)
        self.role = dict(role or {})
        self.clean_leg = bool(clean_leg)
        self.device = str(resolve_device(device))

    # ------------------------------------------------------------------ legs

    def _leg(self) -> Obj:
        """One full scheduling pass over the scenario; returns the
        annotation trail {pod: (nodeName, annotations)}."""
        from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
        from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

        store = ClusterStore()
        for n in self.scenario.get("nodes", []):
            store.create("nodes", json.loads(json.dumps(n)))
        for p in self.scenario.get("pods", []):
            store.create("pods", json.loads(json.dumps(p)))
        kw = dict(tie_break="first", seed=3, use_batch="force", batch_min_work=0, device=self.device)
        kw.update(self.role)
        svc = SchedulerService(store, **kw)
        svc.start_scheduler({"percentageOfNodesToScore": 100})
        svc.schedule_pending()
        return {
            p["metadata"]["name"]: (
                (p.get("spec") or {}).get("nodeName"),
                p["metadata"].get("annotations") or {},
            )
            for p in store.list("pods")
        }

    def _inject(self, pool: Any) -> None:
        w = pool.workers[self.worker_rank % len(pool.workers)]
        if self.mode == "kill":
            os.kill(w.proc.pid, signal.SIGKILL)
        elif self.mode == "stop":
            os.kill(w.proc.pid, signal.SIGSTOP)
        else:  # sever: half a frame header, then EOF
            try:
                w.proc.stdin.write(b"\xde\xad\xbe\xef")
                w.proc.stdin.flush()
            except Exception:  # noqa: BLE001 - the pipe may be gone already
                pass
            try:
                w.proc.stdin.close()
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------------- run

    def run(self) -> Obj:
        from kube_scheduler_simulator_tpu_torch.analysis.runtime import RecompileGuard
        from kube_scheduler_simulator_tpu_torch.ops import procmesh

        verdict: Obj = {
            "scenario": self.scenario.get("name", "scenario"),
            "mode": self.mode,
            "fault_at": self.fault_at,
            "engaged": 0,
            "fired": 0,
            "dispatches": 0,
            "respawns": 0,
            "hangs_detected": 0,
            "respawn_s": 0.0,
            "breaker_state": None,
            "bringup_verdict": None,
            "run_fallbacks": {},
            "divergences": [],
            "first_mismatch": None,
            "leaked_workers": [],
            "clean_compiles": None,
            "chaos_compiles": None,
            "worker_launches": {},
            "worker_builds": {},
        }
        with tempfile.TemporaryDirectory(prefix="kss-worker-chaos-") as td:
            cache = os.path.join(td, "aot")
            with _env_scope({"KSS_AOT_CACHE_DIR": cache, "KSS_MESH_PROCESSES": None}):
                baseline = self._leg()
                if self.device.startswith("cuda"):
                    from kube_scheduler_simulator_tpu_torch.ops import kernels

                    kernels.save_libraries(kernels.library_cache(cache))
            ensemble_env = {
                "KSS_AOT_CACHE_DIR": cache,
                "KSS_MESH_PROCESSES": str(self.nprocs),
                "KSS_PROCMESH_TIMEOUT_S": str(self.timeout_s),
                "KSS_PROCMESH_HEARTBEAT_S": str(self.heartbeat_s),
            }
            if self.clean_leg:
                with _env_scope(ensemble_env):
                    procmesh.reset()
                    with RecompileGuard("clean ensemble leg", max_compiles=1 << 30) as g:
                        clean = self._leg()
                    procmesh.reset()
                verdict["clean_compiles"] = g.compiles
                for name in sorted(set(baseline) | set(clean)):
                    if baseline.get(name) != clean.get(name):
                        verdict["divergences"].append(f"clean:{name}")
            state = {"dispatch": 0, "fired": 0}
            harness = self
            orig_run = procmesh.ProcMeshPool.run

            def chaotic_run(pool_self, key, payload):
                i = state["dispatch"]
                state["dispatch"] += 1
                if i == harness.fault_at and not state["fired"]:
                    state["fired"] = 1
                    harness._inject(pool_self)
                return orig_run(pool_self, key, payload)

            with _env_scope(ensemble_env):
                procmesh.reset()
                procmesh.ProcMeshPool.run = chaotic_run
                try:
                    with RecompileGuard("chaotic ensemble leg", max_compiles=1 << 30) as g:
                        chaotic = self._leg()
                finally:
                    procmesh.ProcMeshPool.run = orig_run
                st = procmesh.stats()
                procmesh.reset()
            verdict["chaos_compiles"] = g.compiles
        pool = st.get("pool")
        verdict["fired"] = state["fired"]
        verdict["bringup_verdict"] = st.get("verdict")
        verdict["run_fallbacks"] = dict(st.get("run_fallbacks_by_reason") or {})
        if pool is not None:
            verdict["engaged"] = 1
            for k in ("dispatches", "respawns", "respawn_s", "hangs_detected", "breaker_state", "worker_launches",
                      "worker_builds"):
                verdict[k] = pool[k]
        for name in sorted(set(baseline) | set(chaotic)):
            if baseline.get(name) != chaotic.get(name):
                verdict["divergences"].append(name)
                if verdict["first_mismatch"] is None:
                    verdict["first_mismatch"] = {
                        "pod": name,
                        "baseline": baseline.get(name),
                        "chaotic": chaotic.get(name),
                    }
        verdict["leaked_workers"] = leaked_worker_pids()
        return verdict


class _FaultyIO:
    """Counting ``state.journal._DirectIO`` stand-in: the ``op``
    (``write`` | ``fsync``) raises ``OSError(err)`` on its
    ``fail_at``-th invocation (0-based, counted per op).  ``once`` makes
    the fault transient (ENOSPC that clears) vs persistent (a dead
    disk); the journal's policy must hold either way because degrade is
    terminal for the journal's lifetime."""

    def __init__(self, fail_at: int, op: str = "write", err: int = 28, once: bool = True):
        if op not in ("write", "fsync"):
            raise ValueError(f"op must be write|fsync, got {op!r}")
        self.fail_at = int(fail_at)
        self.op = op
        self.err = int(err)
        self.once = bool(once)
        self.counts = {"write": 0, "fsync": 0}
        self.trips = 0

    def _tick(self, op: str) -> None:
        i = self.counts[op]
        self.counts[op] += 1
        if op == self.op and (i == self.fail_at or (not self.once and i >= self.fail_at)):
            self.trips += 1
            raise OSError(self.err, os.strerror(self.err))

    def write(self, f, data: bytes) -> None:
        self._tick("write")
        f.write(data)

    def flush(self, f) -> None:
        f.flush()

    def fsync(self, fd: int) -> None:
        self._tick("fsync")
        os.fsync(fd)


class DiskChaos:
    """Disk-fault differential under state/journal.py: a seeded
    write/fsync fault mid-journal must end in the POLICY outcome —
    ``degrade``: the store keeps scheduling byte-identically to an
    unjournaled baseline, the fault is counted per errno, appends stop,
    and the on-disk log is a clean prefix a fresh recovery replays with
    ZERO torn records; ``wedge``: the faulting commit raises
    :class:`state.journal.JournalWedged` loudly and every subsequent
    transaction refuses at entry, BEFORE any store mutation.  Anything
    else — an uncounted continuation, a torn prefix, a silent partial
    commit — fails the verdict.

    The scenario is a deterministic mutation plan: ``events`` pods
    created then bound via ``journal_txn``-grouped waves, mirroring the
    store traffic a scheduling run emits without a scheduler in a
    disk-fault test."""

    def __init__(
        self,
        mode: str = "degrade",
        op: str = "write",
        err: int = 28,  # ENOSPC
        fail_record: int = 3,
        events: int = 8,
        fsync: bool = False,
    ):
        if mode not in ("degrade", "wedge"):
            raise ValueError(f"mode must be degrade|wedge, got {mode!r}")
        self.mode = mode
        self.op = op
        self.err = int(err)
        self.fail_record = int(fail_record)
        self.events = int(events)
        self.fsync = bool(fsync) or op == "fsync"

    @staticmethod
    def _mutate(store: Any, i: int) -> None:
        """One journaled wave: create a pod and bind it — two events,
        one atomic record (the journal_txn shape scheduling commits
        use)."""
        with store.journal_txn("wave"):
            created = store.create(
                "pods",
                {
                    "apiVersion": "v1",
                    "kind": "Pod",
                    "metadata": {"name": f"dc-{i}", "namespace": "default"},
                    "spec": {"containers": [{"name": "c", "image": "pause"}]},
                },
            )
            created["spec"]["nodeName"] = f"n{i % 3}"
            store.update("pods", created)

    @staticmethod
    def _trail(store: Any) -> list:
        return sorted(
            (p["metadata"]["name"], (p.get("spec") or {}).get("nodeName"))
            for p in store.list("pods")
        )

    def run(self) -> Obj:
        import tempfile

        from kube_scheduler_simulator_tpu_torch.state import journal as J
        from kube_scheduler_simulator_tpu_torch.state.recovery import RecoveryManager
        from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

        verdict: Obj = {
            "mode": self.mode,
            "op": self.op,
            "errno": self.err,
            "fail_record": self.fail_record,
            "fired": 0,
            "wedged": 0,
            "wedge_raised": 0,
            "degraded_by_errno": {},
            "records_dropped": 0,
            "post_fault_refusals": 0,
            "divergences": [],
            "recovered_records": 0,
            "recovered_torn": 0,
        }
        baseline = ClusterStore()
        for i in range(self.events):
            self._mutate(baseline, i)

        with tempfile.TemporaryDirectory(prefix="kss-disk-chaos-") as td:
            jdir = os.path.join(td, "journal")
            io = _FaultyIO(self.fail_record, op=self.op, err=self.err)
            jr = J.Journal(jdir, fsync=self.fsync, on_error=self.mode, io=io)
            store = ClusterStore()
            store.attach_journal(jr)
            for i in range(self.events):
                try:
                    self._mutate(store, i)
                except J.JournalWedged:
                    verdict["wedge_raised"] += 1
                    if self.mode == "wedge":
                        # post-fault transactions must refuse AT ENTRY,
                        # before any store mutation
                        before = self._trail(store)
                        for j in range(i + 1, self.events):
                            try:
                                self._mutate(store, j)
                            except J.JournalWedged:
                                verdict["post_fault_refusals"] += 1
                        if self._trail(store) != before:
                            verdict["divergences"].append("mutation_after_wedge")
                        break
            verdict["fired"] = io.trips
            verdict["wedged"] = int(jr.wedged)
            verdict["degraded_by_errno"] = dict(jr.degraded_by_errno)
            verdict["records_dropped"] = jr.stats["records_dropped"]
            jr.close()

            if self.mode == "degrade":
                # non-durable continuation must stay byte-identical
                if self._trail(store) != self._trail(baseline):
                    verdict["divergences"].append("degrade_trail")
                # ... and the on-disk log must be a clean prefix
                fresh = ClusterStore()
                report = RecoveryManager(jdir).recover(fresh)
                verdict["recovered_records"] = report.replayed_records
                verdict["recovered_torn"] = report.truncated_records
                if report.truncated_records:
                    verdict["divergences"].append("torn_prefix")
                recovered = {k: v for k, v in self._trail(fresh)}
                full = {k: v for k, v in self._trail(store)}
                for name, node in recovered.items():
                    if full.get(name) != node:
                        verdict["divergences"].append(f"recovered:{name}")
        return verdict
