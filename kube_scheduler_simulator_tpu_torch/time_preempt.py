"""Time the victim search K5 on one card at cfg7-preempt-5k's first
dispatch: the kernel (``kernels.preempt`` on that dispatch's tensors) and
the whole dispatch (``preemption.kernel.run_search`` on its host inputs:
inputs in, kernel, fetch).

    python3 -m kube_scheduler_simulator_tpu_torch.time_preempt --save FILE
    python3 -m kube_scheduler_simulator_tpu_torch.time_preempt --load FILE [--reps 50]
    python3 -m kube_scheduler_simulator_tpu_torch.time_preempt --service

``--save`` runs cfg7-preempt-5k (``workloads.preemption_wave`` at its
defaults: 5 000 nodes, 20 000 bound pods, 400 fillers, 64 preemptors)
through a float32 ``SchedulerService`` for one round, keeps the first
``run_search`` call's arguments (the victim tables and the per-dispatch
arrays, numpy) in FILE, and times them; ``--load`` times FILE's.  The
script reads nothing but the package's ``workloads``, ``ops.kernels``,
``preemption`` and ``scheduler``, so run as a file with another checkout's
root on ``PYTHONPATH`` it times that checkout's search on the same inputs
(order parent, change, change, parent in one call).  The card's name and
power limit go on the first line, one JSON line after it: the kernel's
and the dispatch's milliseconds (CUDA events over ``--reps`` kernel
launches after three warm-ups, enqueued while the card sleeps so that
they run back to back: the kernel is shorter than its call, whose host
time goes beside it; host clock over ``--reps`` dispatches, each ending in
its fetch), and a digest of the three masks: two checkouts whose digests
agree computed the same bits.  A dispatch is timed warm (the problem's
tables already on the card, ``dispatch_ms``) and cold (its tables
uploaded first, ``cold_ms``), as each dispatch of the cfg7 service is:
every kernel run builds a new problem.  ``--service`` times the service
itself instead: one cfg7-preempt-5k round, its wall, ``preempt_kernel_s``
and dispatches, and the host milliseconds of every ``run_search`` call and
of the ``device_tables`` call inside it, summed and at their median.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.ops import kernels as K
from kube_scheduler_simulator_tpu_torch.preemption import kernel as PK

try:
    from kube_scheduler_simulator_tpu_torch.timing import device_ms
except ImportError:  # a checkout on PYTHONPATH from before timing.py: the function was defined here
    from kube_scheduler_simulator_tpu_torch.time_preempt import device_ms  # type: ignore[no-redef]

# the victim tables run_search reads (preemption.encode.PreemptionProblem)
TABLES = ("node_names", "resource_names", "alloc", "base_req", "base_cnt", "max_pods", "vreq", "vprio", "vstart",
          "vvalid", "vmatch", "allowed", "victim_pods", "res_idx", "V", "PDB")


def snapshot(pr, args: tuple, kw: dict) -> bytes:
    """A run_search call's arguments as bytes: the problem's victim tables,
    the per-dispatch arrays, the round's extra usage (``usage``, ``cnt``)."""
    return pickle.dumps(({f: getattr(pr, f) for f in TABLES}, args, {k: kw.get(k) for k in ("usage", "cnt")}))


def restore(blob: bytes):
    """(problem, run_search's positional arguments, its usage keywords) from
    ``snapshot``'s bytes."""
    from kube_scheduler_simulator_tpu_torch.preemption.encode import PreemptionProblem

    fields, args, kw = pickle.loads(blob)
    pr = PreemptionProblem(fields["node_names"], fields["resource_names"])
    for k, v in fields.items():
        setattr(pr, k, v)
    return pr, args, kw


def cfg7_round(hooks: dict) -> "tuple[float, dict]":
    """One cfg7-preempt-5k round through a float32 service on the card, the
    ``preemption.kernel`` functions named in ``hooks`` replaced by
    ``hooks[name](original)`` for its length; (its wall seconds, the
    service's stats)."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    store = ClusterStore(clock=lambda: 0.0)
    workloads.preemption_wave(store)
    svc = SchedulerService(store, tie_break="first", use_batch="auto", device="cuda", dtype=torch.float32)
    svc.start_scheduler(None)
    orig = {name: getattr(PK, name) for name in hooks}
    for name, hook in hooks.items():
        setattr(PK, name, hook(orig[name]))
    try:
        t0 = time.perf_counter()
        svc.schedule_pending(max_rounds=1)
        return time.perf_counter() - t0, svc.stats
    finally:
        for name, fn in orig.items():
            setattr(PK, name, fn)


def capture(path: str) -> None:
    """cfg7-preempt-5k's first run_search call, kept in ``path``."""
    kept: list = []

    def keep(orig):
        def run_search(pr, *args, **kw):
            if not kept:
                kept.append(snapshot(pr, args, kw))
            return orig(pr, *args, **kw)

        return run_search

    cfg7_round({"run_search": keep})
    with open(path, "wb") as f:
        f.write(kept[0])


def service() -> dict:
    """One cfg7-preempt-5k round with each run_search and device_tables
    call timed on the host's clock."""
    ms: dict = {"run_search": [], "device_tables": []}

    def timed(name):
        def hook(orig):
            def fn(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return orig(*args, **kw)
                finally:
                    ms[name].append(1e3 * (time.perf_counter() - t0))

            return fn

        return hook

    wall, stats = cfg7_round({name: timed(name) for name in ms})
    return {
        "shape": "cfg7-preempt-5k round", "wall_s": wall, "preempt_kernel_s": stats["preempt_kernel_s"],
        "dispatches": stats["preempt_dispatches"],
        **{f"{k}_ms": {"sum": float(np.sum(v)), "median": float(np.median(v)), "n": len(v)} for k, v in ms.items()},
    }


def load(path: str):
    """``restore`` of ``capture``'s file."""
    with open(path, "rb") as f:
        return restore(f.read())


def kernel_args(pr, args, kw, dt) -> tuple:
    """kernels.preempt's 17 tensors on the card for run_search's inputs."""
    ucand, ureq, uprio, smask, sreq, snode = args
    U, N = np.asarray(ucand).shape
    R, S = len(pr.resource_names), len(snode)
    tables = PK.device_tables(pr, torch.device("cuda"), dt)
    up = lambda a, d=None: torch.from_numpy(np.ascontiguousarray(a)).to(device="cuda", dtype=d)  # noqa: E731
    extra_req = np.asarray(kw["usage"] if kw.get("usage") is not None else np.zeros((N, R)), dtype=np.int64)
    extra_cnt = np.asarray(kw["cnt"] if kw.get("cnt") is not None else np.zeros(N), dtype=np.int64)
    return (
        up(np.asarray(ucand, dtype=bool)), up(np.asarray(ureq, dtype=np.int64).reshape(U, R), dt),
        up(np.asarray(uprio, dtype=np.int64)), up(np.asarray(smask, dtype=bool).reshape(U, S)),
        up(np.asarray(sreq, dtype=np.int64).reshape(S, R), dt), up(np.asarray(snode, dtype=np.int32)),
        tables["alloc"], tables["base_req"], up(extra_req, dt), tables["base_cnt"], up(extra_cnt, dt),
        tables["max_pods"], tables["vreq"], tables["vprio"], tables["vvalid"], tables["vmatch"], tables["allowed"],
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save", help="run cfg7-preempt-5k, keep its first dispatch here, and time it")
    ap.add_argument("--load", help="time the dispatch kept here")
    ap.add_argument("--service", action="store_true", help="time one cfg7-preempt-5k round of the service")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_preempt: no CUDA device", file=sys.stderr)
        return 2
    if (bool(args.save) + bool(args.load) + args.service) != 1:
        ap.error("give one of --save, --load and --service")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    K.build()
    if args.service:
        print(json.dumps(service()), flush=True)
        return 0
    if args.save:
        capture(args.save)
    pr, sargs, kw = load(args.save or args.load)
    dt = torch.float32
    targs = kernel_args(pr, sargs, kw, dt)
    kernel_ms, call_ms, out = device_ms(lambda: K.preempt(*targs), args.reps)
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().cpu().numpy().tobytes())
    times = {}
    for how in ("warm", "cold", "warm"):
        for _ in range(3):
            PK.run_search(pr, *sargs, **kw, device="cuda", dtype=dt)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            if how == "cold":
                pr._device = None  # the tables uploaded anew, as a new problem's
            masks = PK.run_search(pr, *sargs, **kw, device="cuda", dtype=dt)
        times.setdefault(how, []).append(1e3 * (time.perf_counter() - t0) / args.reps)
    hd = hashlib.sha256()
    for k in ("cand", "victims", "viol"):
        hd.update(np.ascontiguousarray(masks[k]).tobytes())
    U, N = targs[0].shape
    print(json.dumps({
        "kernel": "preempt", "shape": "cfg7-preempt-5k first dispatch", "U": U, "N": N, "V": pr.V,
        "R": len(pr.resource_names), "PDB": pr.PDB, "S": int(targs[5].shape[0]), "reps": args.reps,
        "kernel_ms": kernel_ms, "call_ms": call_ms, "dispatch_ms": times["warm"], "cold_ms": times["cold"][0],
        "digest": h.hexdigest()[:16],
        "dispatch_digest": hd.hexdigest()[:16],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
