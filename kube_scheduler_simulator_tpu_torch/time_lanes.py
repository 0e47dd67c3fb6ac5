"""Time the lane scans on one card: the population rollout K9
(``kernels.scan_population``) on generation 0 of cfg10-tune-10k's
imbalance and consolidate problems, and the scale-up estimate K8
(``kernels.scan_lanes``) at the autoscale burst and at cfg6-autoscale's
first dispatch.

    python3 -m kube_scheduler_simulator_tpu_torch.time_lanes [--reps 3]
    python3 -m kube_scheduler_simulator_tpu_torch.time_lanes --tiles [--reps 3]

The problems are chip_smoke.py's: ``workloads.tune`` at ``workloads.TUNE``
(1 250 nodes x 10 000 pods, seed 11) under the default profile, in
float32, with the [16, S] weight matrix ``run_cem`` evaluates first; and
``workloads.autoscale_burst()`` through one ``ScaleUpEstimator.estimate``
(G 16 x N 1 024 x P 10 000), whose lane launch is captured and replayed;
cfg6-autoscale (``workloads.autoscale`` at 1 500 pods, the service's
float32 estimator) likewise, its first dispatch (G 3 x N 160).  K8 gets
the widest lane's rows where its wrapper takes them (``widest``), as the
estimator passes them.
The script reads nothing but the package's ``workloads``, ``ops.kernels``,
``tuning.tuner`` and ``autoscaler``, so run as a file with another
checkout's root on ``PYTHONPATH`` it times that checkout's kernels (order
parent, change, change, parent in one call).  Each shape times ``--reps``
launches with CUDA events after one warm-up launch.  The card's name and
power limit go on the first line, one JSON line per shape after it, with a
digest of the launch's packed outputs and final carry: two checkouts whose
digests agree computed the same bits.

``--tiles`` times K8 instead at every block width ``kernels.LANE_TILES``
holds, on lanes of 64, 200, 500 and 1 000 active rows: the burst's
estimate (``workloads.autoscale_burst``) at 4 groups of that many copies
and 2 000 pods, each launch with the width forced (``scan_lanes(widest=)``
at the width: a lane wider than its tile walks several);
the digests of one lane width agree across the block widths.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch import workloads
from kube_scheduler_simulator_tpu_torch.autoscaler import ScaleUpEstimator
from kube_scheduler_simulator_tpu_torch.ops import kernels as K
from kube_scheduler_simulator_tpu_torch.tuning import tuner as TT


def _time(fn, reps: int) -> "tuple[float, dict]":
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    s.record()
    for _ in range(reps):
        out = fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps, out


def _digest(out: dict) -> str:
    h = hashlib.sha256()
    for k in ("packed_pod", "final_requested", "final_nonzero", "final_pod_count", "final_ip_sel", "final_ip_own",
              "final_ip_anti", "final_spread_counts"):
        h.update(out[k].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _generation0(session, scores, t) -> np.ndarray:
    """The [pop, S] weight matrix ``run_cem`` evaluates first."""
    seen: list = []
    orig = TT.TuningSession.evaluate_population

    def capture(self, W):
        seen.append(np.asarray(W, dtype=np.float64).copy())
        return orig(self, W)

    TT.TuningSession.evaluate_population = capture
    try:
        TT.run_cem(session, np.asarray([float(w) for _s, w in scores]), steps=1, pop=t["pop"], seed=t["seed"])
    finally:
        TT.TuningSession.evaluate_population = orig
    return seen[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiles", action="store_true", help="time K8 at every block width on wider lanes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_lanes: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    K.build()
    if args.tiles:
        return tile_sweep(args.reps)
    t = workloads.TUNE
    scores, filters = TT.profile_scores(device="cuda")
    for family in ("imbalance", "consolidate"):
        nodes, pods, obj = workloads.tune(family, n_nodes=t["n_nodes"], n_pods=t["n_pods"], seed=t["seed"])
        s = TT.TuningSession(nodes, pods, scores, filters=filters, objective=obj, dtype=torch.float32, device="cuda")
        W = torch.as_tensor(_generation0(s, scores, t)).to(device="cuda", dtype=torch.float32)
        ms, out = _time(lambda: K.scan_population(s.cfg, s.dims, s.dp, W), args.reps)
        print(json.dumps({
            "kernel": "scan_population", "family": family, "L": W.shape[0], "P": s.dims["P"], "N": s.dims["N"],
            "G": s.dims["G"], "reps": args.reps, "ms": ms, "digest": _digest(out),
        }), flush=True)
        del out, s
        torch.cuda.empty_cache()
    for shape, run in (("autoscale burst", _burst), ("cfg6-autoscale first dispatch", _cfg6)):
        cfg, dims, dp, lane = _first_lane_launch(run)
        kw = {"widest": int(lane.sum(dim=1).max())} if "widest" in inspect.signature(K.scan_lanes).parameters else {}
        ms, out = _time(lambda: K.scan_lanes(cfg, dims, dp, lane, **kw), args.reps)
        print(json.dumps({
            "kernel": "scan_lanes", "shape": shape, "G": lane.shape[0], "P": dims["P"], "N": dims["N"],
            "tile": K.lane_tile(kw["widest"]) if kw else None, "reps": args.reps, "ms": ms, "digest": _digest(out),
        }), flush=True)
    return 0


def tile_sweep(reps: int, rows=(64, 200, 500, 1000), n_groups: int = 4, n_pods: int = 2000) -> int:
    """K8 at each of ``kernels.LANE_TILES`` on lanes of each of ``rows``
    active rows; one JSON line each.  Raises when two widths disagree."""
    for copies in rows:
        def run(copies=copies):
            groups, room, pending = workloads.autoscale_burst(n_groups=n_groups, copies=copies, n_pending=n_pods)
            ScaleUpEstimator(device="cuda").estimate(groups, room, pending, volumes={})

        cfg, dims, dp, lane = _first_lane_launch(run)
        digests = set()
        for tile in K.LANE_TILES:
            ms, out = _time(lambda: K.scan_lanes(cfg, dims, dp, lane, widest=tile), reps)
            digests.add(_digest(out))
            print(json.dumps({
                "kernel": "scan_lanes", "shape": "tile sweep", "rows": int(lane.sum(dim=1).max()), "G": lane.shape[0],
                "P": dims["P"], "N": dims["N"], "tile": tile, "reps": reps, "ms": ms, "digest": _digest(out),
            }), flush=True)
            del out
        if len(digests) != 1:
            raise AssertionError(f"K8 at {copies} rows a lane: the block widths disagree ({sorted(digests)})")
    return 0


def _first_lane_launch(run) -> tuple:
    """The arguments of the first kernels.scan_lanes call ``run()`` makes."""
    seen: list = []
    orig = K.scan_lanes

    def keep(cfg, dims, dp, lane, **kw):
        seen.append((cfg, dims, dp, lane))
        return orig(cfg, dims, dp, lane, **kw)

    K.scan_lanes = keep
    try:
        run()
    finally:
        K.scan_lanes = orig
    return seen[0]


def _burst() -> None:
    groups, room, pending = workloads.autoscale_burst()
    ScaleUpEstimator(device="cuda").estimate(groups, room, pending, volumes={})


def _cfg6() -> None:
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    def start(store):
        svc = SchedulerService(store, tie_break="first", use_batch="auto", autoscale="on",
                               autoscaler_opts={"expander": "least-waste"}, device="cuda", dtype=torch.float32)
        svc.start_scheduler(None)
        return svc

    # the store's clock frozen, so the queue's order (and the dispatch) is the same in every run
    svc = workloads.autoscale(ClusterStore(clock=lambda: 0.0), start, n_pods=1500, seed_nodes=4, max_size=48, seed=11)
    svc.schedule_pending_autoscaled(max_rounds=2, max_passes=12)


if __name__ == "__main__":
    sys.exit(main())
