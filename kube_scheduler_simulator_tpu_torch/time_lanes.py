"""Time the lane scans on one card: the population rollout K9
(``kernels.scan_population``) on generation 0 of cfg10-tune-10k's
imbalance and consolidate problems, and the scale-up estimate K8
(``kernels.scan_lanes``) at the autoscale burst.

    python3 -m kube_scheduler_simulator_tpu_torch.time_lanes [--reps 3]

The problems are chip_smoke.py's: ``workloads.tune`` at ``workloads.TUNE``
(1 250 nodes x 10 000 pods, seed 11) under the default profile, in
float32, with the [16, S] weight matrix ``run_cem`` evaluates first; and
``workloads.autoscale_burst()`` through one ``ScaleUpEstimator.estimate``
(G 16 x N 1 024 x P 10 000), whose lane launch is captured and replayed.
The script reads nothing but the package's ``workloads``, ``ops.kernels``,
``tuning.tuner`` and ``autoscaler``, so run as a file with another
checkout's root on ``PYTHONPATH`` it times that checkout's kernels (order
parent, change, change, parent in one call).  Each shape times ``--reps``
launches with CUDA events after one warm-up launch.  The card's name and
power limit go on the first line, one JSON line per shape after it, with a
digest of the launch's packed outputs and final carry: two checkouts whose
digests agree computed the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
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
    groups, room, pending = workloads.autoscale_burst()
    seen: list = []
    orig = K.scan_lanes
    K.scan_lanes = lambda cfg, dims, dp, lane: seen.append((cfg, dims, dp, lane)) or orig(cfg, dims, dp, lane)
    try:
        ScaleUpEstimator(device="cuda").estimate(groups, room, pending, volumes={})
    finally:
        K.scan_lanes = orig
    cfg, dims, dp, lane = seen[0]
    ms, out = _time(lambda: K.scan_lanes(cfg, dims, dp, lane), args.reps)
    print(json.dumps({
        "kernel": "scan_lanes", "shape": "autoscale burst", "G": lane.shape[0], "P": dims["P"], "N": dims["N"],
        "reps": args.reps, "ms": ms, "digest": _digest(out),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
