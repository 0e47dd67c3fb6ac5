"""Time the scan kernel at the north-star shapes on one card, with one
block per SM (the wrapper's default with the trace on) against a single
block that also writes every trace row.

    python3 -m kube_scheduler_simulator_tpu_torch.time_scan [--reps 3]

The problem is chip_smoke.py's north workload (10 000 pods x 5 000 nodes,
seed 42, 500 sampled nodes, reservoir tie-break, trace on).  Each dtype
runs the two launch shapes in the order per-SM, single, single, per-SM;
each turn times ``--reps`` launches with CUDA events after one warm-up
launch, and the two shapes' outputs must be bitwise equal.  The card's
name and power limit go on the first line, one JSON line per dtype after
it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from kube_scheduler_simulator_tpu_torch import workloads
from kube_scheduler_simulator_tpu_torch.ops import batch as B
from kube_scheduler_simulator_tpu_torch.ops import encode as E
from kube_scheduler_simulator_tpu_torch.ops import kernels as K
from kube_scheduler_simulator_tpu_torch.scheduler.framework_runner import num_feasible_nodes_to_find

SCORES = (
    ("NodeResourcesFit", 1),
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("TaintToleration", 3),
    ("NodeAffinity", 2),
)
SHAPES = {"per_sm": None, "single": 1}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_scan: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    K.build()
    order = ["per_sm", "single", "single", "per_sm"]

    P, N = 10000, 5000
    nodes, all_pods, pending = workloads.cluster(P, N, seed=42)
    pr = E.pad_problem(E.encode(nodes, all_pods, pending))
    cfg = B.BatchConfig(filters=B.SLICE_FILTERS, scores=SCORES, trace=True, tie_break="reservoir", seed=7)
    for dt in (torch.float32, torch.float64):
        dp, dims = B.lower(pr, dtype=dt, device=torch.device("cuda"))
        dp = dp._replace(tb_base=12345, start0=2027 % N, sample_k=num_feasible_nodes_to_find(N, 0))
        ms: dict = {v: [] for v in SHAPES}
        first = None
        for v in order:
            t, out = _time(lambda: K.scan(cfg, dims, dp, blocks=SHAPES[v]), args.reps)
            ms[v].append(t)
            if first is None:
                first = out
            for k in first:
                if not torch.equal(first[k], out[k]):
                    raise AssertionError(f"{dt} {k}: the two launch shapes' outputs differ")
            del out
        print(json.dumps({
            "dtype": str(dt).split(".")[-1], "P": dims["P"], "N": dims["N"], "reps": args.reps,
            "ms": ms, "order": order,
        }), flush=True)
        del first, dp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
