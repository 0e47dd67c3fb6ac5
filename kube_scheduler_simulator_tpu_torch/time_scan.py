"""Time the scan kernel on one card, with one block per SM (the wrapper's
default with the trace on) against a single block that also writes every
trace row.

    python3 -m kube_scheduler_simulator_tpu_torch.time_scan [--reps 3] [--workload north|cfg2|cfg5-vol]

The problem is chip_smoke.py's north workload (10 000 pods x 5 000 nodes,
seed 42, 500 sampled nodes, reservoir tie-break, trace on, the five-filter,
five-score profile), its cfg2 workload (1000 x 500, every node scored,
first tie-break) or its cfg5-vol workload (10 000 x 5 000 with 5 000 bound
pods, spread constraints, inter-pod terms, host ports and volumes, 500
sampled nodes, first tie-break, upstream's default profile).  Where
sampling narrows the nodes the score planes are compacted in the step, as
a round compacts them (``--full-planes`` keeps [P,N] planes, as a
checkout without that compaction writes them).  The script reads nothing but the package's
``workloads``, ``ops.batch``, ``ops.encode`` and ``ops.kernels``, so run as
a file with another checkout's root on ``PYTHONPATH`` it times that
checkout's kernel.  Each dtype
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

FILTERS = ("NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodeResourcesFit")
SCORES = (
    ("NodeResourcesFit", 1),
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("TaintToleration", 3),
    ("NodeAffinity", 2),
)
# upstream's default profile in the registry's order, default weights
DEFAULT_FILTERS = (
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
    "VolumeRestrictions", "EBSLimits", "GCEPDLimits", "NodeVolumeLimits", "AzureDiskLimits",
    "VolumeBinding", "VolumeZone", "PodTopologySpread", "InterPodAffinity",
)
DEFAULT_SCORES = (
    ("TaintToleration", 3), ("NodeAffinity", 2), ("NodeResourcesFit", 1), ("PodTopologySpread", 2),
    ("InterPodAffinity", 2), ("NodeResourcesBalancedAllocation", 1), ("ImageLocality", 1),
)
SHAPES = {"per_sm": None, "single": 1}
# name: (pods, nodes, percentageOfNodesToScore, tie_break, base_counter,
#        start_index, bound pods, storage and topology)
WORKLOADS = {
    "north": (10000, 5000, 0, "reservoir", 12345, 2027, 0, False),
    "cfg2": (1000, 500, 100, "first", 0, 0, 0, False),
    "cfg5-vol": (10000, 5000, 0, "first", 0, 0, 5000, True),
}


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
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="north")
    ap.add_argument("--full-planes", action="store_true", help="write [P,N] score planes even where a round compacts them")
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

    P, N, pct, tie, bc, si, n_bound, storage = WORKLOADS[args.workload]
    topo = dict(spread=lambda i: i % 3 == 0, interpod=lambda i: True) if storage else {}
    nodes, all_pods, pending = workloads.cluster(P, N, seed=42, n_bound=n_bound, **topo)
    vols = {}
    if storage:
        workloads.add_host_ports(all_pods)
        vols = workloads.add_volumes(nodes, all_pods, n_bound)
    pr = E.pad_problem(E.encode(nodes, all_pods, pending, volumes=vols))
    filters, scores = (DEFAULT_FILTERS, DEFAULT_SCORES) if storage else (FILTERS, SCORES)
    cfg = B.BatchConfig(filters=filters, scores=scores, trace=True, tie_break=tie, seed=7)
    for dt in (torch.float32, torch.float64):
        dp, dims = B.lower(pr, dtype=dt, device=torch.device("cuda"))
        dp = dp._replace(tb_base=bc, start0=si % N, sample_k=num_feasible_nodes_to_find(N, pct))
        # a checkout without the in-step compaction writes full planes
        ws0 = None if args.full_planes or not hasattr(B, "pick_ws0") else B.pick_ws0(cfg, dims, dp.sample_k, N)
        ms: dict = {v: [] for v in SHAPES}
        first = None
        for v in order:
            kw = {"ws0": ws0} if ws0 is not None else {}
            t, out = _time(lambda: K.scan(cfg, dims, dp, blocks=SHAPES[v], **kw), args.reps)
            ms[v].append(t)
            if first is None:
                first = out
            for k in first:
                if k == "final_carry":  # a dict view of the final_* outputs
                    continue
                if not torch.equal(first[k], out[k]):
                    raise AssertionError(f"{dt} {k}: the two launch shapes' outputs differ")
            del out
        print(json.dumps({
            "workload": args.workload, "dtype": str(dt).split(".")[-1], "P": dims["P"], "N": dims["N"],
            "ws0": ws0, "reps": args.reps,
            "ms": ms, "order": order,
        }), flush=True)
        del first, dp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
