"""Time the one-lane scan kernel on one card in its two designs, in one
call: one thread-block cluster walking the pod chain (the wrapper's
default) against the redundant chains (``blocks=`` one block per SM, each
running the whole chain and writing its share of the trace rows: the
earlier design).

    python3 -m kube_scheduler_simulator_tpu_torch.time_scan [--reps 3] [--workload north cfg4 cfg5-vol churn]
                                                            [--dtype float32 float64] [--cluster C]

The problems are chip_smoke.py's: north (10 000 pods x 5 000 nodes, seed
42, 500 sampled nodes, reservoir tie-break, the five-filter, five-score
profile), cfg4 (north's knobs, inter-pod terms on every pod and spread
constraints on every 3rd, the seven-plugin profile), cfg5-vol (10 000 x
5 000 with 5 000 bound pods, cfg4's topology, host ports and volumes,
first tie-break, upstream's default profile), cfg2 (1 000 x 500, every node
scored, first tie-break), and churn: one window of 256 pods at
cfg5-churn's wave shape (the first wave's 2 000 pods over 5 000 nodes, the
default profile, first tie-break, 500 sampled nodes), the second window,
from the first window's carry.  The trace is on; where sampling narrows the
nodes the score planes are compacted in the step, as a round compacts them
(``--full-planes`` keeps [P,N] planes).  ``--cluster`` sets the cluster's
width instead of ``cluster_width``.

The script reads nothing but the package's ``workloads``, ``ops.batch``,
``ops.encode``, ``ops.kernels`` and ``state.store``, so run as a file with
another checkout's root on ``PYTHONPATH`` it times that checkout's kernel;
a checkout from before the cluster took one block per SM as its default,
so both of its designs are the redundant chains there ("default_is" says
which).  Each (workload, dtype) runs the designs in the order default,
blocks, blocks, default; each turn times ``--reps`` launches with CUDA
events after one warm-up launch; the two designs' outputs must be bitwise
equal, and a digest of them is printed: two checkouts whose digests agree
computed the same bits.  The card's name and power limit go on the first
line, one JSON line per (workload, dtype) after it.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
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
SEVEN = (FILTERS + ("PodTopologySpread", "InterPodAffinity"), SCORES + (("PodTopologySpread", 2), ("InterPodAffinity", 2)))
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
# name: (pods, nodes, percentageOfNodesToScore, tie_break, base_counter,
#        start_index, bound pods, profile, topology, storage)
WORKLOADS = {
    "north": (10000, 5000, 0, "reservoir", 12345, 2027, 0, (FILTERS, SCORES), False, False),
    "cfg4": (10000, 5000, 0, "reservoir", 12345, 2027, 0, SEVEN, True, False),
    "cfg5-vol": (10000, 5000, 0, "first", 0, 0, 5000, (DEFAULT_FILTERS, DEFAULT_SCORES), True, True),
    "cfg2": (1000, 500, 100, "first", 0, 0, 0, (FILTERS, SCORES), False, False),
}
CHURN = (10000, 5000, 5, 50)  # chip_smoke.py's cfg5-churn: pods, nodes, waves, cordon
WINDOW = 256
ORDER = ("default", "blocks", "blocks", "default")


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
    for k in sorted(out):
        if isinstance(out[k], torch.Tensor):
            h.update(k.encode())
            h.update(out[k].contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _problem(name: str, dt, full_planes: bool):
    """(cfg, dims, dp, launch keywords) of a workload on the card."""
    dev = torch.device("cuda")
    if name == "churn":
        from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

        P, N, waves, cordon = CHURN
        store = ClusterStore(clock=lambda: 0.0)
        gen = workloads.churn(store, P, N, waves, cordon=cordon)
        next(gen)
        pods = store.list("pods", copy_objects=False)
        pr = E.pad_problem(E.encode(store.list("nodes", copy_objects=False), pods, pods, None))
        cfg = B.BatchConfig(filters=DEFAULT_FILTERS, scores=DEFAULT_SCORES, trace=True, tie_break="first", seed=0)
        dp, dims = B.lower(pr, dtype=dt, device=dev)
        dp = dp._replace(sample_k=num_feasible_nodes_to_find(N, 0))
        ws0 = None if full_planes else B.pick_ws0(cfg, dims, dp.sample_k, N)
        kw = {"ws0": ws0} if ws0 is not None else {}
        first = K.scan(cfg, dims, dp, offset=0, window=WINDOW, **kw)
        return cfg, dims, dp, dict(kw, carry0=first["final_carry"], offset=WINDOW, window=WINDOW)
    P, N, pct, tie, bc, si, n_bound, (filters, scores), topo, storage = WORKLOADS[name]
    topo_kw = dict(spread=lambda i: i % 3 == 0, interpod=lambda i: True) if topo else {}
    nodes, all_pods, pending = workloads.cluster(P, N, seed=42, n_bound=n_bound, **topo_kw)
    vols = {}
    if storage:
        workloads.add_host_ports(all_pods)
        vols = workloads.add_volumes(nodes, all_pods, n_bound)
    pr = E.pad_problem(E.encode(nodes, all_pods, pending, volumes=vols))
    cfg = B.BatchConfig(filters=filters, scores=scores, trace=True, tie_break=tie, seed=7)
    dp, dims = B.lower(pr, dtype=dt, device=dev)
    dp = dp._replace(tb_base=bc, start0=si % N, sample_k=num_feasible_nodes_to_find(N, pct))
    ws0 = None if full_planes else B.pick_ws0(cfg, dims, dp.sample_k, N)
    return cfg, dims, dp, ({"ws0": ws0} if ws0 is not None else {})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--workload", nargs="+", choices=sorted(WORKLOADS) + ["churn"],
                    default=["north", "cfg4", "cfg5-vol", "churn"])
    ap.add_argument("--dtype", nargs="+", choices=["float32", "float64"], default=["float32"])
    ap.add_argument("--cluster", type=int, default=None, help="the cluster's width (default: cluster_width)")
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clustered = "cluster" in inspect.signature(K.scan).parameters
    extra = {"cluster": args.cluster} if args.cluster is not None else {}
    designs = {"default": extra, "blocks": {"blocks": sms}}
    for name in args.workload:
        for dt_name in args.dtype:
            dt = getattr(torch, dt_name)
            cfg, dims, dp, kw = _problem(name, dt, args.full_planes)
            ms: dict = {d: [] for d in designs}
            first = None
            for d in ORDER:
                t, out = _time(lambda: K.scan(cfg, dims, dp, **kw, **designs[d]), args.reps)
                ms[d].append(t)
                if first is None:
                    first = out
                for k in first:
                    if k != "final_carry" and not torch.equal(first[k], out[k]):
                        raise AssertionError(f"{name} {dt_name} {k}: the two designs' outputs differ")
                del out
            C = args.cluster if args.cluster is not None else K.cluster_width(dims["N"], 1)
            print(json.dumps({
                "workload": name, "dtype": dt_name, "P": dims["P"] if name != "churn" else WINDOW, "N": dims["N"],
                "ws0": kw.get("ws0"), "reps": args.reps,
                "default_is": f"one cluster of {C} blocks" if clustered else f"{sms} blocks (the redundant chains)",
                "blocks": sms, "ms": ms, "order": list(ORDER), "digest": _digest(first),
            }), flush=True)
            del first, dp, kw
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
