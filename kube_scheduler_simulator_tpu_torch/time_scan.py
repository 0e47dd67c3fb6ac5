"""Time the one-lane scan kernel on one card in its two designs, in one
call: one thread-block cluster walking the pod chain (the wrapper's
default) against the redundant chains (``blocks=`` one block per SM, each
running the whole chain and writing its share of the trace rows: the
earlier design); and the trace compaction (K3) on the planes of that scan.

    python3 -m kube_scheduler_simulator_tpu_torch.time_scan [--reps 3] [--workload north cfg4 cfg5-vol churn]
                                                            [--dtype float32 float64] [--cluster C]
                                                            [--kernels scan compact] [--compact-reps 50]

The problems are chip_smoke.py's: north (10 000 pods x 5 000 nodes, seed
42, 500 sampled nodes, reservoir tie-break, the five-filter, five-score
profile), cfg4 (north's knobs, inter-pod terms on every pod and spread
constraints on every 3rd, the seven-plugin profile), cfg5-vol (10 000 x
5 000 with 5 000 bound pods, cfg4's topology, host ports and volumes,
first tie-break, upstream's default profile), cfg2 (1 000 x 500, every node
scored, first tie-break), cfg2 (1 000 x 500, every node scored, first tie-break),
cfg3 (5 000 x 2 000, both spread constraints on every pod, the
seven-plugin profile, cfg2's knobs), and churn: one window of 256 pods at
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

``--kernels compact`` times K3 instead of (or, with ``scan compact``,
after) the scan: one scan launch gives the trace planes (and, where the
round compacts them in the step, the [P, ws0] score planes), W and WS are
the widths a round picks, and the compaction runs in two turns of
``--compact-reps`` launches enqueued behind a sleep of the card
(``timing.device_ms``: the launches run back to back), each turn's
device ms a launch and host µs a call printed, with the blob's digest and
the bytes the compaction must move on these planes (``compact_bytes``)
over 3.35 TB/s as its bound.
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

try:
    from kube_scheduler_simulator_tpu_torch.timing import device_ms
except ImportError:  # a checkout on PYTHONPATH from before timing.py
    from kube_scheduler_simulator_tpu_torch.time_preempt import device_ms  # type: ignore[no-redef]

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
# spread constraints on every 3rd pod and inter-pod terms on every pod
TOPO = dict(spread=lambda i: i % 3 == 0, interpod=lambda i: True)
# name: (pods, nodes, percentageOfNodesToScore, tie_break, base_counter,
#        start_index, bound pods, profile, topology, storage)
WORKLOADS = {
    "north": (10000, 5000, 0, "reservoir", 12345, 2027, 0, (FILTERS, SCORES), {}, False),
    "cfg4": (10000, 5000, 0, "reservoir", 12345, 2027, 0, SEVEN, TOPO, False),
    "cfg5-vol": (10000, 5000, 0, "first", 0, 0, 5000, (DEFAULT_FILTERS, DEFAULT_SCORES), TOPO, True),
    "cfg2": (1000, 500, 100, "first", 0, 0, 0, (FILTERS, SCORES), {}, False),
    "cfg3": (5000, 2000, 100, "first", 0, 0, 0, SEVEN, dict(spread=lambda i: True), False),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
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


def compact_bytes(out: dict, manifest, W: int, WS: int, n_true: int) -> int:
    """Bytes the compaction must move on these planes: the sampled mask (or,
    for planes compacted in the scan's step, the feasible counts) and the
    window scalars of every row, the fail planes of the visited cells, the
    score planes of the kept sampled cells, and the blob."""
    import numpy as np

    P, N = out["fail_plug"].shape
    proc = np.minimum(out["sample_processed"].cpu().numpy().astype(np.int64), n_true)
    if "feasible" in out:
        kept = np.minimum(out["feasible"].sum(dim=1).cpu().numpy(), WS).sum()
        mask = P * N
    else:
        kept = np.minimum(out["feasible_count"].cpu().numpy(), WS).sum()
        mask = 4 * P
    dt_size = out["raw:NodeResourcesFit"].element_size()
    n_score_planes = sum(1 for n, _d, _s in manifest if n.startswith(("raw:", "norm:")))
    blob = sum(int(np.prod(s)) * np.dtype(d).itemsize for _n, d, s in manifest)
    return int(mask + 8 * P + int(np.minimum(proc, W).sum()) * 5 + int(kept) * n_score_planes * dt_size + blob)


def compact_inputs(cfg, dims: dict, out: dict, ws0):
    """(W, WS, manifest) a round picks for a scan's planes."""
    packed = out["packed_pod"].cpu().numpy()
    W = min(dims["N"], E._bucket(max(int(packed[3].max()), 1)))
    WS = min(dims["N"], E._bucket(max(int(packed[1].max()), 1)), ws0 or dims["N"])
    mm = out["trace_meta"].cpu().numpy()
    rdt = tuple(B.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1])) for k in range(len(cfg.scores)))
    _fn, manifest = B.build_compact_fn(cfg, dims, W, WS, rdt, int(mm[-1, 1]), in_step_ws0=ws0)
    return W, WS, manifest


def _time_compact(name: str, dt_name: str, cfg, dims, dp, kw, n_true: int, reps: int) -> dict:
    """K3 on the planes of one scan launch, in two turns."""
    out = K.scan(cfg, dims, dp, **kw)
    ws0 = kw.get("ws0")
    cdims = dict(dims, P=kw["window"]) if "window" in kw else dims
    W, WS, manifest = compact_inputs(cfg, cdims, out, ws0)
    ms, host_us = [], []
    for _turn in range(2):
        t, h, blob = device_ms(lambda: K.compact(cfg, cdims, W, WS, manifest, out, n_true, ws0), reps)
        ms.append(t)
        host_us.append(1e3 * h)
    nbytes = compact_bytes(out, manifest, W, WS, n_true)
    return {
        "kernel": "compact", "workload": name, "dtype": dt_name, "P": cdims["P"], "N": dims["N"], "W": W, "WS": WS,
        "ws0": ws0, "manifest": [f"{n}:{d}" for n, d, _s in manifest], "reps": reps, "ms": ms, "host_us": host_us,
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "digest": hashlib.sha256(blob.cpu().numpy().tobytes()).hexdigest()[:16],
    }


def _problem(name: str, dt, full_planes: bool):
    """(cfg, dims, dp, launch keywords, the true node count) of a workload
    on the card."""
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
        return cfg, dims, dp, dict(kw, carry0=first["final_carry"], offset=WINDOW, window=WINDOW), pr.N_true
    P, N, pct, tie, bc, si, n_bound, (filters, scores), topo_kw, storage = WORKLOADS[name]
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
    return cfg, dims, dp, ({"ws0": ws0} if ws0 is not None else {}), pr.N_true


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--workload", nargs="+", choices=sorted(WORKLOADS) + ["churn"],
                    default=["north", "cfg4", "cfg5-vol", "churn"])
    ap.add_argument("--dtype", nargs="+", choices=["float32", "float64"], default=["float32"])
    ap.add_argument("--cluster", type=int, default=None, help="the cluster's width (default: cluster_width)")
    ap.add_argument("--full-planes", action="store_true", help="write [P,N] score planes even where a round compacts them")
    ap.add_argument("--kernels", nargs="+", choices=["scan", "compact"], default=["scan"])
    ap.add_argument("--compact-reps", type=int, default=50)
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
            cfg, dims, dp, kw, n_true = _problem(name, dt, args.full_planes)
            if "compact" in args.kernels:
                print(json.dumps(_time_compact(name, dt_name, cfg, dims, dp, kw, n_true, args.compact_reps)), flush=True)
            if "scan" not in args.kernels:
                del dp, kw
                torch.cuda.empty_cache()
                continue
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
