#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build, check and time the batch
round's kernels on one NVIDIA GPU, then drive the port's main path.

    python3 chip_smoke.py    # one card, about 10 min, build included

Workloads (every one from seed 42 through ``workloads.cluster``):

- cfg2: 1000 pods x 500 nodes, percentageOfNodesToScore 100, tie_break
  first; the five-filter, five-score profile;
- north: 10 000 pods x 5 000 nodes, percentage 0 -> 500 sampled nodes,
  tie_break reservoir, base counter 12345, start index 2027; that profile;
- cfg3: 5 000 pods x 2 000 nodes, every pod with bench's two spread
  constraints; cfg2's knobs; the seven-plugin profile (the five plus
  PodTopologySpread and InterPodAffinity, upstream's default weights);
- cfg4: 10 000 pods x 5 000 nodes, inter-pod terms on every pod (bench's
  preferred anti-affinity on odd pods, required anti-affinity on every
  25th, required zone affinity on pods 20, 60, ...) and the spread
  constraints on every 3rd; north's knobs; the seven-plugin profile;
- cfg5-vol: BASELINE cfg5's size and profile in one round: 10 000 pods x
  5 000 nodes plus 5 000 pods bound round-robin before it, cfg4's spread
  constraints and inter-pod terms, DaemonSet host ports and volumes
  (``workloads.add_host_ports``, ``add_volumes``: own, shared and
  WaitForFirstConsumer claims, GCE PD, EBS and Azure disks, CSI nodes);
  percentage 0 -> 500 sampled nodes (so the score planes are compacted in
  the scan's step), tie_break first, base counter 0, start 0; upstream's
  default profile (fifteen filters and seven scores in the registry's
  order, default weights).

Phases (each prints its seconds; any failure exits nonzero before the last
line):

1. the card's name and power limit (nvidia-smi), then the kernel build
   (nvcc, sm_90a, both sources in parallel);
2. kernel against plain version on the card, bitwise (``torch.equal``) in
   float32 and float64, with the trace on: the scan (score planes compacted
   in the step wherever a round would compact them) and the compaction of
   its planes at every workload; where the step compacts, the compacted
   planes against the same kernel's full planes gathered at the ascending
   sampled ids, and the two blobs; at cfg5-vol, the first failures of each
   filter (NodePorts, VolumeRestrictions, NodeVolumeLimits, VolumeBinding
   and VolumeZone must each reject a pair); the compaction on seeded planes
   for every fail-pack mode and raw dtype;
3. end to end: ``BatchEngine(device="cuda").schedule`` on every workload
   in float32 and float64 (launch counters reset just before each round
   and read just after: every round must launch each kernel once);
4. every pod's annotation bytes from a CUDA float64 round equal a CPU
   float64 round's at cfg2, at cfg3 and at cfg4 and cfg5-vol cut to 1 000
   pods x 500 nodes (a CPU round at full size does not fit the time
   limit);
5. the float32 round's differences from float64, per score plugin and per
   filter, printed.

Then one ``{"kernels": [...]}`` line (time, plain time and bound of each
kernel at the cfg5-vol shapes, launches on the main path: the cfg5-vol
float32 round), and as the last line ``{"ok": true, "device": {...}}``.
Everything is generated from seeds; nothing is read from the network.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, NamedTuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12     # non-tensor float32
FP64_OPS_PER_S = 34e12     # non-tensor float64

FIVE_FILTERS = ("NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodeResourcesFit")
FIVE_SCORES = [
    ("NodeResourcesFit", 1),
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("TaintToleration", 3),
    ("NodeAffinity", 2),
]
# upstream's default profile as the service's default configuration hands
# it to the engine: the registry's filter order, its scores and weights
DEFAULT_FILTERS = (
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
    "VolumeRestrictions", "EBSLimits", "GCEPDLimits", "NodeVolumeLimits", "AzureDiskLimits",
    "VolumeBinding", "VolumeZone", "PodTopologySpread", "InterPodAffinity",
)
DEFAULT_SCORES = [
    ("TaintToleration", 3), ("NodeAffinity", 2), ("NodeResourcesFit", 1), ("PodTopologySpread", 2),
    ("InterPodAffinity", 2), ("NodeResourcesBalancedAllocation", 1), ("ImageLocality", 1),
]
PROFILES = {
    "five": (FIVE_FILTERS, FIVE_SCORES),
    "seven": (
        FIVE_FILTERS + ("PodTopologySpread", "InterPodAffinity"),
        FIVE_SCORES + [("PodTopologySpread", 2), ("InterPodAffinity", 2)],
    ),
    "default": (DEFAULT_FILTERS, DEFAULT_SCORES),
}


class Workload(NamedTuple):
    pods: int
    nodes: int
    pct: int          # percentageOfNodesToScore
    tie: str
    base_counter: int
    start: int        # start index
    profile: str
    spread: Any = False    # predicate on the pod index, or False
    interpod: Any = False
    bound: int = 0         # pods bound round-robin before the round
    storage: bool = False  # host ports and volumes


WORKLOADS = {
    "cfg2": Workload(1000, 500, 100, "first", 0, 0, "five"),
    "north": Workload(10000, 5000, 0, "reservoir", 12345, 2027, "five"),
    "cfg3": Workload(5000, 2000, 100, "first", 0, 0, "seven", spread=lambda i: True),
    "cfg4": Workload(
        10000, 5000, 0, "reservoir", 12345, 2027, "seven", spread=lambda i: i % 3 == 0, interpod=lambda i: True,
    ),
    "cfg5-vol": Workload(
        10000, 5000, 0, "first", 0, 0, "default", spread=lambda i: i % 3 == 0, interpod=lambda i: True,
        bound=5000, storage=True,
    ),
}
# CUDA float64 against CPU float64 annotation bytes: (workload, cut to
# (pods, nodes, bound pods) or None)
ANNOTATION_CHECKS = (("cfg2", None), ("cfg3", None), ("cfg4", (1000, 500, 0)), ("cfg5-vol", (1000, 500, 500)))
MAIN = "cfg5-vol"  # the slice's path: the kernels line reads its float32 run
# filters cfg5-vol must see reject at least one (pod, node) pair first
MUST_REJECT = ("NodePorts", "VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone")
DEVICE = "cuda"


def log(*a) -> None:
    print(*a, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.3f} s")


def cuda_ms(fn, reps: int, warmup: int = 1):
    """(mean ms per call over ``reps`` calls timed with CUDA events, last
    result), after ``warmup`` untimed calls."""
    import torch

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s.record()
    for _ in range(reps):
        res = fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps, res


def same(name: str, a, b) -> float:
    """Require bitwise-equal tensors; return max |a - b| (0.0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        diff = (a.double() - b.double()).abs()
        n_bad = int((diff != 0).sum()) if a.shape == b.shape else -1
        raise AssertionError(f"{name}: kernel and plain version differ ({n_bad} cells, {a.dtype}/{b.dtype})")
    return 0.0


def scan_counts(cfg, dims, dp, out) -> dict:
    """Bytes the scan must move and operations it must do on this input:
    every input the profile reads once, every output once (the score
    planes at their [P, ws0] width where the step compacts them, the final
    volume carries); the operations of each (pod, node) cell, and those of
    the pod's own spread constraints, inter-pod terms, host ports and
    volumes."""
    from kube_scheduler_simulator_tpu_torch.ops.batch import plugin_gates

    P, N, R = dims["P"], dims["N"], dims["R"]
    gates = plugin_gates(cfg, dims)
    fields = [
        "alloc", "max_pods", "nz_alloc", "pod_req", "pod_nonzero", "fit_checked", "taint_cls",
        "taint_prefer_cls", "taint_unsched_cls", "pod_tol_idx", "node_taint_idx", "node_unsched",
        "aff_code_cls", "aff_pref_cls", "pod_aff_idx", "pod_pref_idx", "node_label_idx", "img_cls",
        "pod_img_idx", "node_img_idx", "name_target", "pod_active", "node_active",
        "requested0", "nonzero0", "pod_count0",
    ]
    tensors = [getattr(dp, f) for f in fields]
    if gates["spread_filter"] or gates["spread_score"]:
        tensors += [dp.incl_cls, dp.node_domain, dp.spf_ku, dp.sps_ku, dp.spread_match, dp.spread_counts0]
        tensors += list(dp.spf) + list(dp.sps[:3])
    if gates["interpod"]:
        tensors += [getattr(dp, f) for f in (
            "gdom", "term_match", "ip_aff_g", "ip_anti_g", "ip_pref_g", "ip_pref_w", "ip_own_g", "ip_own_w",
            "ip_self_match", "ip_sel0", "ip_own0", "ip_anti0",
        )]
    if "VolumeBinding" in cfg.filters or "VolumeZone" in cfg.filters:
        tensors += [dp.vb_cls, dp.vz_cls, dp.pod_vol_idx]
    for gate, fields in (
        ("ports", ("port_cols", "port_conflict", "ports_used0")),
        ("restr", ("restr_cols", "restr_conflict", "restr_used0")),
        ("cloud", ("cloud_cnt", "cloud_used0")),
        ("csi", ("csi_cols", "csi_drv", "csi_seed_used", "csi_limit", "csi_attached0")),
    ):
        if gates[gate]:
            tensors += [getattr(dp, f) for f in fields]
    read = sum(t.numel() * t.element_size() for t in tensors)
    written = sum(t.numel() * t.element_size() for k, t in out.items() if k in (
        "packed_pod", "final_requested", "final_nonzero", "final_pod_count", "final_ports_used",
        "final_restr_used", "final_cloud_used", "final_csi_att", "fail_plug", "fail_code",
        "feasible", "trace_meta") or k.startswith(("raw:", "norm:")))
    # per (pod, node) cell: filters (Fit: 2 + 3 per resource), the scan
    # step, Fit (12 per resource column), Balanced (12), two normalized
    # scores (6 each), the weighted sum (2 per score), select (2)
    per_cell = 4 + 2 + 3 * R + 2 + 12 * len(cfg.fit_resources) + 12 + 12 + 2 * len(cfg.scores) + 2
    ops = per_cell * P * N
    active = lambda t: (t >= 0).sum(dim=1).cpu().long()
    if gates["spread_filter"]:
        # domain sum, match + self, - min, compare, first code: 5 a node
        ops += 5 * N * int(active(dp.spf[0]).sum())
    if gates["spread_score"]:
        # domain sum, count x log, + (skew - 1), + running sum: 4 a node a
        # constraint; rint, extrema, normalization: 8 a node
        n_sps = active(dp.sps[0])
        ops += N * int((4 * n_sps + 8 * (n_sps > 0)).sum())
    if gates["interpod"]:
        terms = (dp.term_match != 0).sum(dim=0).cpu().long()  # groups matching each pod
        # filter: one check per group matching the pod, 2 per required
        # term; score: one add per matching group, 2 per preferred term,
        # min-max normalization 6
        per_pod = 2 * terms + 2 * (active(dp.ip_aff_g) + active(dp.ip_anti_g)) + 2 * active(dp.ip_pref_g) + 6
        ops += N * int(per_pod.sum())
    # VolumeBinding, VolumeZone: one read a cell each; host ports and
    # conflict volumes: one add a pod's class; a cloud limit the pod wants:
    # add and compare; CSI: per id k, the k ids' need count and the compare
    ops += P * N * sum(f in cfg.filters for f in ("VolumeBinding", "VolumeZone"))
    if gates["ports"] and "NodePorts" in cfg.filters:
        ops += N * int(active(dp.port_cols).sum())
    if gates["restr"]:
        ops += N * int(active(dp.restr_cols).sum())
    if gates["cloud"]:
        n_cloud = sum(f in cfg.filters for f in ("EBSLimits", "GCEPDLimits", "AzureDiskLimits"))
        ops += 2 * N * n_cloud * int((dp.cloud_cnt > 0).any(dim=1).sum())
    if gates["csi"]:
        k = active(dp.csi_cols)
        ops += N * int((k * k + 3 * k).sum())
    return {"bytes": read + written, "ops": ops}


def carry_bytes(cfg, dims, dp, dt, blocks: int) -> dict:
    """Bytes of the scan's per-block copies of the carries it keeps beside
    Fit's: PodTopologySpread's spread_counts [SG,N], InterPodAffinity's
    ip_sel, ip_own, ip_anti [G,D+1], and the volume carries ports_used
    [PT,N], restr_used [VR,N], cloud_used [3,N], the CSI count per driver
    [DR,N] in the working dtype and the CSI attachment bytes [V,N]."""
    from kube_scheduler_simulator_tpu_torch.ops.batch import plugin_gates

    size = 4 if str(dt).endswith("float32") else 8
    N = dims["N"]
    gates = plugin_gates(cfg, dims)
    topo = (dims["SG"] * N + 3 * dims["G"] * (dims["D"] + 1)) * size
    vol = {
        "ports": dp.ports_used0.shape[1] * N * size if gates["ports"] else 0,
        "restr": dp.restr_used0.shape[1] * N * size if gates["restr"] else 0,
        "cloud": 3 * N * size if gates["cloud"] else 0,
        "csi": dp.csi_attached0.shape[1] * N + dp.csi_seed_used.shape[1] * N * size if gates["csi"] else 0,
    }
    per_block = topo + sum(vol.values())
    return {"blocks": blocks, "topology": topo, **vol, "per_block": per_block, "total": per_block * blocks}


def bound(counts: dict, dt) -> "tuple[float, str]":
    """(least ms the card could take, "bytes" or "operations"): the bytes
    over the memory rate against the operations over the peak rate of the
    working dtype."""
    import torch

    t_bytes = counts["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = counts["ops"] / (FP32_OPS_PER_S if dt == torch.float32 else FP64_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compact_counts(out, manifest, W, WS, n_true) -> dict:
    """Bytes the compaction must move on this input: the sampled mask (or,
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
    read = mask + 8 * P + int(np.minimum(proc, W).sum()) * 5 + int(kept) * n_score_planes * dt_size
    return {"bytes": read + blob, "ops": 0}


def gather_sampled(full, ws0: int):
    """[P,N] planes → [P,ws0]: each row's sampled (feasible-plane) cells in
    ascending node id, the rest zero."""
    import torch

    feas = full["feasible"]
    pos = torch.cumsum(feas.to(torch.int32), 1) - 1
    dest = torch.where(feas & (pos < ws0), pos, ws0).long()
    out = {}
    for k, v in full.items():
        if k.startswith(("raw:", "norm:")):
            z = torch.zeros((v.shape[0], ws0 + 1), dtype=v.dtype, device=v.device)
            out[k] = z.scatter_(1, dest, v)[:, :ws0]
    return out


def main() -> int:
    t_all = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from kube_scheduler_simulator_tpu_torch.ops import batch as B
        from kube_scheduler_simulator_tpu_torch.ops import encode as E
        from kube_scheduler_simulator_tpu_torch.ops import kernels as K
        from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine
        from kube_scheduler_simulator_tpu_torch.scheduler.framework_runner import num_feasible_nodes_to_find
        from kube_scheduler_simulator_tpu_torch import workloads
    except ImportError as exc:
        print(f"chip_smoke: the port package is not beside this script ({exc})", file=sys.stderr)
        return 2
    import numpy as np

    assert "jax" not in sys.modules, "the port must not import jax"
    dev = torch.device(DEVICE)

    with Phase("card"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
            f"count {torch.cuda.device_count()}")
    with Phase("build"):
        K.build()
        log(f"kernel build: {K.build_seconds:.2f} s (nvcc, sm_90a, {len(K.SOURCES)} sources in parallel)")

    def make_cluster(name, cut=None):
        """(nodes, all pods, pending pods, volume objects) of a workload, or
        of its cut to (pods, nodes, bound pods)."""
        w = WORKLOADS[name]
        P, N, n_bound = cut or (w.pods, w.nodes, w.bound)
        nodes, all_pods, pending = workloads.cluster(
            P, N, seed=42, n_bound=n_bound, spread=w.spread, interpod=w.interpod,
        )
        vols = {}
        if w.storage:
            workloads.add_host_ports(all_pods)
            vols = workloads.add_volumes(nodes, all_pods, n_bound)
        return nodes, all_pods, pending, vols

    def engine(name, dt, device=DEVICE):
        w = WORKLOADS[name]
        filters, scores = PROFILES[w.profile]
        return BatchEngine(
            filters=list(filters), scores=scores, percentage_of_nodes_to_score=w.pct,
            trace=True, tie_break=w.tie, seed=7, device=device, dtype=dt,
        )

    clusters = {}
    timing: dict = {}
    for name in WORKLOADS:
        t0 = time.perf_counter()
        nodes, all_pods, pending, vols = make_cluster(name)
        pr = E.pad_problem(E.encode(nodes, all_pods, pending, volumes=vols))
        clusters[name] = (nodes, all_pods, pending, vols, pr)
        log(f"{name}: generated and encoded in {time.perf_counter() - t0:.2f} s")

    # ------------------------------------------------ kernel vs plain
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in WORKLOADS:
        w = WORKLOADS[name]
        P, N = w.pods, w.nodes
        nodes, all_pods, pending, vols, pr = clusters[name]
        filters, scores = PROFILES[w.profile]
        cfg = B.BatchConfig(filters=filters, scores=tuple(scores), trace=True, tie_break=w.tie, seed=7)
        for dt in (torch.float32, torch.float64):
            with Phase(f"scan kernel vs plain, {name} {P}x{N}, {dt}"):
                dp, dims = B.lower(pr, dtype=dt, device=dev)
                dp = dp._replace(
                    tb_base=w.base_counter, start0=w.start % N, sample_k=num_feasible_nodes_to_find(N, w.pct),
                )
                ws0 = B.pick_ws0(cfg, dims, dp.sample_k, N)
                log(f"padded P={dims['P']} N={dims['N']} R={dims['R']} sample_k={dp.sample_k} start0={dp.start0} "
                    f"ws0={ws0} SG={dims['SG']} G={dims['G']} D={dims['D']} KC={dims['KC']} KS={dims['KS']} "
                    f"KA={dims['KA']} KB={dims['KB']} KP={dims['KP']} KO={dims['KO']} keys={dims['key_struct']} "
                    f"domain slots {K.domain_layout(dims, dt)} PT={dims['PT']} VR={dims['VR']} VID={dims['VID']} "
                    f"DR={dims['DR']} CLOUD={dims['CLOUD']} lists KPT/KVR/KV="
                    f"{dp.port_cols.shape[1]}/{dp.restr_cols.shape[1]}/{dp.csi_cols.shape[1]} "
                    f"gates {B.plugin_gates(cfg, dims)}")
                log(f"per-block carries (bytes): {json.dumps(carry_bytes(cfg, dims, dp, dt, min(dims['P'], sms)))}")
                kout = K.scan(cfg, dims, dp, ws0=ws0)
                torch.cuda.synchronize()
                plain_ms, pout = cuda_ms(lambda: B.scan_plain(cfg, dims, dp, ws0=ws0), 1, warmup=0)
                if set(kout) != set(pout):
                    raise AssertionError(f"scan output keys differ: {set(kout) ^ set(pout)}")
                err = max(same(f"scan {k}", kout[k], pout[k]) for k in pout)
                del pout
                # warm-up calls first: the first timed scan of the process
                # must not pay for clocks or the allocator settling
                ms, kout = cuda_ms(lambda: K.scan(cfg, dims, dp, ws0=ws0), *((2, 1) if P >= 10000 else (20, 10)))
                fail = kout["fail_plug"][: pr.P_true]
                codes = {
                    f: sorted(set(kout["fail_code"][: pr.P_true][fail == k].unique().tolist()))
                    for k, f in enumerate(filters) if f in ("PodTopologySpread", "InterPodAffinity")
                }
                log(f"scan bitwise equal ({len(kout)} outputs); kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
                    f"scheduled {int((kout['selected'][: pr.P_true] >= 0).sum())}/{pr.P_true}; "
                    f"first-failure codes {codes}")
                if w.storage:
                    # (pod, node) pairs each filter rejected first
                    rejected = {f: int((fail == k).sum()) for k, f in enumerate(filters)}
                    log(f"first rejections per filter: {json.dumps(rejected)}")
                    gates = B.plugin_gates(cfg, dims)
                    off = [g for g in ("ports", "restr", "cloud", "csi") if not gates[g]]
                    none = [f for f in MUST_REJECT if rejected[f] == 0]
                    if off or none:
                        raise AssertionError(f"{name}: gates off {off}; filters that rejected nothing {none}")
                # the compaction on these planes at the widths a round picks
                packed = kout["packed_pod"].cpu().numpy()
                W = min(dims["N"], E._bucket(max(int(packed[3].max()), 1)))
                WS = min(dims["N"], E._bucket(max(int(packed[1].max()), 1)), ws0 or dims["N"])
                mm = kout["trace_meta"].cpu().numpy()
                rdt = tuple(B.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1])) for k in range(len(cfg.scores)))
                cfn, manifest = B.build_compact_fn(cfg, dims, W, WS, rdt, int(mm[-1, 1]), in_step_ws0=ws0)
                cms, kb = cuda_ms(lambda: K.compact(cfg, dims, W, WS, manifest, kout, pr.N_true, ws0), 20)
                cplain_ms, pb = cuda_ms(lambda: B.compact_plain(cfg, dims, W, WS, manifest, kout, pr.N_true, ws0), 3)
                cerr = same("compact blob", kb, pb)
                log(f"compact bitwise equal (W={W} WS={WS} in-step {ws0} mode="
                    f"{B.fail_pack_mode(int(mm[-1, 1]), len(filters))} raw={rdt}, {kb.numel()} bytes); "
                    f"kernel {cms:.3f} ms, plain {cplain_ms:.3f} ms")
                if ws0 is not None:
                    # in-step compaction: the same kernel's full planes,
                    # gathered at the ascending sampled ids, and their blob
                    full = K.scan(cfg, dims, dp)
                    for k, v in gather_sampled(full, ws0).items():
                        same(f"in-step {k} vs full planes gathered", kout[k], v)
                    _ffn, fman = B.build_compact_fn(cfg, dims, W, WS, rdt, int(mm[-1, 1]))
                    fb = K.compact(cfg, dims, W, WS, fman, full, pr.N_true)
                    # the pods' rows: a padding row's sampled cells are
                    # kept in the full planes, masked in the compacted ones
                    ub, uf = (B.unpack_compact_blob(b.cpu().numpy(), manifest) for b in (kb, fb))
                    for k in ub:
                        if not np.array_equal(ub[k][: pr.P_true], uf[k][: pr.P_true]):
                            raise AssertionError(f"in-step blob vs full-plane blob: plane {k} differs")
                    log(f"in-step planes [P,{ws0}] equal the full planes gathered; blobs equal in the pods' rows")
                    del fb
                    del full
                sb, sby = bound(scan_counts(cfg, dims, dp, kout), dt)
                cb, cby = bound(compact_counts(kout, manifest, W, WS, pr.N_true), dt)
                timing[(name, dt)] = t = dict(
                    scan_ms=ms, scan_plain_ms=plain_ms, scan_err=err, scan_bound_ms=sb, scan_bound_by=sby,
                    compact_ms=cms, compact_plain_ms=cplain_ms, compact_err=cerr,
                    compact_bound_ms=cb, compact_bound_by=cby,
                )
                log(f"timing {name} {str(dt).split('.')[-1]}: {json.dumps(t)}")
                del kout, kb, pb, dp
                torch.cuda.empty_cache()

    with Phase("compact kernel vs plain, every fail-pack mode and raw dtype (seeded planes)"):
        rng = np.random.default_rng(11)
        P, N, nt = 1024, 512, 500
        for filters in (FIVE_FILTERS, ()):
            cfg = B.BatchConfig(filters=filters, scores=tuple(FIVE_SCORES), trace=True)
            for code_max in (9, 200, 30000, 70000):
                for rdt in ("int8", "int16", "int32"):
                    for dt in (torch.float32, torch.float64):
                        hi = {"int8": 100, "int16": 30000, "int32": 1 << 22}[rdt]
                        out = {
                            "sample_start": torch.from_numpy(rng.integers(0, nt, P).astype(np.int32)),
                            "sample_processed": torch.from_numpy(rng.integers(1, nt + 1, P).astype(np.int32)),
                            "fail_plug": torch.from_numpy(rng.integers(-1, 5, (P, N)).astype(np.int8)),
                            "fail_code": torch.from_numpy(rng.integers(0, code_max + 1, (P, N)).astype(np.int32)),
                            "feasible": torch.from_numpy(rng.random((P, N)) < 0.5),
                        }
                        for s, _w in FIVE_SCORES:
                            out[f"raw:{s}"] = torch.from_numpy(rng.integers(-hi, hi + 1, (P, N))).to(dt)
                            out[f"norm:{s}"] = torch.from_numpy(rng.integers(0, 101, (P, N))).to(dt)
                        out = {k: v.to(dev) for k, v in out.items()}
                        dims = {"P": P, "N": N}
                        _fn, manifest = B.build_compact_fn(cfg, dims, 384, 256, (rdt,) * 5, code_max)
                        same(
                            f"compact filters={len(filters)} code_max={code_max} raw={rdt} {dt}",
                            K.compact(cfg, dims, 384, 256, manifest, out, nt),
                            B.compact_plain(cfg, dims, 384, 256, manifest, out, nt),
                        )
        log("compact bitwise equal: 2 filter sets x 4 code ranges (modes 0-3) x 3 raw dtypes x 2 float dtypes")

    # ------------------------------------------------------ end to end
    results = {}
    main_launches = None
    for name in WORKLOADS:
        w = WORKLOADS[name]
        P, N = w.pods, w.nodes
        nodes, all_pods, pending, vols, _pr = clusters[name]
        for dt in (torch.float32, torch.float64):
            with Phase(f"end to end BatchEngine(device='cuda'), {name} {P}x{N}, {dt}"):
                eng = engine(name, dt)
                ok, why = eng.supported(pending, nodes, vols)
                assert ok, why
                K.reset_counts()
                t0 = time.perf_counter()
                res = eng.schedule(nodes, all_pods, pending, base_counter=w.base_counter, start_index=w.start,
                                   volumes=vols)
                wall = time.perf_counter() - t0
                launches = dict(K.LAUNCHES)
                if launches != {"scan": 1, "compact": 1}:
                    raise AssertionError(f"the round did not launch each kernel once: {launches}")
                if name == MAIN and dt == torch.float32:
                    main_launches = launches
                sel = res.selected[:P]  # rows past P are shape padding
                assert len(sel) == P and ((sel >= -1) & (sel < N)).all()
                lt = eng.last_timings
                log(f"wall {wall:.3f} s encode_s {lt['encode_s']:.3f} device_s {lt['device_s']:.3f} "
                    f"scheduled {int((sel >= 0).sum())}/{P} launches {launches}")
                stages = {k: round(v, 4) for k, v in eng.profiler.snapshot()["last_wave"].items()}
                log(f"host stages (s): {json.dumps(stages, sort_keys=True)}")
                results[(name, dt)] = res

    for name, cut in ANNOTATION_CHECKS:
        w = WORKLOADS[name]
        P, N = cut[:2] if cut else (w.pods, w.nodes)
        with Phase(f"{name} {P}x{N} annotation bytes: CUDA float64 round vs CPU float64 round"):
            if cut is None:
                nodes, all_pods, pending, vols, _pr = clusters[name]
                gpu = results[(name, torch.float64)]
            else:
                nodes, all_pods, pending, vols = make_cluster(name, cut)
                K.reset_counts()
                gpu = engine(name, torch.float64).schedule(
                    nodes, all_pods, pending, base_counter=w.base_counter, start_index=w.start, volumes=vols,
                )
                assert K.LAUNCHES == {"scan": 1, "compact": 1}, K.LAUNCHES
            cpu = engine(name, torch.float64, device="cpu").schedule(
                nodes, all_pods, pending, base_counter=w.base_counter, start_index=w.start, volumes=vols,
            )
            assert cpu.selected_nodes == gpu.selected_nodes, "selections differ between CUDA and CPU float64"
            for i in range(P):
                if cpu.filter_annotation_json(i) != gpu.filter_annotation_json(i):
                    raise AssertionError(f"pod {i}: filter annotation bytes differ")
                if cpu.score_annotations_json(i) != gpu.score_annotations_json(i):
                    raise AssertionError(f"pod {i}: score annotation bytes differ")
            log(f"{P} pods x 3 annotation documents byte-identical; "
                f"scheduled {sum(s is not None for s in gpu.selected_nodes)}/{P}")

    with Phase("float32 against float64 (CUDA rounds)"):
        f32_report = {}
        for name in WORKLOADS:
            P = WORKLOADS[name].pods
            filters, scores = PROFILES[WORKLOADS[name].profile]
            r32, r64 = results[(name, torch.float32)], results[(name, torch.float64)]
            t32, t64 = r32.out["trace"], r64.out["trace"]
            diff_sel = np.nonzero(r32.selected[:P] != r64.selected[:P])[0]
            per_plugin = {}
            for k, (s, _w) in enumerate(scores):
                rows = [
                    i for i in range(P)
                    if not (np.array_equal(t32["sids"][i], t64["sids"][i])
                            and np.array_equal(t32["raw"][k][i], t64["raw"][k][i])
                            and np.array_equal(t32["norm"][k][i], t64["norm"][k][i]))
                ]
                per_plugin[s] = len(rows)
            # per filter: rows whose first failures of that filter (cells
            # and codes) differ; all rows when the windows differ in width
            per_filter = {}
            same_w = t32["fail_plug"].shape == t64["fail_plug"].shape
            for k, f in enumerate(filters):
                if not same_w:
                    per_filter[f] = P
                    continue
                h32, h64 = t32["fail_plug"][:P] == k, t64["fail_plug"][:P] == k
                c32 = np.where(h32, t32["fail_code"][:P], 0)
                c64 = np.where(h64, t64["fail_code"][:P], 0)
                per_filter[f] = int(((h32 != h64) | (c32 != c64)).any(axis=1).sum())
            rep = {
                "pods": P,
                "selected_differ": int(len(diff_sel)),
                "first_differing_pod": int(diff_sel[0]) if len(diff_sel) else None,
                "score_rows_differ": per_plugin,
                "filter_rows_differ": per_filter,
            }
            if name == "cfg2":
                docs = {"filter": 0, "score": 0, "finalScore": 0}
                for i in range(P):
                    docs["filter"] += r32.filter_annotation_json(i) != r64.filter_annotation_json(i)
                    s32, f32 = r32.score_annotations_json(i)
                    s64, f64 = r64.score_annotations_json(i)
                    docs["score"] += s32 != s64
                    docs["finalScore"] += f32 != f64
                rep["documents_differ"] = docs
            f32_report[name] = rep
            log(f"{name}: float32 vs float64: {json.dumps(rep, sort_keys=True)}")

    ref = MAIN
    main = timing[(ref, torch.float32)]
    kernels = [
        {
            "name": "scan",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scan.cu",
            "replaces": "kube_scheduler_simulator_tpu/ops/batch.py:1185",
            "launches": main_launches["scan"],
            "max_abs_err": main["scan_err"],
            "ms": main["scan_ms"],
            "plain_ms": main["scan_plain_ms"],
            "bound_ms": main["scan_bound_ms"],
            "bound_by": main["scan_bound_by"],
            "library_ms": None,
            "paced_by": "sequential dependency chain over the pod queue",
            "shape": ref,
        },
        {
            "name": "compact",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/compact.cu",
            "replaces": "kube_scheduler_simulator_tpu/ops/batch.py:951",
            "launches": main_launches["compact"],
            "max_abs_err": main["compact_err"],
            "ms": main["compact_ms"],
            "plain_ms": main["compact_plain_ms"],
            "bound_ms": main["compact_bound_ms"],
            "bound_by": main["compact_bound_by"],
            "library_ms": None,
            "shape": ref,
        },
    ]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
