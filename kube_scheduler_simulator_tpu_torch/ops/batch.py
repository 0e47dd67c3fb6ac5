"""The batch scheduling round on the device: lowering, the scan, the trace
compaction, and the host-side trace reconstruction.

Port of the JAX package's ``ops/batch.py``.  Scheduling is sequential over
the pod queue (each bind consumes node resources) and parallel over nodes;
one scan runs a full scheduling cycle per pod over all nodes and commits
into the cluster-state carry:

    carry = (requested [N,R], nonzero [N,2], pod_count [N],
             ports_used [N,PT], restr_used [N,VR], cloud_used [N,3],
             csi_att [N,V], spread_counts [SG,N],
             ip_sel/ip_own/ip_anti [G,D+1], start)
    step  = filters [N] → sampling → scores [N] → normalize → select → commit

Two implementations of each device step live side by side:

- the plain PyTorch versions in this module (``expand_features``,
  ``scan_plain``, ``compact_plain``), which repeat the reference's
  arithmetic op for op and serve CPU tensors;
- the hand-written CUDA kernels of ``ops/kernels.py`` (``csrc/``), which
  serve CUDA tensors and must agree with the plain versions bit for bit.

``build_batch_fn`` / ``build_compact_fn`` return callables that pick one by
the device of the tensors they are given.  The port covers upstream's whole
default profile: the fifteen filters of ``FILTER_KERNELS`` (NodePorts and
the volume filters among them, with their carries) and the scores
NodeResourcesFit (three strategies), NodeResourcesBalancedAllocation,
ImageLocality, TaintToleration, NodeAffinity, PodTopologySpread and
InterPodAffinity, with both tie-breaks, feasible-node sampling and the
in-step compaction of the score planes to ``[P, ws0]``.

The reference expands domain vectors to nodes (and collapses node values
to domains) with one-hot matrix products; here they are gathers through
``node_domain``/``gdom`` and ``index_add_`` sums.  Both are exact: every
value is an integer-valued float far below 2**24.

All math is in the problem dtype: float64 for the bit-exact CPU runs,
float32 on the card, kept exact by the encoder's GCD scaling.  Every
division is a correctly rounded tensor/tensor division: PyTorch divides a
CUDA tensor by a Python scalar as a multiplication by its reciprocal,
which can land a floored quotient on the other side of an integer.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.device import resolve_device, resolve_dtype
from kube_scheduler_simulator_tpu_torch.ops.encode import BatchProblem, _bucket
from kube_scheduler_simulator_tpu_torch.plugins.intree.volumes import CLOUD_LIMIT_PLUGINS

MAX_NODE_SCORE = 100.0
NEG = -1e18
MASK32 = 0xFFFFFFFF
GOLDEN32 = 0x9E3779B9


class BatchConfig(NamedTuple):
    """Static plugin configuration for the batch kernels."""

    filters: tuple  # subset of FILTER_KERNELS, in profile order
    scores: tuple   # ((kernel_name, weight), ...) in profile order
    fit_strategy: str = "LeastAllocated"
    # scoringStrategy.resources: ((col, weight), ...) over the nz axis
    # (0 = cpu, 1 = memory) — upstream default is cpu:1, memory:1
    fit_resources: tuple = ((0, 1), (1, 1))
    # RequestedToCapacityRatio shape: ((utilization, score·10), ...) points
    # ascending in utilization (only read when fit_strategy selects it)
    fit_shape: tuple = ()
    trace: bool = False
    # selectHost tie handling: "first" = first tied max in visit order;
    # "reservoir" = k-th tied max with k from the counter-keyed hash draw
    tie_break: str = "first"
    seed: int = 0
    # > 0: the plain scan's commit one-hot is the straight-through relaxed
    # head, soft + (hard - soft).detach() with soft = softmax(totals / tau)
    # over the sampled nodes: forward values equal the hard rollout's, and
    # torch autograd differentiates the rollout in the weights
    relax_tau: float = 0.0


FILTER_KERNELS = (
    "NodeUnschedulable",
    "NodeName",
    "NodePorts",
    "TaintToleration",
    "NodeAffinity",
    "NodeResourcesFit",
    "VolumeRestrictions",
    "EBSLimits",
    "GCEPDLimits",
    "NodeVolumeLimits",
    "AzureDiskLimits",
    "VolumeBinding",
    "VolumeZone",
    "PodTopologySpread",
    "InterPodAffinity",
)
SCORE_KERNELS = (
    "NodeResourcesFit",
    "NodeResourcesBalancedAllocation",
    "TaintToleration",
    "NodeAffinity",
    "PodTopologySpread",
    "InterPodAffinity",
    "ImageLocality",
)
# per-family cloud volume-count limits: (cloud_cnt column, default limit)
CLOUD_LIMIT_COL = {
    cls.name: (col, float(cls.default_limit)) for col, cls in enumerate(CLOUD_LIMIT_PLUGINS)
}
FIT_STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")
TIE_BREAKS = ("first", "reservoir")

# How each score kernel's NormalizeScore relates raw → normalized; drives
# the trace-fetch plan (build_compact_fn): "identity" plugins fetch ONE
# int8 plane that serves as both raw and norm; "default"/"default_reverse"
# /"minmax" fetch raw only and the host recomputes norm with exact integer
# arithmetic; "custom" fetches both.
NORMALIZE_KIND = {
    "NodeResourcesFit": "identity",
    "NodeResourcesBalancedAllocation": "identity",
    "ImageLocality": "identity",
    "TaintToleration": "default_reverse",
    "NodeAffinity": "default",
    "InterPodAffinity": "minmax",
    "PodTopologySpread": "custom",
}


def check_slice(cfg: BatchConfig) -> None:
    """Raise, naming the plugin, for a configuration the kernels do not
    compute."""
    for kind, names, known in (
        ("filter", cfg.filters, FILTER_KERNELS),
        ("score", [s for s, _w in cfg.scores], SCORE_KERNELS),
    ):
        for name in names:
            if name not in known:
                raise ValueError(f"{kind} plugin {name} has no batch kernel")
    if cfg.fit_strategy not in FIT_STRATEGIES:
        raise ValueError(f"unknown NodeResourcesFit strategy {cfg.fit_strategy}")
    if cfg.tie_break not in TIE_BREAKS:
        raise ValueError(f"unknown tie_break {cfg.tie_break}")


def fail_pack_mode(code_max: int, n_filters: int) -> int:
    """How the (first-fail plugin, code) planes travel: 0 = one uint8
    nibble pair, 1 = one uint16 byte pair, 2/3 = separate planes with
    int16/int32 codes."""
    if code_max <= 15 and n_filters + 1 <= 15:
        return 0
    if code_max <= 255 and n_filters + 1 <= 255:
        return 1
    return 2 if code_max <= 0x7FFF else 3


def raw_dtype_for(mn: int, mx: int) -> str:
    """Minimal fetch dtype for a raw-score plane, with headroom so the
    choice stays stable as the cluster fills."""
    if -100 <= mn and mx <= 100:
        return "int8"
    if -30000 <= mn and mx <= 30000:
        return "int16"
    return "int32"


def trace_fetch_plan(cfg: "BatchConfig", raw_dtypes: "tuple[str, ...]"):
    """Per score plugin: (fetch_raw, fetch_norm, host_norm_kind | None)."""
    plan = []
    for k, (s, _w) in enumerate(cfg.scores):
        kind = NORMALIZE_KIND.get(s, "custom")
        if kind == "identity":
            plan.append((False, True, None))
        elif kind == "custom" or raw_dtypes[k] == "int32":
            # int32 raws: the host's integer normalize is no longer
            # provably equal to the kernel's float path — fetch norm too
            plan.append((True, True, None))
        else:
            plan.append((True, False, kind))
    return tuple(plan)


class DeviceProblem(NamedTuple):
    """BatchProblem lowered to device tensors, field for field the JAX
    package's DeviceProblem (its on-device expansion placeholders, the
    traced weight vector and the one-hot key expansion aside: the port
    reads domains through ``node_domain``/``gdom``).  The four round
    scalars are host ints."""

    alloc: Any            # [N,R]
    max_pods: Any         # [N]
    nz_alloc: Any         # [N,2]
    pod_req: Any          # [P,R]
    pod_nonzero: Any      # [P,2]
    fit_checked: Any      # [P,R] bool
    # Pairwise features, factored through (pod-class × node-class)
    # matrices; the scan gathers a pod's row per node.
    taint_cls: Any        # [L,T] int16: first untolerated taint idx or -1
    taint_prefer_cls: Any # [L,T] int16
    taint_unsched_cls: Any# [L,T] bool
    pod_tol_idx: Any      # [P] int32
    node_taint_idx: Any   # [N] int32
    node_unsched: Any     # [N] bool
    aff_code_cls: Any     # [A,M] int8
    incl_cls: Any         # [A,M] bool
    aff_pref_cls: Any     # [B,M] int32
    pod_aff_idx: Any      # [P] int32
    pod_pref_idx: Any     # [P] int32
    node_label_idx: Any   # [N] int32
    img_cls: Any          # [IC,MC] int8: COMPLETE ImageLocality score
    pod_img_idx: Any      # [P] int32
    node_img_idx: Any     # [N] int32
    name_target: Any      # [P] int32: -1 free, node idx, -2 absent node
    pod_ports: Any        # [P,PT] bool
    port_conflict: Any    # [PT,PT]
    vb_cls: Any           # [VC,M] int8
    vz_cls: Any           # [VC,M] int8
    pod_vol_idx: Any      # [P] int32
    pod_restr: Any        # [P,VR] bool
    restr_conflict: Any   # [VR,VR]
    cloud_cnt: Any        # [P,3]
    pod_csi: Any          # [P,V] bool
    csi_drv_oh: Any       # [V,DR]
    csi_seed_used: Any    # [N,DR]
    csi_limit: Any        # [N,DR]
    # the scan kernel's per-pod lists of set columns (built by lower on
    # the host from the rows above, -1 padded), so it reads the carries
    # only at the pod's own ports, conflict volumes and CSI volume ids
    port_cols: Any        # [P,KPT] int32 columns of pod_ports
    restr_cols: Any       # [P,KVR] int32 columns of pod_restr
    csi_cols: Any         # [P,KV] int32 columns of pod_csi
    csi_drv: Any          # [V] int32 driver column of each volume id, -1 none
    # the term groups each pod matches (term_match's nonzero rows of the
    # pod's column, ascending g), so the scan's InterPodAffinity filter and
    # score walk the pod's few groups instead of every group
    ip_match_g: Any       # [P,KM] int32, -1 padded
    node_domain: Any      # [KT,N] int32
    spf: Any              # spread filter constraints (key,grp,skew,self) [P,KC]
    sps: Any              # spread score constraints [P,KS]
    spread_match: Any     # [SG,P]
    gdom: Any             # [G,N] int32
    term_match: Any       # [G,P]
    ip_aff_g: Any         # [P,KA]
    ip_anti_g: Any        # [P,KB]
    ip_pref_g: Any        # [P,KP]
    ip_pref_w: Any        # [P,KP]
    ip_own_g: Any         # [P,KO]
    ip_own_w: Any         # [P,KO]
    ip_self_match: Any    # [P] bool
    pod_active: Any       # [P] bool (False = padding row, never committed)
    node_active: Any      # [N] bool (False = padding column, never feasible)
    tb_base: int          # attempt counter of the round's first pod (uint32)
    sample_k: int         # stop after this many feasible nodes
    start0: int           # rotation start index for the first pod
    n_true: int           # real node count (modulus; N minus padding)
    spf_ku: Any           # [P, KC] used-key index (dims key_struct)
    sps_ku: Any           # [P, KS]
    # initial carry
    requested0: Any       # [N,R]
    nonzero0: Any         # [N,2]
    pod_count0: Any       # [N]
    ports_used0: Any      # [N,PT]
    restr_used0: Any      # [N,VR]
    cloud_used0: Any      # [N,3]
    csi_attached0: Any    # [N,V]
    spread_counts0: Any   # [SG,N]
    ip_sel0: Any          # [G,D+1]
    ip_own0: Any          # [G,D+1]
    ip_anti0: Any         # [G,D+1]


ROUND_SCALARS = ("tb_base", "sample_k", "start0", "n_true")
# DeviceProblem fields lower() derives from others (volume_lists, term_lists)
LIST_FIELDS = ("port_cols", "restr_cols", "csi_cols", "csi_drv", "ip_match_g")


def _set_columns(mask) -> np.ndarray:
    """[P,C] bool → [P,K] int32: each row's True columns ascending, -1
    padded, K the most any row has (at least 1)."""
    mask = np.asarray(mask, dtype=bool)
    cnt = mask.sum(axis=1)
    K = max(int(cnt.max()) if mask.size else 0, 1)
    order = np.argsort(~mask, axis=1, kind="stable")[:, :K]
    return np.where(np.arange(K)[None, :] < cnt[:, None], order, -1).astype(np.int32)


def volume_lists(pod_ports, pod_restr, pod_csi, csi_drv_oh) -> "dict[str, np.ndarray]":
    """The LIST_FIELDS of a problem from its pod rows and driver one-hot."""
    oh = np.asarray(csi_drv_oh) != 0
    return dict(
        port_cols=_set_columns(pod_ports),
        restr_cols=_set_columns(pod_restr),
        csi_cols=_set_columns(pod_csi),
        csi_drv=np.where(oh.any(axis=1), oh.argmax(axis=1), -1).astype(np.int32),
    )


def term_lists(term_match) -> "dict[str, np.ndarray]":
    """``ip_match_g`` [P, KM] of a problem from its term_match [G, P]: row i
    the groups g with term_match[g, i] != 0, ascending, -1 padded; KM the
    most any pod matches (at least 1), exact as the encoder keeps KA, KB,
    KP and KO."""
    return dict(ip_match_g=_set_columns(np.asarray(term_match).T))

_TORCH_OF_NP = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(bool): torch.bool,
}


def upload(arrays: "dict[Any, np.ndarray]", device: torch.device) -> "dict[Any, torch.Tensor]":
    """Host arrays → tensors on ``device`` in ONE host-to-device copy: every
    array is packed into one aligned byte buffer, shipped once, and viewed
    back out by offset, dtype and shape.  Each call ships a fresh buffer,
    so no view of it aliases an earlier call's."""
    arrays = {k: np.ascontiguousarray(a) for k, a in arrays.items()}
    offs = {}
    off = 0
    for k, a in arrays.items():
        offs[k] = off
        off += -(-a.nbytes // 64) * 64
    buf = np.zeros(max(off, 64), dtype=np.uint8)
    for k, a in arrays.items():
        buf[offs[k] : offs[k] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev_buf = torch.from_numpy(buf).to(device)
    return {
        k: dev_buf[offs[k] : offs[k] + a.nbytes].view(_TORCH_OF_NP[a.dtype]).reshape(a.shape)
        for k, a in arrays.items()
    }


def problem_leaves(host: "dict[str, Any]") -> "dict[tuple[str, int | None], np.ndarray]":
    """The array leaves of a host problem by (field, tuple index or None)."""
    leaves: dict = {}
    for name in DeviceProblem._fields:
        if name in ROUND_SCALARS:
            continue
        val = host[name]
        if isinstance(val, tuple):
            leaves.update({(name, j): v for j, v in enumerate(val)})
        else:
            leaves[(name, None)] = val
    return leaves


def assemble(host: "dict[str, Any]", placed: "dict[tuple[str, int | None], torch.Tensor]") -> DeviceProblem:
    """DeviceProblem from placed leaves and the host round scalars."""
    out: dict[str, Any] = {name: int(host[name]) for name in ROUND_SCALARS}
    for name in DeviceProblem._fields:
        if name in out:
            continue
        val = host[name]
        out[name] = (
            tuple(placed[(name, j)] for j in range(len(val))) if isinstance(val, tuple) else placed[(name, None)]
        )
    return DeviceProblem(**out)


def place(host: "dict[str, Any]", device: torch.device) -> DeviceProblem:
    """Host numpy fields → DeviceProblem on ``device`` in ONE host-to-device
    copy (``upload``)."""
    return assemble(host, upload(problem_leaves(host), device))


def lower(
    pr: BatchProblem, dtype: "torch.dtype | None" = None, device: "str | torch.device | None" = None
) -> "tuple[DeviceProblem, dict]":
    """Convert host BatchProblem → DeviceProblem (+ static dims dict) on
    ``device`` (the card unless the caller asks for the CPU), in the working
    dtype (float32 on the card, float64 on the CPU, unless given)."""
    dev = resolve_device(device)
    host, dims = lower_host(pr, resolve_dtype(dev, dtype))
    return place(host, dev), dims


def lower_host(pr: BatchProblem, dtype: torch.dtype) -> "tuple[dict, dict]":
    """The host half of ``lower``: every DeviceProblem field as a fresh numpy
    array (the round scalars as ints) in ``dtype``, and the dims dict — what
    ``place`` ships in one copy and ``DevicePlacer`` diffs against the
    planes resident on the device."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    f = lambda x: np.asarray(x, dtype=np_dt)
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    b = lambda x: np.asarray(x, dtype=bool)
    D = pr.D
    group_key = np.asarray(pr.group_key)
    gdom = np.asarray(pr.node_domain)[np.clip(group_key, 0, None)]  # [G,N]
    pad = lambda a: np.concatenate([a, np.zeros((a.shape[0], 1), a.dtype)], axis=1)

    # Used topology keys → local index + (kind, first domain, domains)
    node_domain = np.asarray(pr.node_domain)
    used_keys: list[int] = sorted(
        {int(k) for k in group_key.tolist() if pr.G}
        | {int(k) for k in np.asarray(pr.spf_key).ravel().tolist() if k >= 0}
        | {int(k) for k in np.asarray(pr.sps_key).ravel().tolist() if k >= 0}
    )
    ku_of = {k: u for u, k in enumerate(used_keys)}
    N = pr.N
    key_base = list(getattr(pr, "key_base", []))
    key_identity = list(getattr(pr, "key_identity", []))
    key_struct: list[tuple] = []
    for k in used_keys:
        dom = node_domain[k]
        valid = dom >= 0
        base = key_base[k] if k < len(key_base) else 0
        if key_identity[k] if k < len(key_identity) else False:
            key_struct.append(("identity", base, N))
        else:
            size = int(dom[valid].max() - base + 1) if valid.any() else 1
            key_struct.append(("onehot", base, size))
    if not used_keys:
        key_struct.append(("identity", 0, N))

    def remap(keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        lut = np.zeros(max((max(ku_of, default=0) + 1, 1)), dtype=keys.dtype)
        for k, u in ku_of.items():
            lut[k] = u
        return lut[np.clip(keys, 0, len(lut) - 1)]

    host = dict(
        alloc=f(pr.alloc),
        max_pods=f(pr.max_pods),
        nz_alloc=f(pr.nz_alloc),
        pod_req=f(pr.pod_req),
        pod_nonzero=f(pr.pod_nonzero),
        fit_checked=b(pr.fit_checked),
        taint_cls=np.asarray(pr.taint_cls, dtype=np.int16),
        taint_prefer_cls=np.asarray(pr.taint_prefer_cls, dtype=np.int16),
        taint_unsched_cls=b(pr.taint_unsched_cls),
        pod_tol_idx=i32(pr.pod_tol_idx),
        node_taint_idx=i32(pr.node_taint_idx),
        node_unsched=b(pr.node_unsched),
        aff_code_cls=np.asarray(pr.aff_code_cls, dtype=np.int8),
        incl_cls=b(pr.incl_cls),
        aff_pref_cls=i32(pr.aff_pref_cls),
        pod_aff_idx=i32(pr.pod_aff_idx),
        pod_pref_idx=i32(pr.pod_pref_idx),
        node_label_idx=i32(pr.node_label_idx),
        img_cls=np.asarray(pr.img_cls, dtype=np.int8),
        pod_img_idx=i32(pr.pod_img_idx),
        node_img_idx=i32(pr.node_img_idx),
        name_target=i32(pr.name_target),
        pod_ports=b(pr.pod_ports),
        port_conflict=f(pr.port_conflict),
        vb_cls=np.asarray(pr.vb_cls, dtype=np.int8),
        vz_cls=np.asarray(pr.vz_cls, dtype=np.int8),
        pod_vol_idx=i32(pr.pod_vol_idx),
        pod_restr=b(pr.pod_restr),
        restr_conflict=f(pr.restr_conflict),
        cloud_cnt=f(pr.cloud_cnt),
        pod_csi=b(pr.pod_csi),
        csi_drv_oh=f(pr.csi_drv_oh),
        csi_seed_used=f(pr.csi_seed_used),
        csi_limit=f(pr.csi_limit),
        **volume_lists(pr.pod_ports, pr.pod_restr, pr.pod_csi, pr.csi_drv_oh),
        node_domain=i32(pr.node_domain),
        spf=(i32(pr.spf_key), i32(pr.spf_group), f(pr.spf_skew), f(pr.spf_self)),
        sps=(i32(pr.sps_key), i32(pr.sps_group), f(pr.sps_skew), f(pr.sps_self)),
        spread_match=f(pr.spread_match),
        gdom=i32(gdom),
        term_match=f(pr.term_match),
        **term_lists(pr.term_match),
        ip_aff_g=i32(pr.ip_aff_g),
        ip_anti_g=i32(pr.ip_anti_g),
        ip_pref_g=i32(pr.ip_pref_g),
        ip_pref_w=f(pr.ip_pref_w),
        ip_own_g=i32(pr.ip_own_g),
        ip_own_w=f(pr.ip_own_w),
        ip_self_match=b(pr.ip_self_match),
        pod_active=b(pr.pod_active),
        node_active=b(pr.node_active),
        tb_base=0,
        sample_k=pr.N_true,
        start0=0,
        n_true=pr.N_true,
        spf_ku=i32(remap(np.asarray(pr.spf_key))),
        sps_ku=i32(remap(np.asarray(pr.sps_key))),
        requested0=f(pr.requested0),
        nonzero0=f(pr.nonzero0),
        pod_count0=f(pr.pod_count0),
        ports_used0=f(pr.ports_used0),
        restr_used0=f(pr.restr_used0),
        cloud_used0=f(pr.cloud_used0),
        csi_attached0=f(pr.csi_attached0),
        spread_counts0=f(pr.spread_counts0),
        ip_sel0=f(pad(np.asarray(pr.ip_sel0))),
        ip_own0=f(pad(np.asarray(pr.ip_own0))),
        ip_anti0=f(pad(np.asarray(pr.ip_anti0))),
    )
    dims = dict(
        P=pr.P, N=pr.N, R=pr.R, D=D, SG=pr.SG, G=pr.G, PT=pr.PT,
        KC=pr.KC, KS=pr.KS, KA=pr.KA, KB=pr.KB, KP=pr.KP, KO=pr.KO,
        VR=pr.VR, VID=pr.VID, DR=pr.DR, CLOUD=pr.CLOUD,
        key_struct=tuple(key_struct),
    )
    return host, dims


# exact integers in each working dtype: 2^24 in float32, 2^53 in float64
EXACT_LIMIT = {torch.float32: 1 << 24, torch.float64: 1 << 53}


def exactness_bound(pr: BatchProblem) -> "tuple[str, int]":
    """(the column, its largest magnitude) of the resource values a round
    forms in floating point, after GCD scaling, times MAX_NODE_SCORE.

    Per Fit column r: max(requested0, alloc) + the largest pending request;
    per non-zero column (cpu, memory): max(nonzero0, nz_alloc) + the largest
    pending non-zero request.  When that times MAX_NODE_SCORE stays below
    the dtype's limit, every value the round needs is exact:

    - the allocatables and every request are exact integers, and so is a
      sum of them up to the limit;
    - a carry only grows.  Once a running sum passes an allocatable ``a``
      it stays above ``a`` even when it rounds (rounding is monotone and
      ``a`` is representable), so every compare against ``a`` still
      answers right; a sum at or below ``a`` was formed exactly;
    - the score products ``req * 100`` and ``(a - req) * 100`` are taken
      where ``req <= a`` (a fitting node), so they stay below the limit;
    - ``_floordiv``'s divisor ``a`` is below limit / 100, so its correctly
      rounded quotient (a value below 128) is off by less than the gap from
      a non-integer quotient ``x / a`` to the next integer (at least
      ``1 / a``), and the floor lands where the integer floor does.

    Pod counts, per-domain pod counts and domain ids are counts of objects,
    far below 2^24 at any cluster the service holds; they are not checked."""
    def colmax(a: np.ndarray) -> np.ndarray:
        a = np.abs(np.asarray(a, dtype=np.int64))
        return a.max(axis=0) if a.shape[0] else np.zeros(a.shape[1:], dtype=np.int64)

    worst = ("none", 0)
    cols = [
        (f"resource {name}", np.maximum(colmax(pr.requested0), colmax(pr.alloc)) + colmax(pr.pod_req), r)
        for r, name in enumerate(pr.resource_names)
    ] + [
        (f"non-zero {name}", np.maximum(colmax(pr.nonzero0), colmax(pr.nz_alloc)) + colmax(pr.pod_nonzero), c)
        for c, name in enumerate(("cpu", "memory"))
    ]
    for name, mag, j in cols:
        v = int(mag[j]) * int(MAX_NODE_SCORE)
        if v > worst[1]:
            worst = (name, v)
    return worst


def round_dtype(bound: "tuple[str, int]", dtype: torch.dtype) -> "tuple[torch.dtype, str | None]":
    """The dtype a round runs in, given its ``exactness_bound``: ``dtype``
    when its values stay exact there, else float64 with the reason (the
    column and its magnitude).  Raises ``ValueError`` when not even float64
    holds them: a round never runs inexact."""
    col, worst = bound
    if worst < EXACT_LIMIT[dtype]:
        return dtype, None
    if worst >= EXACT_LIMIT[torch.float64]:
        raise ValueError(f"{col}: scaled magnitude x {int(MAX_NODE_SCORE)} = {worst} is beyond exact float64 integers")
    return torch.float64, f"{col}: scaled magnitude x {int(MAX_NODE_SCORE)} = {worst} >= 2^24"


# --------------------------------------------------------------- primitives

def _den(a: torch.Tensor, b) -> torch.Tensor:
    """The denominator ``where(b == 0, 1, b)`` as a tensor beside ``a`` (a
    Python-scalar divisor would turn the division into a reciprocal
    multiplication on the card)."""
    if isinstance(b, torch.Tensor):
        return torch.where(b == 0, torch.ones_like(b), b)
    return torch.full_like(a, float(b) if b != 0 else 1.0)


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    """Go integer division for non-negative operands, in floats."""
    nz = (b != 0) if isinstance(b, torch.Tensor) else float(b != 0)
    return torch.floor(a / _den(a, b)) * nz


def _truncdiv(a: torch.Tensor, b) -> torch.Tensor:
    """Go integer division with truncation toward zero, in floats."""
    nz = (b != 0) if isinstance(b, torch.Tensor) else float(b != 0)
    return torch.trunc(a / _den(a, b)) * nz


def _broken_linear(p: torch.Tensor, shape: tuple) -> torch.Tensor:
    """helper.BuildBrokenLinearFunction over static (utilization, score)
    points: clamp outside the range, Go-integer interpolation inside.
    Descending-index sweep so the FIRST point with p <= utilization wins."""
    out = torch.full_like(p, float(shape[-1][1]))
    for i in range(len(shape) - 1, -1, -1):
        u, s = shape[i]
        if i == 0:
            v = torch.full_like(p, float(s))
        else:
            u0, s0 = shape[i - 1]
            v = float(s0) + _truncdiv(float(s - s0) * (p - float(u0)), float(max(u - u0, 1)))
        out = torch.where(p <= float(u), v, out)
    return out


def _default_normalize(raw: torch.Tensor, feasible: torch.Tensor, reverse: bool) -> torch.Tensor:
    """helper.DefaultNormalizeScore over the feasible set (int semantics)."""
    mx = torch.where(feasible, raw, torch.zeros_like(raw)).max()
    scaled = _floordiv(raw * MAX_NODE_SCORE, mx)
    out = MAX_NODE_SCORE - scaled if reverse else scaled
    zero_case = MAX_NODE_SCORE if reverse else 0.0
    return torch.where(mx == 0, torch.full_like(out, zero_case), out)


def _minmax_normalize(raw: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """InterPodAffinity's ScoreExtensions: MAX*(v-min)/(max-min), floored."""
    inf = torch.full_like(raw, float("inf"))
    mn = torch.where(feasible, raw, inf).min()
    mx = torch.where(feasible, raw, -inf).max()
    diff = mx - mn
    q = torch.floor(MAX_NODE_SCORE * (raw - mn) / torch.where(diff == 0, torch.ones_like(diff), diff))
    return torch.where(diff > 0, q, torch.zeros_like(q))


_WEIGHT_ROWS: "dict[tuple, torch.Tensor]" = {}


def weight_row(weights, dt: torch.dtype, device) -> torch.Tensor:
    """An [S] weight vector as a tensor in the round's dtype on ``device``,
    made once per (vector, dtype, device): an upload per launch would block
    the host until the card drains, and windowed rounds queue launches
    ahead of the host.  The row is shared; nothing writes into it."""
    key = (tuple(float(w) for w in weights), dt, str(torch.device(device)))
    row = _WEIGHT_ROWS.get(key)
    if row is None:
        if len(_WEIGHT_ROWS) >= 64:
            _WEIGHT_ROWS.clear()
        row = _WEIGHT_ROWS[key] = torch.tensor(key[0], dtype=dt, device=device)
    return row


def profile_weights(cfg: BatchConfig, dt: torch.dtype, device) -> torch.Tensor:
    """The profile's score weights as an [S] row (``weight_row``): the
    scan's weight vector when no override is given."""
    return weight_row([w for _s, w in cfg.scores], dt, device)


def _mix32(x):
    """murmur3 32-bit finalizer on uint32 values held in int64 (or Python
    ints), masked after every multiply."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK32
    x = x ^ (x >> 16)
    return x


def tie_break_draw(seed: int, counter: int) -> int:
    """The uint32 draw for scheduling attempt ``counter`` under ``seed``."""
    return _mix32(_mix32((seed ^ GOLDEN32) & MASK32) ^ _mix32(counter & MASK32))


# ------------------------------------------------------------- plain scan

def expand_features(dp: DeviceProblem, dt: torch.dtype) -> dict:
    """Expand the factored (pod-class × node-class) feature matrices to the
    dense [P,N] planes the step reads — the plain version of the JAX
    ``_expand_features``; the scan kernel gathers per pod row instead."""
    def pair(cls, pi, ni):
        return cls[pi.long()][:, ni.long()]

    N = dp.node_active.shape[0]
    tu = pair(dp.taint_unsched_cls, dp.pod_tol_idx, dp.node_taint_idx)
    idx_n = torch.arange(N, dtype=torch.int32, device=dp.node_active.device)
    tgt = dp.name_target[:, None]
    return dict(
        taint_fail=pair(dp.taint_cls, dp.pod_tol_idx, dp.node_taint_idx),
        taint_prefer=pair(dp.taint_prefer_cls, dp.pod_tol_idx, dp.node_taint_idx).to(dt),
        unsched_ok=(~dp.node_unsched)[None, :] | tu,
        aff_code=pair(dp.aff_code_cls, dp.pod_aff_idx, dp.node_label_idx),
        aff_pref=pair(dp.aff_pref_cls, dp.pod_pref_idx, dp.node_label_idx).to(dt),
        name_ok=torch.where(tgt == -1, True, tgt == idx_n[None, :]),
        incl=pair(dp.incl_cls, dp.pod_aff_idx, dp.node_label_idx),
        img_score=pair(dp.img_cls, dp.pod_img_idx, dp.node_img_idx).to(dt),
        vb_code=pair(dp.vb_cls, dp.pod_vol_idx, dp.node_label_idx),
        vz_code=pair(dp.vz_cls, dp.pod_vol_idx, dp.node_label_idx),
    )


def log_table(n: int, dt: torch.dtype, device) -> torch.Tensor:
    """``log(t + 2)`` for t = 0..n in the working dtype: PodTopologySpread's
    topology-size weight.  One ``torch.log`` call per round; the plain scan
    and the kernel both read this table, so they use the same logarithm."""
    return torch.log(torch.arange(n + 1, dtype=dt, device=device) + 2.0)


def _domain_index(dom: torch.Tensor, base: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """(has the key [N], domain index within the key [N], 0 where absent)."""
    ok = dom >= 0
    return ok, torch.where(ok, dom - base, 0).long()


def _domain_sums(ok: torch.Tensor, d: torch.Tensor, size: int, vals: torch.Tensor) -> torch.Tensor:
    """Per-domain sums of per-node values over the nodes that have the key
    (the reference's ``one_hot @ vals``)."""
    z = torch.zeros(size, dtype=vals.dtype, device=vals.device)
    return z.index_add_(0, d, torch.where(ok, vals, 0))


def _spread_filter_code(dom, m, incl, kind_base_size, self_match, max_skew) -> torch.Tensor:
    """One DoNotSchedule constraint's code per node: 1 = the node lacks the
    key, 2 = placing the pod there would exceed maxSkew."""
    kind, base, size = kind_base_size
    contributing = incl & (dom >= 0)
    mc = torch.where(contributing, m, 0)
    if kind == "identity":  # each node is its own domain
        present = contributing
        mn = torch.where(present, mc, float("inf")).min()
        match = mc
    else:
        ok, d = _domain_index(dom, base)
        dc = _domain_sums(ok, d, size, mc)
        present = _domain_sums(ok, d, size, contributing.to(mc.dtype)) > 0
        mn = torch.where(present, dc, float("inf")).min()
        match = torch.where(ok, dc[d], 0)
    min_match = torch.where(present.any(), mn, torch.zeros_like(mn))
    skew = match + self_match - min_match
    return torch.where(dom < 0, 1, torch.where(skew > max_skew, 2, 0)).to(torch.int32)


def _spread_score(cons, dp, spread_counts, sampled, key_struct, logt):
    """PodTopologySpread's raw and normalized score of one pod with score
    constraints ``cons`` = [(key, group, local key, maxSkew), ...]."""
    N = sampled.shape[0]
    has_all = torch.ones(N, dtype=torch.bool, device=sampled.device)
    for key, _g, _u, _skew in cons:
        has_all = has_all & (dp.node_domain[key] >= 0)
    raw_f = torch.zeros(N, dtype=logt.dtype, device=sampled.device)
    fni = sampled & has_all
    for key, g, u, skew in cons:
        dom = dp.node_domain[key]
        mc = torch.where(has_all, spread_counts[g], 0)
        kind, base, size = key_struct[u]
        if kind == "identity":
            cnt = mc
            tsize = fni.sum()
        else:
            ok, d = _domain_index(dom, base)
            cnt = torch.where(ok, _domain_sums(ok, d, size, mc)[d], 0)
            tsize = (_domain_sums(ok, d, size, fni.to(mc.dtype)) > 0).sum()
        raw_f = raw_f + (cnt * logt[tsize] + (skew - 1.0))
    raw = torch.round(raw_f)  # half to even, as jnp.round
    mn = torch.where(fni, raw, float("inf")).min()
    mx = torch.where(fni, raw, float("-inf")).max()
    norm = torch.where(mx == 0, MAX_NODE_SCORE, _floordiv(MAX_NODE_SCORE * (mx + mn - raw), mx))
    return raw, torch.where(~has_all | ~fni.any(), 0.0, norm)


def _fit_raw(cfg: BatchConfig, req_nz: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """NodeResourcesFit's score over the nonzero-request columns."""
    fits = (a > 0) & (req_nz <= a)
    zero = torch.zeros_like(a)
    if cfg.fit_strategy == "MostAllocated":
        per_r = torch.where(fits, _floordiv(req_nz * MAX_NODE_SCORE, a), zero)
    elif cfg.fit_strategy == "RequestedToCapacityRatio":
        # zero/over capacity evaluates the shape at 100, not 0
        util = torch.where(fits, _floordiv(req_nz * MAX_NODE_SCORE, a), torch.full_like(a, 100.0))
        per_r = _broken_linear(util, cfg.fit_shape)
    else:  # LeastAllocated
        per_r = torch.where(fits, _floordiv((a - req_nz) * MAX_NODE_SCORE, a), zero)
    wsum = float(sum(w for _, w in cfg.fit_resources)) or 1.0
    return _floordiv(sum(per_r[:, c] * float(w) for c, w in cfg.fit_resources), wsum)


def in_step_width(cfg: BatchConfig, dims: dict, ws0: "int | None") -> "int | None":
    """The score planes' width when the step compacts them (the reference's
    ``ws0`` rule: trace on, filters present, ``ws0 < N``), else None."""
    return ws0 if cfg.trace and ws0 is not None and ws0 < dims["N"] and cfg.filters else None


def pick_ws0(cfg: BatchConfig, dims: dict, sample_k: int, n_nodes: int) -> "int | None":
    """The in-step compaction width a round takes: bucket(sample_k) where
    sampling narrows the nodes (the reference's batch_engine.py:1568-1577)."""
    if sample_k >= n_nodes:
        return None
    return in_step_width(cfg, dims, min(dims["N"], _bucket(max(sample_k, 1))))


# DeviceProblem fields that are the scan's initial carry, in the JAX
# package's carry order: a windowed scan takes them from the previous
# window (``carry0=``) and hands them on (``out["final_carry"]``).
CARRY0_FIELDS = (
    "requested0", "nonzero0", "pod_count0", "ports_used0", "restr_used0",
    "cloud_used0", "csi_attached0", "spread_counts0",
    "ip_sel0", "ip_own0", "ip_anti0", "start0",
)

# DeviceProblem fields carrying the pod axis (axis 0 / axis 1): the
# windowed scan reads exactly these at its [offset, offset+Wp) rows (the
# JAX package's lists, plus the port's per-pod column lists).
POD_WINDOW_AXIS0 = (
    "pod_req", "pod_nonzero", "fit_checked", "pod_tol_idx", "pod_aff_idx",
    "pod_pref_idx", "pod_img_idx", "name_target", "pod_ports", "pod_vol_idx",
    "pod_restr", "cloud_cnt", "pod_csi", "ip_aff_g", "ip_anti_g", "ip_pref_g",
    "ip_pref_w", "ip_own_g", "ip_own_w", "ip_self_match", "pod_active",
    "spf_ku", "sps_ku", "port_cols", "restr_cols", "csi_cols", "ip_match_g",
)
POD_WINDOW_AXIS1 = ("spread_match", "term_match")


def slice_pod_window(dp: DeviceProblem, offset: int, Wp: int) -> DeviceProblem:
    """The [offset, offset+Wp) pod-window view of a DeviceProblem (the JAX
    ``slice_pod_window``): the pod-axis fields are narrowed (views, no
    copies), node-axis state and class matrices pass through, and tb_base
    shifts by the offset (uint32 wrap) so the counter-keyed tie-break draws
    stay those of each pod's position in the whole round."""
    repl: dict = {f: getattr(dp, f).narrow(0, offset, Wp) for f in POD_WINDOW_AXIS0}
    repl.update({f: getattr(dp, f).narrow(1, offset, Wp) for f in POD_WINDOW_AXIS1})
    repl["spf"] = tuple(a.narrow(0, offset, Wp) for a in dp.spf)
    repl["sps"] = tuple(a.narrow(0, offset, Wp) for a in dp.sps)
    repl["tb_base"] = (int(dp.tb_base) + int(offset)) & MASK32
    return dp._replace(**repl)


def final_carry(out: dict, start) -> dict:
    """The whole final carry of a scan's outputs under CARRY0_FIELDS names:
    the next window's ``carry0``."""
    return dict(
        requested0=out["final_requested"], nonzero0=out["final_nonzero"], pod_count0=out["final_pod_count"],
        ports_used0=out["final_ports_used"], restr_used0=out["final_restr_used"],
        cloud_used0=out["final_cloud_used"], csi_attached0=out["final_csi_att"],
        spread_counts0=out["final_spread_counts"], ip_sel0=out["final_ip_sel"],
        ip_own0=out["final_ip_own"], ip_anti0=out["final_ip_anti"], start0=start,
    )


def scan_plain(
    cfg: BatchConfig, dims: dict, dp: DeviceProblem, ws0: "int | None" = None,
    carry0: "dict | None" = None, offset: int = 0, window: "int | None" = None,
    weights: "torch.Tensor | None" = None, grad: "tuple | None" = None, residual: "float | None" = None,
) -> dict:
    """The whole pod loop of one round in plain PyTorch, op for op the JAX
    ``build_batch_fn`` step (filters with first-failure tracking, rotated
    feasible-node sampling, scores and normalization, selection with either
    tie-break, commit).  Returns the JAX outputs under the same keys, and
    the whole final carry (the JAX package's ``_final_carry``): as
    ``final_carry`` under CARRY0_FIELDS names, and field by field as
    ``final_requested`` ... ``final_csi_att``, ``final_spread_counts``,
    ``final_ip_sel``, ``final_ip_own``, ``final_ip_anti``, ``final_start``.
    ``ws0``: the in-step compaction width (``in_step_width``): the score
    planes come out [P, ws0], the sampled nodes' values in ascending node
    id, and no ``feasible`` plane.  ``window``: run only pods [offset,
    offset+window) (the JAX ``build_batch_fn(window=)``), from ``carry0``
    (a ``final_carry`` dict; default the problem's own initial carry).
    ``weights``: the [S] weight vector in the round's dtype (the JAX
    ``DeviceProblem.plugin_w``; default the profile's).  ``cfg.relax_tau > 0``: the straight-through commit (see
    BatchConfig).  ``grad=(F, tau)``: also accumulate K2g's closed form
    (``grad_plain``) into ``out["dw"]``; ``residual=tau``: K2g's residual
    (``grad_residual_plain``) into ``out["resid"]``."""
    check_slice(cfg)
    ws0 = in_step_width(cfg, dims, ws0)
    if window is not None:
        dp = slice_pod_window(dp, offset, window)
        dims = dict(dims, P=window)
    if carry0 is not None:
        dp = dp._replace(**carry0)
    P, N, R, D = dims["P"], dims["N"], dims["R"], dims["D"]
    if R > 30:
        raise ValueError(f"{R} distinct checked resources exceed the int32 reason bitmask (30)")
    dev = dp.alloc.device
    dt = dp.alloc.dtype
    i32 = torch.int32
    X = expand_features(dp, dt)
    requested = dp.requested0.clone()
    nonzero = dp.nonzero0.clone()
    pod_count = dp.pod_count0.clone()
    gates = plugin_gates(cfg, dims)
    ports_used, restr_used = dp.ports_used0.clone(), dp.restr_used0.clone()
    cloud_used, csi_att = dp.cloud_used0.clone(), dp.csi_attached0.clone()
    spread_counts = dp.spread_counts0.clone()
    ip_sel, ip_own, ip_anti = dp.ip_sel0.clone(), dp.ip_own0.clone(), dp.ip_anti0.clone()
    key_struct = dims["key_struct"]
    logt = log_table(N, dt, dev)
    w_vec = profile_weights(cfg, dt, dev) if weights is None else weights
    if w_vec.shape != (len(cfg.scores),) or w_vec.dtype != dt:
        raise ValueError(f"weights must be {dt} [{len(cfg.scores)}], got {w_vec.dtype} {tuple(w_vec.shape)}")
    tau = cfg.relax_tau if grad is None else grad[1]
    if grad is not None:
        F_n = grad[0]
        dw = torch.zeros(len(cfg.scores), dtype=torch.float64, device=dev)
    if residual is not None:
        resid = torch.zeros((2, len(cfg.scores), N), dtype=torch.float64, device=dev)
    # the per-pod constraint and term lists, read on the host
    host = {f: t.cpu().numpy() for f, t in (
        ("spf_key", dp.spf[0]), ("spf_grp", dp.spf[1]), ("spf_ku", dp.spf_ku),
        ("sps_key", dp.sps[0]), ("sps_grp", dp.sps[1]), ("sps_ku", dp.sps_ku),
        ("aff_g", dp.ip_aff_g), ("anti_g", dp.ip_anti_g), ("pref_g", dp.ip_pref_g), ("own_g", dp.ip_own_g),
    )}
    gvalid, gidx = _domain_index(dp.gdom, 0)
    g_rows = torch.arange(gidx.shape[0], device=dev)

    def at_nodes(carry, g=None):
        """A [G,D+1] carry read at each node's domain of each group ([G,N]),
        or of group ``g`` ([N]); 0 where the node lacks the key."""
        if g is None:
            return torch.where(gvalid, carry.gather(1, gidx), 0)
        return torch.where(gvalid[g], carry[g][gidx[g]], 0)
    start = torch.as_tensor(dp.start0, dtype=i32, device=dev).reshape(())
    nt, K = int(dp.n_true), int(dp.sample_k)
    idx = torch.arange(N, dtype=i32, device=dev)
    filter_pos = {f: k for k, f in enumerate(cfg.filters)}

    packed = torch.zeros((5, P), dtype=i32, device=dev)
    out: dict = {}
    if cfg.trace:
        out["fail_plug"] = torch.empty((P, N), dtype=torch.int8, device=dev)
        out["fail_code"] = torch.empty((P, N), dtype=i32, device=dev)
        if ws0 is None:
            out["feasible"] = torch.empty((P, N), dtype=torch.bool, device=dev)
        for name, _w in cfg.scores:
            out[f"raw:{name}"] = torch.empty((P, ws0 or N), dtype=dt, device=dev)
            out[f"norm:{name}"] = torch.empty((P, ws0 or N), dtype=dt, device=dev)

    def rot_cumsum(mask):
        """c[n] = number of True entries with visit rank <= r[n] (a cumsum
        in rotation order), plus the total count."""
        pref = torch.cumsum(mask.to(i32), 0, dtype=i32)
        tot = pref[N - 1]
        ps = torch.where(start == 0, 0, pref[torch.clamp(start - 1, min=0).long()])
        return torch.where(idx >= start, pref - ps, pref + (tot - ps)), tot

    for i in range(P):
        pod_req = dp.pod_req[i]
        fail_plug = torch.full((N,), -1, dtype=torch.int8, device=dev)
        fail_code = torch.zeros(N, dtype=i32, device=dev)
        feasible = dp.node_active.clone()

        def apply(name, code):
            nonlocal feasible, fail_plug, fail_code
            if cfg.trace:
                hit = (fail_plug < 0) & (code != 0)
                fail_plug = torch.where(hit, filter_pos[name], fail_plug)
                fail_code = torch.where(hit, code, fail_code)
            feasible = feasible & (code == 0)

        one, zero_i = torch.ones(N, dtype=i32, device=dev), torch.zeros(N, dtype=i32, device=dev)
        for name in cfg.filters:
            if name == "NodeUnschedulable":
                apply(name, torch.where(X["unsched_ok"][i], zero_i, one))
            elif name == "NodeName":
                apply(name, torch.where(X["name_ok"][i], zero_i, one))
            elif name == "TaintToleration":
                tfail = X["taint_fail"][i].to(i32)
                apply(name, torch.where(tfail < 0, zero_i, tfail + 1))
            elif name == "NodeAffinity":
                apply(name, X["aff_code"][i].to(i32))
            elif name == "NodePorts" and gates["ports"]:
                # ports_used is already in wanted-class conflict space
                clash = (ports_used * dp.pod_ports[i][None, :].to(dt)).sum(1)
                apply(name, (clash > 0).to(i32))
            elif name == "NodeResourcesFit":
                free = dp.alloc - requested
                insuff = (pod_req[None, :] > free) & dp.fit_checked[i][None, :]
                too_many = pod_count + 1.0 > dp.max_pods
                # bit 0: Too many pods; bit r+1: Insufficient resource r
                code = too_many.to(i32)
                for r in range(R):
                    code = code | (insuff[:, r].to(i32) << (r + 1))
                apply(name, code)
            elif name == "VolumeBinding":
                apply(name, X["vb_code"][i].to(i32))
            elif name == "VolumeZone":
                apply(name, X["vz_code"][i].to(i32))
            elif name == "VolumeRestrictions" and gates["restr"]:
                clash = (restr_used * dp.pod_restr[i][None, :].to(dt)).sum(1)
                apply(name, (clash > 0).to(i32))
            elif name in CLOUD_LIMIT_COL and gates["cloud"]:
                col, limit = CLOUD_LIMIT_COL[name]
                want = dp.cloud_cnt[i, col]
                apply(name, ((want > 0) & (cloud_used[:, col] + want > limit)).to(i32))
            elif name == "NodeVolumeLimits" and gates["csi"]:
                new = dp.pod_csi[i].to(dt)[None, :] * (1.0 - csi_att)  # [N,V]
                need_d = new @ dp.csi_drv_oh  # [N,DR]; exact: 0/1 entries
                used_d = dp.csi_seed_used + csi_att @ dp.csi_drv_oh
                over = (need_d > 0) & (used_d + need_d > dp.csi_limit)
                apply(name, over.any(1).to(i32))
            elif name == "PodTopologySpread" and gates["spread_filter"]:
                code = torch.zeros(N, dtype=i32, device=dev)
                for k in range(dims["KC"]):
                    key = int(host["spf_key"][i, k])
                    if key < 0:
                        continue
                    k_code = _spread_filter_code(
                        dp.node_domain[key], spread_counts[int(host["spf_grp"][i, k])], X["incl"][i],
                        key_struct[int(host["spf_ku"][i, k])], dp.spf[3][i, k], dp.spf[2][i, k],
                    )
                    code = torch.where(code == 0, k_code, code)
                apply(name, code)
            elif name == "InterPodAffinity" and gates["interpod"]:
                tm = dp.term_match[:, i]
                # existing pods' required anti-affinity toward this pod
                code = torch.where((tm[:, None] * at_nodes(ip_anti)).sum(0) > 0, 1, 0).to(i32)
                aff = [int(g) for g in host["aff_g"][i] if g >= 0]
                if aff:
                    sat = torch.ones(N, dtype=torch.bool, device=dev)
                    total_any = torch.zeros((), dtype=dt, device=dev)
                    for g in aff:
                        sat = sat & (at_nodes(ip_sel, g) > 0) & gvalid[g]
                        total_any = total_any + ip_sel[g, :D].sum()
                    # the first pod of a group that matches its own terms
                    escape = (total_any == 0) & dp.ip_self_match[i]
                    code = torch.where((code == 0) & ~sat & ~escape, 2, code)
                for g in host["anti_g"][i]:
                    if g >= 0:
                        code = torch.where((code == 0) & (at_nodes(ip_sel, int(g)) > 0), 3, code)
                apply(name, code)

        # feasible-node sampling: visit rank r = (n - start) mod n_true;
        # "the first K feasible in visit order" is a rotated prefix sum
        r = torch.where(idx >= start, idx - start, idx - start + nt)
        c, total = rot_cumsum(feasible)
        sampled = feasible & (c <= K)
        processed = torch.where(
            total >= K,
            torch.where(feasible & (c == K), r + 1, 0).sum().to(i32),
            torch.tensor(nt, dtype=i32, device=dev),
        )
        count = torch.clamp(total, max=K) * dp.pod_active[i]

        totals = torch.zeros(N, dtype=dt, device=dev)
        raws, norms = {}, {}
        norm_rows = []
        for k_s, (name, _weight) in enumerate(cfg.scores):
            if name == "NodeResourcesFit":
                raw = _fit_raw(cfg, nonzero + dp.pod_nonzero[i][None, :], dp.nz_alloc)
                norm = raw
            elif name == "NodeResourcesBalancedAllocation":
                req_nz = nonzero + dp.pod_nonzero[i][None, :]
                a = dp.nz_alloc
                frac = torch.where(
                    a > 0, torch.clamp(req_nz / _den(a, a), max=1.0), torch.ones_like(a)
                )
                std = torch.abs(frac[:, 0] - frac[:, 1]) / 2.0
                raw = torch.floor((1.0 - std) * MAX_NODE_SCORE)
                norm = raw
            elif name == "ImageLocality":
                raw = X["img_score"][i]
                norm = raw
            elif name == "TaintToleration":
                raw = X["taint_prefer"][i]
                norm = _default_normalize(raw, sampled, reverse=True)
            elif name == "NodeAffinity":
                raw = X["aff_pref"][i]
                norm = _default_normalize(raw, sampled, reverse=False)
            elif name == "PodTopologySpread" and gates["spread_score"] and host["sps_key"][i, 0] >= 0:
                cons = [
                    (int(host["sps_key"][i, k]), int(host["sps_grp"][i, k]), int(host["sps_ku"][i, k]), dp.sps[2][i, k])
                    for k in range(dims["KS"]) if host["sps_key"][i, k] >= 0
                ]
                raw, norm = _spread_score(cons, dp, spread_counts, sampled, key_struct, logt)
            elif name == "InterPodAffinity" and gates["interpod"]:
                raw = (dp.term_match[:, i][:, None] * at_nodes(ip_own)).sum(0)
                for k, g in enumerate(host["pref_g"][i]):
                    if g >= 0:
                        raw = raw + dp.ip_pref_w[i, k] * at_nodes(ip_sel, int(g))
                norm = _minmax_normalize(raw, sampled)
            else:  # a plugin with nothing to score in this problem
                raw = torch.zeros(N, dtype=dt, device=dev)
                norm = raw
            if cfg.trace:
                raws[name], norms[name] = raw, norm
            norm_rows.append(norm)
            totals = totals + norm * w_vec[k_s]

        # ties are ordered by VISIT rank, not node index
        masked = torch.where(sampled, totals, torch.full_like(totals, NEG))
        tied = sampled & (masked == masked.max())
        if cfg.tie_break == "reservoir":
            ct, t_count = rot_cumsum(tied)
            draw = tie_break_draw(cfg.seed, dp.tb_base + i)
            k = torch.remainder(torch.tensor(draw, device=dev), torch.clamp(t_count, min=1).long())
            sel = torch.argmax((tied & (ct == k + 1)).to(i32)).to(i32)
        else:
            sel = torch.argmin(torch.where(tied, r, 2 * nt + N)).to(i32)
        sel = torch.where(count > 0, sel, -1)

        # commit
        commit = count > 0
        oh = ((idx == sel) & commit).to(dt)
        if grad is not None and bool(commit):
            # K2g's term of this pod: s = softmax(totals / tau) over the
            # sampled nodes, c = F . pod_nonzero, and for each weight
            # (1 / tau) sum_n s (c - sum_m s c) norm_k
            s_n = torch.softmax(torch.where(sampled, totals / _den(totals, tau), NEG), 0)
            c_n = F_n[:, 0] * dp.pod_nonzero[i, 0] + F_n[:, 1] * dp.pod_nonzero[i, 1]
            cbar = (s_n * c_n).sum()
            g = ((s_n * (c_n - cbar))[None, :] * torch.stack(norm_rows)).sum(1)
            dw = dw + (g / _den(g, tau)).double()
        if residual is not None and bool(commit):
            # K2g's residual: e = exp(z - max z) over the sampled nodes, s =
            # e / sum e, nbar_k = sum e norm_k / sum e, and M[j,k,n] +=
            # pnz_j s[n] (norm_k[n] - nbar_k)
            z = torch.where(sampled, totals / _den(totals, residual), NEG)
            e_n = torch.exp(z - z.max())
            norms = torch.stack(norm_rows)
            esum = e_n.sum()
            nbar = (e_n[None, :] * norms).sum(1) / esum
            d = (e_n / esum).double()[None, :] * (norms.double() - nbar.double()[:, None])
            resid = resid + dp.pod_nonzero[i].double()[:, None, None] * d[None]
        if cfg.relax_tau > 0:
            soft = torch.softmax(torch.where(sampled, totals / _den(totals, tau), NEG), 0) * commit.to(dt)
            oh = soft + (oh - soft).detach()
        requested = requested + oh[:, None] * pod_req[None, :]
        nonzero = nonzero + oh[:, None] * dp.pod_nonzero[i][None, :]
        pod_count = pod_count + oh
        if gates["ports"]:
            # project the committed pod's triples onto every wanted class
            # they conflict with
            ports_used = ports_used + oh[:, None] * (dp.port_conflict @ dp.pod_ports[i].to(dt))[None, :]
        if gates["restr"]:
            restr_used = restr_used + oh[:, None] * (dp.restr_conflict @ dp.pod_restr[i].to(dt))[None, :]
        if gates["cloud"]:
            cloud_used = cloud_used + oh[:, None] * dp.cloud_cnt[i][None, :]
        if gates["csi"]:
            # shared volume ids stay one attachment: max, not add
            csi_att = torch.maximum(csi_att, oh[:, None] * dp.pod_csi[i][None, :].to(dt))
        if dims["SG"] > 0:
            spread_counts = spread_counts + dp.spread_match[:, i][:, None] * oh[None, :]
        if gates["interpod"]:
            # column D is the sink for a group whose key the node lacks
            sel_safe = torch.clamp(sel, min=0).long()
            d_g = dp.gdom[:, sel_safe]
            d_g = torch.where((d_g >= 0) & commit, d_g, D).long()
            ip_sel = ip_sel.index_put((g_rows, d_g), dp.term_match[:, i] * commit, accumulate=True)
            for carry, groups, weights in ((ip_own, host["own_g"][i], dp.ip_own_w[i]), (ip_anti, host["anti_g"][i], None)):
                for k, g in enumerate(groups):
                    if g < 0:
                        continue
                    dd = dp.gdom[int(g), sel_safe]
                    dd = torch.where((dd >= 0) & commit, dd, D).long().view(1)
                    w = commit.to(dt) if weights is None else weights[k] * commit
                    carry[int(g)].index_add_(0, dd, w.view(1))
        packed[0, i] = sel
        packed[1, i] = count
        packed[2, i] = start
        packed[3, i] = processed
        # the rotating start advances by the number of visited nodes
        next_start = (start + processed) % max(nt, 1) if nt > 0 else torch.zeros_like(start)
        start = torch.where(dp.pod_active[i], next_start, start)
        if cfg.trace:
            out["fail_plug"][i] = fail_plug
            out["fail_code"][i] = fail_code
            if ws0 is None:
                out["feasible"][i] = sampled
                for name in raws:
                    out[f"raw:{name}"][i] = raws[name]
                    out[f"norm:{name}"][i] = norms[name]
            else:
                # in-step compaction: the sampled nodes' values at their
                # rank in ascending node id, the rest of the row zero
                pos_id = torch.cumsum(sampled.to(i32), 0, dtype=i32) - 1
                dest = torch.where(sampled & (pos_id < ws0), pos_id, ws0).long()
                for name in raws:
                    for kind, v in (("raw", raws[name]), ("norm", norms[name])):
                        row = torch.zeros(ws0 + 1, dtype=dt, device=dev).scatter_(0, dest, v)
                        out[f"{kind}:{name}"][i] = row[:ws0]

    packed[4] = start
    out.update(
        selected=packed[0],
        feasible_count=packed[1],
        sample_start=packed[2],
        sample_processed=packed[3],
        final_requested=requested,
        final_nonzero=nonzero,
        final_pod_count=pod_count,
        final_ports_used=ports_used,
        final_restr_used=restr_used,
        final_cloud_used=cloud_used,
        final_csi_att=csi_att,
        final_spread_counts=spread_counts,
        final_ip_sel=ip_sel,
        final_ip_own=ip_own,
        final_ip_anti=ip_anti,
        final_start=start,
        packed_pod=packed,
    )
    out["final_carry"] = final_carry(out, start)
    if grad is not None:
        out["dw"] = dw
    if residual is not None:
        out["resid"] = resid
    if cfg.trace:
        if ws0 is None:
            feas = out["feasible"] & dp.pod_active[:, None]
        else:  # positional: column < the pod's feasible count
            feas = torch.arange(ws0, dtype=i32, device=dev)[None, :] < packed[1][:, None]
        rows = []
        zero = torch.zeros((), dtype=i32, device=dev)
        for s, _w in cfg.scores:
            v = torch.where(feas, out[f"raw:{s}"], torch.zeros((), dtype=dt, device=dev))
            # an empty round's planes have no cells: its range is [0, 0]
            rows.append(torch.stack([v.min().to(i32), v.max().to(i32)]) if v.numel() else torch.stack([zero, zero]))
        code_max = out["fail_code"].max().to(i32) if cfg.filters and out["fail_code"].numel() else zero
        rows.append(torch.stack([zero, code_max]))
        out["trace_meta"] = torch.stack(rows)
    return out


def plugin_gates(cfg: BatchConfig, dims: dict) -> "dict[str, bool]":
    """Which carried work this problem needs, as the reference gates it:
    PodTopologySpread's and InterPodAffinity's none without constraints or
    term groups; host ports and cloud-disk counts are carried whenever a
    pending pod wants one (whatever the profile), conflict volumes and CSI
    attachments only under their filter."""
    return {
        "ports": dims["PT"] > 0,
        "restr": dims["VR"] > 0 and "VolumeRestrictions" in cfg.filters,
        "cloud": dims["CLOUD"] > 0,
        "csi": dims["VID"] > 0 and "NodeVolumeLimits" in cfg.filters,
        "spread_filter": "PodTopologySpread" in cfg.filters and dims["KC"] > 0,
        "spread_score": any(s == "PodTopologySpread" for s, _w in cfg.scores) and dims["KS"] > 0,
        "interpod": dims["G"] > 0 and (
            "InterPodAffinity" in cfg.filters or any(s == "InterPodAffinity" for s, _w in cfg.scores)
        ),
    }


def build_batch_fn(
    cfg: BatchConfig, dims: dict, ws0: "int | None" = None, window: "int | None" = None,
    weights: "torch.Tensor | None" = None,
):
    """fn(dp) → dict of result tensors: the CUDA scan kernel for a problem on
    the card, the plain version for one on the CPU.  ``ws0`` and ``weights``
    (an [S] tensor beside the problem): as ``scan_plain``'s.  With
    ``window`` (the JAX ``build_batch_fn(window=)``) it returns
    fn(carry0, dp, offset) instead, which scans pods [offset,
    offset+window) from ``carry0`` (None: the problem's own) and hands on
    ``out["final_carry"]``: windows chain with no host round trip."""
    check_slice(cfg)

    def fn(dp: DeviceProblem, carry0: "dict | None" = None, offset: int = 0) -> dict:
        kw = dict(ws0=ws0, carry0=carry0, offset=offset, window=window, weights=weights)
        if dp.alloc.device.type == "cuda":
            from kube_scheduler_simulator_tpu_torch.ops import kernels

            return kernels.scan(cfg, dims, dp, **kw)
        return scan_plain(cfg, dims, dp, **kw)

    if window is None:
        return lambda dp: fn(dp)
    return lambda carry0, dp, offset: fn(dp, carry0, offset)


def grad_plain(
    cfg: BatchConfig, dims: dict, dp: DeviceProblem, weights: torch.Tensor, F: torch.Tensor, tau: float,
) -> "tuple[torch.Tensor, dict]":
    """K2g's plain version: (d objective / d weights [S] float64, the hard
    rollout's outputs).  A re-run of the plain step that, for every
    committed pod i, with s = softmax(totals_i / tau) over the sampled
    nodes and c_i[n] = F[n,0] pod_nonzero[i,0] + F[n,1] pod_nonzero[i,1]
    (F [N,2] = d objective / d final_nonzero), adds

        dw_k += (1 / tau) sum_n s[n] (c_i[n] - sum_m s[m] c_i[m]) norm_ik[n].

    This is the gradient the JAX package takes by autodiff through the
    straight-through scan (``build_grad_fn``): the weights enter only the
    totals, every score reaches its normalized value through floor, trunc
    or round (derivative zero), selection and feasibility are comparisons,
    so no carry passes gradient into a later pod's totals, and the
    objectives read ``final_nonzero`` (or the selections, gradient zero)."""
    if F.shape != (dims["N"], 2) or F.dtype != weights.dtype:
        raise ValueError(f"F must be {weights.dtype} [{dims['N']}, 2], got {F.dtype} {tuple(F.shape)}")
    out = scan_plain(cfg._replace(relax_tau=0.0, trace=False), dims, dp, weights=weights, grad=(F, float(tau)))
    return out.pop("dw"), out


def grad_residual_plain(
    cfg: BatchConfig, dims: dict, dp: DeviceProblem, weights: torch.Tensor, tau: float,
) -> "tuple[torch.Tensor, dict]":
    """The plain version of K2g's forward: (the residual M [2, S, N]
    float64, the hard rollout's outputs).  ``grad_plain``'s sum is linear
    in F: with s_i pod i's softmax and nbar_ik = sum_n s_i[n] norm_ik[n]
    (sum s_i = 1, so the mean of c_i drops out),

        dw_k = (1 / tau) sum_{n,j} F[n,j] M[j,k,n],
        M[j,k,n] = sum over committed pods i of pnz_ij s_i[n] (norm_ik[n] - nbar_ik),

    and M does not depend on F: the rollout folds it over the pod chain,
    and the backward (``grad_contract_plain``) only contracts."""
    if tau <= 0:
        raise ValueError(f"tau must be positive, got {tau}")
    out = scan_plain(cfg._replace(relax_tau=0.0, trace=False), dims, dp, weights=weights, residual=float(tau))
    return out.pop("resid"), out


def grad_contract_plain(M: torch.Tensor, F: torch.Tensor, tau: float) -> torch.Tensor:
    """The plain version of K2g's contraction: d objective / d weights [S]
    float64 = the fixed pairwise tree sum (tuning.objective.tree_sum) over
    m = 2n + j of F[n,j] M[j,k,n] in float64, over tau; the kernel sums the
    same products in the same tree, so the two are bitwise equal."""
    from kube_scheduler_simulator_tpu_torch.tuning.objective import tree_sum

    S, N = M.shape[1], M.shape[2]
    if M.shape[0] != 2 or F.shape != (N, 2):
        raise ValueError(f"M must be [2, S, N] and F [N, 2], got {tuple(M.shape)} and {tuple(F.shape)}")
    x = F.double()[None, :, :] * M.permute(1, 2, 0)  # [S, N, 2]: F[n,j] M[j,k,n]
    v = tree_sum(x.reshape(S, 2 * N))
    return v / _den(v, tau)


# ------------------------------------------- the lane scan (K8, K9)

def check_lanes(
    cfg: BatchConfig, dims: dict, lane_active: "torch.Tensor | None", weights: "torch.Tensor | None" = None,
) -> int:
    """The lane count, or raise for what the lane scan does not take: the
    trace on, a lane mask that is not bool [G, N], a weight matrix that is
    not [G, S] (G >= 1; with both, one G)."""
    if cfg.trace:
        raise ValueError("the lane scan runs with the trace off")
    lanes = []
    if lane_active is not None:
        if lane_active.dtype != torch.bool or lane_active.dim() != 2 or lane_active.shape[1] != dims["N"]:
            raise ValueError(f"lane_active must be bool [G, {dims['N']}], got "
                             f"{lane_active.dtype} {tuple(lane_active.shape)}")
        lanes.append(lane_active.shape[0])
    if weights is not None:
        if not weights.is_floating_point() or weights.dim() != 2 or weights.shape[1] != len(cfg.scores):
            raise ValueError(f"weights must be floating [G, {len(cfg.scores)}], got "
                             f"{weights.dtype} {tuple(weights.shape)}")
        lanes.append(weights.shape[0])
    if not lanes or min(lanes) < 1 or len(set(lanes)) != 1:
        raise ValueError(f"the lane scan needs G >= 1 lanes of one count, got {lanes}")
    return lanes[0]


def scan_lanes_plain(
    cfg: BatchConfig, dims: dict, dp: DeviceProblem, lane_active: "torch.Tensor | None" = None,
    weights: "torch.Tensor | None" = None,
) -> dict:
    """The plain version of the lane scan: ``scan_plain`` once per lane g,
    with ``node_active = lane_active[g]`` (K8, the JAX package's
    ``jax.vmap`` of ``build_batch_fn`` over the node_active mask) and/or
    the weight vector ``weights[g]`` (K9, the JAX ``build_population_fn``:
    ``jax.vmap`` over the weights only), every output stacked on a leading
    lane axis, and the lanes' final carries as ``final_carry``."""
    G = check_lanes(cfg, dims, lane_active, weights)
    outs = [
        scan_plain(
            cfg, dims, dp if lane_active is None else dp._replace(node_active=lane_active[g]),
            weights=None if weights is None else weights[g],
        )
        for g in range(G)
    ]
    out = {k: torch.stack([o[k] for o in outs]) for k in outs[0] if k != "final_carry"}
    out["final_carry"] = final_carry(out, out["final_start"])
    return out


def build_lanes_fn(cfg: BatchConfig, dims: dict):
    """fn(dp, lane_active, widest=None) → dict of [G, ...] result tensors:
    the scan over the G lanes of a [G, N] node mask in one dispatch (the JAX
    package's ``jax.jit(jax.vmap(build_batch_fn(cfg, dims)))`` with only
    node_active mapped), by the lane kernel for a problem on the card (whose
    block the widest lane's active rows size, ``kernels.scan_lanes``) and
    the plain version for one on the CPU.  Trace off (each call checks it
    with the mask, ``check_lanes``), no window, no carry0, no ws0."""
    check_slice(cfg)

    def fn(dp: DeviceProblem, lane_active: torch.Tensor, widest: "int | None" = None) -> dict:
        if dp.alloc.device.type == "cuda":
            from kube_scheduler_simulator_tpu_torch.ops import kernels

            return kernels.scan_lanes(cfg, dims, dp, lane_active, widest=widest)
        return scan_lanes_plain(cfg, dims, dp, lane_active)

    return fn


# ------------------------------------------------ device-resident problem

def scatter_rows_plain(buf: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``buf[idx[k]] = rows[k]`` in place, returning ``buf``: the plain
    version of the scatter kernel (the JAX ``_scatter_rows``).  Repeated
    indices carry identical rows, so the order of the writes is moot."""
    buf[idx.long()] = rows
    return buf


def scatter_rows(buf: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The scatter kernel for a plane on the card, the plain version for one
    on the CPU."""
    if buf.device.type == "cuda":
        from kube_scheduler_simulator_tpu_torch.ops import kernels

        return kernels.scatter_rows(buf, idx, rows)
    return scatter_rows_plain(buf, idx, rows)


def placer_scatter_frac(default: float = 0.25) -> float:
    """The placer's changed-rows threshold for a scatter update, from the
    ``KSS_PLACER_SCATTER_FRAC`` environment variable (the reference's knob;
    default a quarter of the plane's rows).  An unparseable or
    out-of-range value raises."""
    import os

    raw = os.environ.get("KSS_PLACER_SCATTER_FRAC")
    if raw is None or not raw.strip():
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"KSS_PLACER_SCATTER_FRAC must be a float in (0, 1], got {raw!r}") from None
    if not 0.0 < v <= 1.0:
        raise ValueError(f"KSS_PLACER_SCATTER_FRAC must be in (0, 1], got {raw!r}")
    return v


class DevicePlacer:
    """The problem's planes resident on the device from round to round (the
    JAX package's ``DevicePlacer``, ops/batch.py:648-873).

    ``place`` takes a round's host problem (``lower_host``) and routes each
    plane, against the previous round's plane under the same shape key:

    - byte-identical           → reuse the resident tensor (0 bytes up);
    - at most ``scatter_max_frac`` of its rows changed → ship the changed
      rows and their indices and write them in place with the scatter
      kernel (``scatter_rows``; K padded to a bucket by repeating the first
      index with its own row);
    - otherwise, or a new shape → full upload.

    Full uploads and the scatter rows and indices of a round travel in ONE
    host-to-device copy (``upload``): a fresh buffer, so a plane the kernel
    updates in place never aliases a buffer a later upload rewrites.
    CARRY0_FIELDS are never kept: a windowed round chains its carry on the
    device, and the chain owns it.

    Counters as the reference's: ``bytes_uploaded`` (full planes, carries,
    scatter rows and indices), ``plane_reuses``, ``scatter_updates``,
    ``full_uploads``; and the last round's decision per plane,
    ``decisions[(field, sub)] = ("reuse" | "scatter" | "full" | "carry",
    bytes uploaded)``.  The reference's plane banks (two resident sets a
    shape key, which its streamed waves alternate because XLA donates
    buffers an in-flight kernel still reads) are left out: the port
    launches and copies on the one current CUDA stream, so a streamed wave
    k+1's row scatter is ordered after wave k's scan and compaction on the
    card, and one set a shape key suffices."""

    def __init__(self, max_keys: int = 2, scatter_max_frac: "float | None" = None):
        self.max_keys = max_keys
        self.scatter_max_frac = placer_scatter_frac() if scatter_max_frac is None else scatter_max_frac
        self.bytes_uploaded = 0
        self.plane_reuses = 0
        self.scatter_updates = 0
        self.full_uploads = 0
        self.decisions: dict = {}
        # key → {(field, sub): (host ndarray, device tensor)}
        self._cache: dict = {}
        self._order: list = []

    def _entry(self, key) -> dict:
        """The resident plane dict for ``key``, kept for the last
        ``max_keys`` shape keys."""
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = {}
            self._order.append(key)
            while len(self._order) > self.max_keys:
                self._cache.pop(self._order.pop(0), None)
        else:
            self._order.remove(key)
            self._order.append(key)
        return entry

    def place(self, host: "dict[str, Any]", key, device: torch.device) -> DeviceProblem:
        """Place a host problem on ``device``, reusing or row-updating the
        resident planes of ``key``."""
        entry = self._entry(key)
        leaves = problem_leaves(host)
        placed: dict = {}
        uploads: dict = {}
        scatters: list = []
        decisions: dict = {}
        for path, val in leaves.items():
            if path[0] in CARRY0_FIELDS or val.ndim == 0:
                uploads[path] = val
                decisions[path] = ("carry", val.nbytes if val.ndim else 0)
                continue
            cached = entry.get(path)
            if cached is not None:
                host_old, dev_old = cached
                if host_old.shape == val.shape and host_old.dtype == val.dtype:
                    if val.size == 0:
                        placed[path] = dev_old
                        decisions[path] = ("reuse", 0)
                        continue
                    diff = val != host_old
                    if val.ndim > 1:
                        diff = diff.reshape(val.shape[0], -1).any(axis=1)
                    changed = np.nonzero(diff)[0]
                    if changed.size == 0:
                        placed[path] = dev_old
                        decisions[path] = ("reuse", 0)
                        continue
                    if changed.size <= max(1, int(val.shape[0] * self.scatter_max_frac)):
                        idx = changed.astype(np.int32)
                        rows = np.ascontiguousarray(val[changed])
                        # pad K to a bucket with repeats of the first row
                        k = min(_bucket(len(idx)), val.shape[0])
                        if k > len(idx):
                            pad = k - len(idx)
                            idx = np.concatenate([idx, np.full(pad, idx[0], dtype=idx.dtype)])
                            rows = np.concatenate([rows, np.repeat(rows[:1], pad, axis=0)])
                        uploads[("idx",) + path] = idx
                        uploads[("rows",) + path] = rows
                        scatters.append((path, dev_old))
                        decisions[path] = ("scatter", idx.nbytes + rows.nbytes)
                        continue
            uploads[path] = val
            decisions[path] = ("full", val.nbytes)
        shipped = upload(uploads, device)
        for path, dev_old in scatters:
            placed[path] = scatter_rows(dev_old, shipped.pop(("idx",) + path), shipped.pop(("rows",) + path))
        placed.update(shipped)
        kinds = [kind for kind, _n in decisions.values()]
        self.plane_reuses += kinds.count("reuse")
        self.scatter_updates += len(scatters)
        self.full_uploads += kinds.count("full")
        self.bytes_uploaded += sum(n for _kind, n in decisions.values())
        self.decisions = decisions
        # lower_host allocates fresh host arrays every round: keeping them is safe
        for path, val in leaves.items():
            if path[0] not in CARRY0_FIELDS and val.ndim:
                entry[path] = (val, placed[path])
        return assemble(host, placed)

    @property
    def last_scattered(self) -> "list[str]":
        """The fields whose planes the last round row-updated."""
        return sorted({path[0] for path, (kind, _n) in self.decisions.items() if kind == "scatter"})


# ------------------------------------------------------- trace compaction

def compact_manifest(cfg: BatchConfig, P: int, W: int, WS: int, raw_dtypes, code_max: int):
    """The blob's (name, dtype, shape) planes in order."""
    mode = fail_pack_mode(code_max, len(cfg.filters))
    plan = trace_fetch_plan(cfg, raw_dtypes)
    manifest: "list[tuple[str, str, tuple]]" = []
    if cfg.filters:
        if mode == 0:
            manifest.append(("fail8", "uint8", (P, W)))
        elif mode == 1:
            manifest.append(("fail", "uint16", (P, W)))
        else:
            manifest.append(("fail_plug", "int8", (P, W)))
            manifest.append(("fail_code", "int16" if mode == 2 else "int32", (P, W)))
    else:
        manifest.append(("sids", "int32", (P, WS)))
    for k, (_s, _w) in enumerate(cfg.scores):
        fetch_raw, fetch_norm, _host = plan[k]
        if fetch_raw:
            manifest.append((f"raw:{k}", raw_dtypes[k], (P, WS)))
        if fetch_norm:
            manifest.append((f"norm:{k}", "int8", (P, WS)))
    return manifest


def _plane_bytes(x: torch.Tensor, dt: str) -> torch.Tensor:
    """Integer-valued plane → its little-endian bytes in dtype ``dt``."""
    if dt == "uint16":  # low two bytes of the int32 value
        b = x.to(torch.int32).contiguous().view(torch.uint8).reshape(*x.shape, 4)
        return b[..., :2].reshape(-1)
    t = {"uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16, "int32": torch.int32}[dt]
    return x.to(t).contiguous().view(torch.uint8).reshape(-1)


def compact_plain(
    cfg: BatchConfig, dims: dict, W: int, WS: int, manifest, out: dict, n_true: int,
    in_step_ws0: "int | None" = None,
) -> torch.Tensor:
    """Reduce the [P,N] trace planes to what the annotation writer reads,
    as one uint8 blob in ``manifest`` order — op for op the JAX
    ``build_compact_fn`` (visited window, stable partition, first-failure
    gather and pack, score planes at their fetch dtype).  With
    ``in_step_ws0`` the score planes arrive compacted by the scan ([P,
    in_step_ws0], ascending node id): they are cut to WS and masked by
    position against ``feasible_count``."""
    P, N = dims["P"], dims["N"]
    dev = out["sample_start"].device
    i32 = torch.int32
    idx = torch.arange(N, dtype=i32, device=dev)[None, :]
    d = idx - out["sample_start"][:, None]
    rank = torch.where(d >= 0, d, d + n_true)
    # padded node columns can alias into the rank window when the
    # rotation start is nonzero — they were never really visited
    visited = (rank < out["sample_processed"][:, None]) & (idx < n_true)

    def partition_ids(mask, Wd):
        """ids of True entries per row, ascending, padded to width Wd."""
        pos = torch.cumsum(mask.to(i32), 1, dtype=i32) - 1
        dest = torch.where(mask & (pos < Wd), pos, Wd)
        ids = torch.zeros((P, Wd + 1), dtype=i32, device=dev)
        ids.scatter_(1, dest.long(), idx.expand(P, N).contiguous())
        cnt = torch.clamp(pos[:, -1] + 1, max=Wd)
        valid = torch.arange(Wd, dtype=i32, device=dev)[None, :] < cnt[:, None]
        return ids[:, :Wd], valid

    res: dict = {}
    names = {name for name, _dt, _shape in manifest}
    if cfg.filters:
        order, valid = partition_ids(visited, W)
        take = lambda a: torch.gather(a, 1, order.long())
        plug = torch.where(valid, take(out["fail_plug"]).to(i32), -1)
        code = torch.where(valid, take(out["fail_code"]).to(i32), 0)
        if "fail8" in names:
            res["fail8"] = ((plug + 1) << 4) | code
        elif "fail" in names:
            res["fail"] = ((plug + 1) << 8) | code
        else:
            res["fail_plug"] = plug
            res["fail_code"] = code
    if in_step_ws0 is not None:
        if not cfg.filters:
            raise ValueError("the in-step compaction needs filters: without them the blob carries feasible ids")
        svalid = torch.arange(WS, dtype=i32, device=dev)[None, :] < out["feasible_count"][:, None]
        stake = lambda a: a[:, :WS]
    else:
        sorder, svalid = partition_ids(out["feasible"], WS)
        if not cfg.filters:
            res["sids"] = torch.where(svalid, sorder, -1)
        stake = lambda a: torch.gather(a, 1, sorder.long())

    def stakem(a):
        g = stake(a)
        return torch.where(svalid, g, torch.zeros_like(g))

    for k, (s, _w) in enumerate(cfg.scores):
        if f"raw:{k}" in names:
            res[f"raw:{k}"] = stakem(out[f"raw:{s}"])
        if f"norm:{k}" in names:
            res[f"norm:{k}"] = stakem(out[f"norm:{s}"])
    return torch.cat([_plane_bytes(res[name], dt) for name, dt, _shape in manifest])


def build_compact_fn(
    cfg: BatchConfig, dims: dict, W: int, WS: int, raw_dtypes=None, code_max: int = 1 << 30,
    in_step_ws0: "int | None" = None,
):
    """(fn(out, n_true) → uint8 blob, manifest): the CUDA compaction kernel
    for planes on the card, the plain version for planes on the CPU.
    ``in_step_ws0``: the scan compacted the score planes to that width."""
    raw_dtypes = tuple(raw_dtypes or ("int32",) * len(cfg.scores))
    manifest = compact_manifest(cfg, dims["P"], W, WS, raw_dtypes, code_max)

    def fn(out: dict, n_true: int) -> torch.Tensor:
        if out["sample_start"].device.type == "cuda":
            from kube_scheduler_simulator_tpu_torch.ops import kernels

            return kernels.compact(cfg, dims, W, WS, manifest, out, n_true, in_step_ws0)
        return compact_plain(cfg, dims, W, WS, manifest, out, n_true, in_step_ws0)

    return fn, manifest


# --------------------------------------------------- host reconstruction

def unpack_compact_blob(blob: np.ndarray, manifest: "list[tuple[str, str, tuple]]") -> dict:
    """Slice the single fetched uint8 blob back into named planes (host
    views, no copies beyond the one D2H transfer)."""
    out: dict = {}
    off = 0
    for name, dt, shape in manifest:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        out[name] = blob[off : off + n].view(dt).reshape(shape)
        off += n
    if "fail8" in out:
        packed = out.pop("fail8")
        out["fail_plug"] = ((packed >> 4).astype(np.int16) - 1).astype(np.int8)
        out["fail_code"] = (packed & 0xF).astype(np.uint8)
    elif "fail" in out:
        packed = out.pop("fail")
        out["fail_plug"] = ((packed >> 8).astype(np.int16) - 1).astype(np.int8)
        out["fail_code"] = (packed & 0xFF).astype(np.uint8)
    return out


def _host_default_normalize(raw: np.ndarray, valid: np.ndarray, reverse: bool) -> np.ndarray:
    """helper.DefaultNormalizeScore recomputed on host over the compacted
    feasible window — integer arithmetic, equal to the kernel's float
    path for the int8/int16 raws the fetch plan routes here."""
    r = np.where(valid, raw, 0).astype(np.int64)
    mx = r.max(axis=1)
    q = (r * int(MAX_NODE_SCORE)) // np.maximum(mx, 1)[:, None]
    out = int(MAX_NODE_SCORE) - q if reverse else q
    out = np.where(mx[:, None] == 0, int(MAX_NODE_SCORE) if reverse else 0, out)
    return np.where(valid, out, 0).astype(np.int8)


def _host_minmax_normalize(raw: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """InterPodAffinity's MAX*(v-min)/(max-min) on host (see above)."""
    r = raw.astype(np.int64)
    big = np.int64(1) << 40
    mn = np.where(valid, r, big).min(axis=1)
    mx = np.where(valid, r, -big).max(axis=1)
    diff = mx - mn
    q = ((r - mn[:, None]) * int(MAX_NODE_SCORE)) // np.maximum(diff, 1)[:, None]
    out = np.where(diff[:, None] > 0, q, 0)
    return np.where(valid, out, 0).astype(np.int8)


def reconstruct_trace(
    cfg: BatchConfig,
    fetched: "dict[str, np.ndarray]",
    sample_start: np.ndarray,
    sample_processed: np.ndarray,
    n_true: int,
    feasible_count: np.ndarray,
    raw_dtypes: "tuple[str, ...]",
    p_true: int,
    WS: int,
) -> dict:
    """Expand the minimal fetch back to the trace interface the annotation
    writer reads (sids [P,WS] int32, raw [S,P,WS] int32, norm [S,P,WS]
    int8, fail planes) — all host-side numpy.

    Rows ≥ ``p_true`` are shape padding (pod_active=False in the kernel):
    their planes are left empty — no consumer reads them."""
    P = len(sample_start)
    fp = fetched.get("fail_plug")
    out: dict = {}
    if fp is not None:
        out["fail_plug"] = fp
        out["fail_code"] = fetched["fail_code"]
        W = fp.shape[1]
        r = np.arange(W, dtype=np.int32)[None, :]
        proc = np.minimum(sample_processed.astype(np.int32), n_true)[:, None]
        ids = (sample_start.astype(np.int32)[:, None] + r) % max(n_true, 1)
        # ascending-id column order (invalid columns pushed past the end),
        # matching the compact planes' partition
        ids = np.sort(np.where(r < proc, ids, n_true + r), axis=1)
        in_window = r < proc
        in_window[p_true:] = False
        feas = in_window & (fp < 0)
        pos = np.cumsum(feas, axis=1) - 1
        take = feas & (pos < WS)
        sids = np.full((P, WS), -1, dtype=np.int32)
        rows = np.broadcast_to(np.arange(P)[:, None], (P, W))
        sids[rows[take], pos[take]] = ids[take].astype(np.int32)
        counts = feas.sum(axis=1)
        if not np.array_equal(counts[:p_true], feasible_count[:p_true]):
            raise RuntimeError(
                "derived feasible ids disagree with the kernel's feasible counts"
            )
        out["sids"] = sids
        # the sorted visit-id matrix: per-pod annotation writers read
        # their visited windows from it (first `processed` columns)
        out["visit_ids"] = ids.astype(np.int64, copy=False)
    else:
        out["sids"] = fetched["sids"]
    if cfg.scores:
        valid = out["sids"] >= 0
        S = len(cfg.scores)
        raw = np.zeros((S, P, WS), dtype=np.int32)
        norm = np.zeros((S, P, WS), dtype=np.int8)
        plan = trace_fetch_plan(cfg, raw_dtypes)
        for k in range(S):
            fetch_raw, fetch_norm, host = plan[k]
            if fetch_raw:
                raw[k] = fetched[f"raw:{k}"]
            if fetch_norm:
                norm[k] = fetched[f"norm:{k}"]
                if not fetch_raw:
                    raw[k] = norm[k]  # identity-normalized plugin
            elif host == "default":
                norm[k] = _host_default_normalize(raw[k], valid, reverse=False)
            elif host == "default_reverse":
                norm[k] = _host_default_normalize(raw[k], valid, reverse=True)
            elif host == "minmax":
                norm[k] = _host_minmax_normalize(raw[k], valid)
        out["raw"] = raw
        out["norm"] = norm
    return out
