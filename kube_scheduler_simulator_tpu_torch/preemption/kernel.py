"""The batched victim search (K5): DefaultPreemption's selectVictimsOnNode
for every (unschedulable pod u, node n) lane at once.

Port of the JAX package's ``preemption/kernel.py`` (``build_preempt_fn``,
a jitted vmap(U) × vmap(N) with a ``fori_loop`` over the V victim slots).
Per lane, mirroring the oracle (plugins/intree/queue_bind.DefaultPreemption
._select_victims_on_node):

1. ``lower``  — slots with priority strictly below u's;
2. remove ALL of them, require u to fit (resource compares over the columns
   u requests, plus the "Too many pods" count);
3. classify each lower pod as PDB-violating by consuming the shared
   per-PDB budget in slot (MoreImportantPod) order;
4. greedy reprieve: violating group first, then non-violating, each in
   slot order — re-add a pod iff u still fits afterwards; the pods that
   stay out are the victims.

Two implementations: ``preempt_plain`` (PyTorch, vectorised over (U, N),
a Python loop over V), which serves CPU tensors, and the hand-written CUDA
kernel ``csrc/preempt.cu`` behind ``ops/kernels.preempt``, which serves
CUDA tensors; ``search`` picks one by the tensors' device and never falls
back.  Candidate ranking (pickOneNodeForPreemption) stays on the host in
exact int64 (preemption/engine.py).

Exactness: every resource column is GCD-scaled, so the floats hold
integers; sums in any order are exact while every value and partial sum
stays below 2**24 (float32) or 2**53 (float64).  ``run_search`` checks a
bound on every magnitude the search forms before it dispatches and raises
``ValueError`` when the dtype cannot hold it; the problem's part of that
bound is computed once, with its device tables.

The three masks come out of one buffer (``mask_layout``, ``mask_views``).
A dispatch on the card stages its per-dispatch inputs in one pinned host
buffer (one copy in), and fetches the masks' buffer into pinned memory
(one copy out).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.device import resolve_device, resolve_dtype

# the reference PreemptionProblem's numpy fields, carried across by
# ``problem_from_fields``
PROBLEM_FIELDS = (
    "node_names", "resource_names", "alloc", "base_req", "base_cnt", "max_pods", "vreq", "vprio",
    "vstart", "vvalid", "vmatch", "allowed", "victim_pods", "res_idx", "V", "PDB",
)
EXACT_LIMIT = {torch.float32: 1 << 24, torch.float64: 1 << 53}
_ALIGN = 16  # byte alignment of each array in a staged or output buffer


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def mask_layout(U: int, N: int, V: int) -> "tuple[int, tuple[int, int, int]]":
    """(bytes, (cand, victims, viol) byte offsets) of the search's one output
    buffer: cand [U,N], victims [U,N,V] and viol [U,N,V], one byte a flag,
    each at a 16-byte boundary."""
    off_v = _up(U * N)
    off_o = off_v + _up(U * N * V)
    return off_o + _up(U * N * V), (0, off_v, off_o)


def mask_views(buf, U: int, N: int, V: int) -> tuple:
    """(cand [U,N], victims [U,N,V], viol [U,N,V]) bool views of a
    ``mask_layout`` buffer: a uint8 tensor (any device) or numpy array."""
    _n, (oc, ov, oo) = mask_layout(U, N, V)
    if isinstance(buf, torch.Tensor):
        cut = lambda o, n, shape: buf[o : o + n].view(torch.bool).reshape(shape)  # noqa: E731
    else:
        cut = lambda o, n, shape: buf[o : o + n].view(bool).reshape(shape)  # noqa: E731
    return cut(oc, U * N, (U, N)), cut(ov, U * N * V, (U, N, V)), cut(oo, U * N * V, (U, N, V))


def preempt_plain(
    ucand, ureq, uprio, smask, sreq, snode, alloc, base_req, extra_req, base_cnt, extra_cnt, max_pods,
    vreq, vprio, vvalid, vmatch, allowed,
):
    """The victim search in PyTorch, the reference's order of operations.

    ucand [U,N] bool; ureq [U,R] float; uprio [U] int64; smask [U,S] bool,
    sreq [S,R] float, snode [S] int32 (same-window successes earlier in the
    queue); alloc, base_req, extra_req [N,R] float; base_cnt, extra_cnt,
    max_pods [N] float; vreq [N,V,R] float; vprio [N,V] int64; vvalid [N,V]
    bool; vmatch [N,V,PDB] bool; allowed [PDB] int32.  Returns (cand [U,N],
    victims [U,N,V], viol [U,N,V]) bool; ``viol`` is not masked by ``cand``."""
    U, N = ucand.shape
    V = vprio.shape[1]
    R = alloc.shape[1]
    S = snode.shape[0]
    dt = alloc.dtype
    dev = alloc.device
    usage = (base_req + extra_req).unsqueeze(0).expand(U, N, R)
    cnt = (base_cnt + extra_cnt).unsqueeze(0).expand(U, N)
    if S:
        # same-window commits scattered into each pod's usage
        src = sreq.unsqueeze(0) * smask.unsqueeze(-1).to(dt)  # [U,S,R]
        usage = usage + torch.zeros((U, N, R), dtype=dt, device=dev).index_add_(1, snode.long(), src)
        cnt = cnt + torch.zeros((U, N), dtype=dt, device=dev).index_add_(1, snode.long(), smask.to(dt))
    lower = vvalid.unsqueeze(0) & (vprio.unsqueeze(0) < uprio.view(U, 1, 1))  # [U,N,V]
    n_lower = lower.sum(dim=-1).to(dt)
    zero = torch.zeros((), dtype=dt, device=dev)
    freed = torch.where(lower.unsqueeze(-1), vreq.unsqueeze(0), zero).sum(dim=2)  # [U,N,R]
    free0 = alloc.unsqueeze(0) - (usage - freed)
    want = ureq.view(U, 1, R)
    # want==0 columns are skipped by the oracle's Fit loop
    fits0 = ((want <= free0) | (want <= 0)).all(dim=-1)
    fits0 = fits0 & (cnt - n_lower + 1.0 <= max_pods.unsqueeze(0))
    cand0 = ucand & fits0 & (n_lower >= 1)

    if vmatch.shape[-1]:
        # budget rank in slot order over ALL lower pods: the s-th matching
        # lower pod violates once the running count exceeds the budget
        m = vmatch.unsqueeze(0) & lower.unsqueeze(-1)  # [U,N,V,PDB]
        cum = torch.cumsum(m.to(torch.int32), dim=2, dtype=torch.int32)
        viol = (vmatch.unsqueeze(0) & (cum > allowed.view(1, 1, 1, -1))).any(dim=-1) & lower
    else:
        viol = torch.zeros((U, N, V), dtype=torch.bool, device=dev)

    # reprieve order: violating first, each group in slot order (unique keys)
    key = torch.where(viol, 0, V) + torch.arange(V, device=dev, dtype=torch.int64)
    order = torch.argsort(key, dim=-1)
    vreq_ord = torch.gather(vreq.unsqueeze(0).expand(U, N, V, R), 2, order.unsqueeze(-1).expand(U, N, V, R))
    lower_ord = torch.gather(lower, 2, order)
    readd = torch.zeros((U, N, R), dtype=dt, device=dev)
    readd_cnt = torch.zeros((U, N), dtype=dt, device=dev)
    victims_ord = torch.zeros((U, N, V), dtype=torch.bool, device=dev)
    maxp = max_pods.unsqueeze(0)
    for t in range(V):
        active = lower_ord[..., t]
        new = readd + vreq_ord[..., t, :]
        ok = ((want <= free0 - new) | (want <= 0)).all(dim=-1) & (cnt - n_lower + readd_cnt + 2.0 <= maxp)
        rep = active & ok
        readd = torch.where(rep.unsqueeze(-1), new, readd)
        readd_cnt = readd_cnt + rep.to(dt)
        victims_ord[..., t] = active & ~ok
    victims = torch.zeros_like(victims_ord).scatter_(2, order, victims_ord)
    cand = cand0 & victims.any(dim=-1)
    return cand, victims & cand.unsqueeze(-1), viol


def search(*args):
    """The victim search on the tensors' device: the CUDA kernel for CUDA
    tensors (a build or launch failure propagates), the plain version for
    CPU tensors."""
    if args[0].is_cuda:
        from kube_scheduler_simulator_tpu_torch.ops import kernels as K

        return K.preempt(*args)
    return preempt_plain(*args)


def problem_from_fields(src: Any):
    """A port ``PreemptionProblem`` holding the numpy fields of any object
    that carries them under the reference's names (the JAX package's
    encoded problem): the state carried across, so one encoded problem
    feeds both packages."""
    from kube_scheduler_simulator_tpu_torch.preemption.encode import PreemptionProblem

    pr = PreemptionProblem(list(src.node_names), list(src.resource_names))
    for f in PROBLEM_FIELDS[2:]:
        v = getattr(src, f)
        setattr(pr, f, np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
    return pr


def device_tables(pr, device: torch.device, dtype: torch.dtype) -> dict:
    """The node-axis tables of ``pr`` on ``device`` in the search's dtypes,
    uploaded at the first call for that (device, dtype) and kept on the
    problem (on the card in one pinned copy), with the problem's part of
    the exactness bound: ``mag`` [R],
    each column's allocatable, base usage and twice its victims' summed
    requests (freed, then re-added), at their maxima over nodes;
    ``cnt_mag``, the pod count's (base count, twice V, 2); ``pods_mag``,
    max_pods'."""
    key = (str(device), dtype)
    if pr._device is not None and pr._device[0] == key:
        return pr._device[1]
    npdt = np.dtype(str(dtype).split(".")[-1])
    kinds = (("alloc", npdt), ("base_req", npdt), ("base_cnt", npdt), ("max_pods", npdt), ("vreq", npdt),
             ("vprio", np.int64), ("vvalid", bool), ("vmatch", bool), ("allowed", np.int32))
    arrays = [np.ascontiguousarray(getattr(pr, f), dtype=dt) for f, dt in kinds]
    # on the card in one pinned copy, as a dispatch's inputs
    staged = _stage(arrays, device) if device.type == "cuda" else [torch.from_numpy(a) for a in arrays]
    tables = dict(zip((f for f, _dt in kinds), staged))
    vsum = pr.vreq.sum(axis=1) if pr.V else np.zeros_like(pr.alloc)
    tables["mag"] = _colmax(pr.alloc) + _colmax(pr.base_req) + 2 * _colmax(vsum)
    tables["cnt_mag"] = int(np.abs(pr.base_cnt).max(initial=0)) + 2 * pr.V + 2
    tables["pods_mag"] = int(np.abs(pr.max_pods).max(initial=0))
    pr._device = (key, tables)
    return tables


def _colmax(a: np.ndarray) -> np.ndarray:
    return np.abs(a).max(axis=0, initial=0)


def _stage(arrays: list, device: torch.device) -> list:
    """Numpy ``arrays`` on ``device`` (a problem's tables, a dispatch's
    inputs): packed at 16-byte boundaries into one pinned host buffer, one
    copy in, and cut into views of their dtypes and shapes there."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += _up(a.nbytes)
    host = torch.empty(max(total, _ALIGN), dtype=torch.uint8, device="cpu", pin_memory=True)
    hn = host.numpy()
    for a, o in zip(arrays, offs):
        hn[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True)
    return [
        buf[o : o + a.nbytes].view(getattr(torch, a.dtype.name)).reshape(a.shape) for a, o in zip(arrays, offs)
    ]


def shard_problem(pr, lo: int, hi: int):
    """The node range [lo, hi) of a PreemptionProblem: its node-axis tables
    narrowed (victims and PDB budgets whole), kept on ``pr`` by range so its
    device tables upload once a round."""
    cache = pr._shards
    sub = cache.get((lo, hi))
    if sub is None:
        from kube_scheduler_simulator_tpu_torch.preemption.encode import PreemptionProblem

        sub = PreemptionProblem(list(pr.node_names[lo:hi]), list(pr.resource_names))
        for f in PROBLEM_FIELDS[2:]:
            v = getattr(pr, f)
            node_axis = f in ("alloc", "base_req", "base_cnt", "max_pods", "vreq", "vprio", "vstart", "vvalid",
                              "vmatch", "victim_pods")
            setattr(sub, f, v[lo:hi] if node_axis else v)
        cache[(lo, hi)] = sub
    return sub


def shard_search_args(pr, ucand, smask, sreq, snode, usage, cnt, mesh) -> "list[dict]":
    """The victim search's arguments split over a node mesh (the reference's
    ``shard_search_args``): each shard takes the node range ceil(N / n)
    wide (the last ones shorter or empty), its columns of ``ucand`` and
    rows of the usage, and the same-window successes whose node falls in
    its range, re-indexed to it (with their ``smask`` columns and ``sreq``
    rows); the per-pod vectors are every shard's.  The search has no
    cross-node term, so the shards' masks concatenated in node order are
    the whole axis's."""
    U, N = ucand.shape
    n = len(mesh.devices)
    Ns = -(-N // n)
    snode = np.asarray(snode, dtype=np.int32)
    parts = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = min(s * Ns, N), min((s + 1) * Ns, N)
        keep = (snode >= lo) & (snode < hi)
        parts.append(dict(
            lo=lo, hi=hi, device=torch.device(dev), pr=shard_problem(pr, lo, hi), ucand=ucand[:, lo:hi],
            smask=np.asarray(smask, dtype=bool).reshape(U, len(snode))[:, keep], sreq=np.asarray(sreq)[keep],
            snode=snode[keep] - lo, usage=None if usage is None else np.asarray(usage)[lo:hi],
            cnt=None if cnt is None else np.asarray(cnt)[lo:hi],
        ))
    return parts


def run_search(
    pr, ucand, ureq, uprio, smask, sreq, snode, *, usage=None, cnt=None,
    device: "str | torch.device | None" = None, dtype: "torch.dtype | None" = None, split: "dict | None" = None,
    mesh: Any = None,
) -> dict:
    """Dispatch the search for U pods over ``pr``'s N nodes and V slots.

    ``usage`` [N,R] / ``cnt`` [N] (int64): usage committed earlier in the
    round on top of ``pr.base_req`` / ``pr.base_cnt`` (None: none).
    ``device``: the card unless the caller passes "cpu"; ``dtype``: float32
    on the card, float64 on the CPU.  Returns numpy masks ``cand`` [U,N],
    ``victims`` and ``viol`` [U,N,V] at the true dims (no padding: the
    kernel takes runtime shapes), on the card views of one buffer.
    ``split``: a dict that gets the dispatch's stages on the card,
    ``stage_s`` (the host's packing), ``in_ms``, ``kernel_ms`` and
    ``fetch_ms`` (CUDA events around the copy in, the launch and the copy
    out) and ``wall_s``.  ``mesh``: a node mesh (ops/mesh.py): one search
    a shard over its node range (``shard_search_args``), on the shard's
    device, the masks concatenated in node order."""
    if mesh is not None:
        ucand = np.asarray(ucand, dtype=bool)
        outs = [
            run_search(a["pr"], a["ucand"], ureq, uprio, a["smask"], a["sreq"], a["snode"], usage=a["usage"],
                       cnt=a["cnt"], device=a["device"], dtype=dtype)
            for a in shard_search_args(pr, ucand, smask, sreq, snode, usage, cnt, mesh)
            if a["hi"] > a["lo"]  # a shard past the last node has no columns
        ]
        return {k: np.concatenate([o[k] for o in outs], axis=1) for k in ("cand", "victims", "viol")}
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    ucand = np.asarray(ucand, dtype=bool)
    U, N = ucand.shape
    R = len(pr.resource_names)
    S = len(snode)
    t0 = time.perf_counter()
    tables = device_tables(pr, dev, dt)
    extra_req = np.zeros((N, R), dtype=np.int64) if usage is None else np.asarray(usage, dtype=np.int64)
    extra_cnt = np.zeros(N, dtype=np.int64) if cnt is None else np.asarray(cnt, dtype=np.int64)
    ureq = np.asarray(ureq, dtype=np.int64).reshape(U, R)
    sreq = np.asarray(sreq, dtype=np.int64).reshape(S, R)
    # the largest magnitude any value or partial sum of a column can reach:
    # allocatable, usage with every extra, every victim's request summed
    # twice (freed, then re-added), and the pod's want; the problem's part
    # comes with its tables
    mag = tables["mag"] + _colmax(extra_req) + np.abs(sreq).sum(axis=0) + _colmax(ureq)
    cnt_mag = tables["cnt_mag"] + int(np.abs(extra_cnt).max(initial=0)) + S
    worst = max(int(mag.max(initial=0)), cnt_mag, tables["pods_mag"])
    if worst >= EXACT_LIMIT[dt]:
        raise ValueError(
            f"victim search values reach {worst}, beyond exact integers in {dt} ({EXACT_LIMIT[dt]})"
        )
    V = pr.V
    npdt = np.dtype(str(dt).split(".")[-1])
    inputs = [
        ucand, ureq.astype(npdt), np.asarray(uprio, dtype=np.int64), np.asarray(smask, dtype=bool).reshape(U, S),
        sreq.astype(npdt), np.asarray(snode, dtype=np.int32), extra_req.astype(npdt), extra_cnt.astype(npdt),
    ]
    if dev.type != "cuda":
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in inputs]
        cand, victims, viol = (m.numpy() for m in search(*_search_args(t, tables)))
        return {"cand": cand, "victims": victims, "viol": viol}
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    nbytes, _offs = mask_layout(U, N, V)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if split is not None else None
    if ev:
        ev[0].record()
    t = _stage(inputs, dev)
    t1 = time.perf_counter()
    if ev:
        ev[1].record()
    out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    K.preempt(*_search_args(t, tables), out=out)
    if ev:
        ev[2].record()
    host = torch.empty(nbytes, dtype=torch.uint8, device="cpu", pin_memory=True)
    host.copy_(out, non_blocking=True)
    if ev:
        ev[3].record()
    torch.cuda.current_stream(dev).synchronize()
    if ev:
        split.update(stage_s=t1 - t0, in_ms=ev[0].elapsed_time(ev[1]), kernel_ms=ev[1].elapsed_time(ev[2]),
                     fetch_ms=ev[2].elapsed_time(ev[3]), wall_s=time.perf_counter() - t0)
    cand, victims, viol = mask_views(host.numpy(), U, N, V)
    return {"cand": cand, "victims": victims, "viol": viol}


def _search_args(t: list, tables: dict) -> tuple:
    """The search's 17 arguments in order from the staged per-dispatch
    tensors (``run_search``'s ``inputs``) and the problem's tables."""
    ucand, ureq, uprio, smask, sreq, snode, extra_req, extra_cnt = t
    return (
        ucand, ureq, uprio, smask, sreq, snode, tables["alloc"], tables["base_req"], extra_req, tables["base_cnt"],
        extra_cnt, tables["max_pods"], tables["vreq"], tables["vprio"], tables["vvalid"], tables["vmatch"],
        tables["allowed"],
    )
