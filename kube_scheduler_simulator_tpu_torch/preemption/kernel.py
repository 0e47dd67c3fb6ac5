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
``ValueError`` when the dtype cannot hold it.
"""

from __future__ import annotations

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
    problem."""
    key = (str(device), dtype)
    if pr._device is not None and pr._device[0] == key:
        return pr._device[1]
    floats = {f: getattr(pr, f).astype(np.float64) for f in ("alloc", "base_req", "base_cnt", "max_pods", "vreq")}
    tables = {f: torch.from_numpy(a).to(device=device, dtype=dtype) for f, a in floats.items()}
    for f, dt in (("vprio", np.int64), ("vvalid", bool), ("vmatch", bool), ("allowed", np.int32)):
        tables[f] = torch.from_numpy(np.ascontiguousarray(getattr(pr, f), dtype=dt)).to(device)
    pr._device = (key, tables)
    return tables


def run_search(
    pr, ucand, ureq, uprio, smask, sreq, snode, *, usage=None, cnt=None,
    device: "str | torch.device | None" = None, dtype: "torch.dtype | None" = None,
) -> dict:
    """Dispatch the search for U pods over ``pr``'s N nodes and V slots.

    ``usage`` [N,R] / ``cnt`` [N] (int64): usage committed earlier in the
    round on top of ``pr.base_req`` / ``pr.base_cnt`` (None: none).
    ``device``: the card unless the caller passes "cpu"; ``dtype``: float32
    on the card, float64 on the CPU.  Returns numpy masks ``cand`` [U,N],
    ``victims`` and ``viol`` [U,N,V] at the true dims (no padding: the
    kernel takes runtime shapes)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    ucand = np.asarray(ucand, dtype=bool)
    U, N = ucand.shape
    R = len(pr.resource_names)
    S = len(snode)
    tables = device_tables(pr, dev, dt)
    extra_req = np.zeros((N, R), dtype=np.int64) if usage is None else np.asarray(usage, dtype=np.int64)
    extra_cnt = np.zeros(N, dtype=np.int64) if cnt is None else np.asarray(cnt, dtype=np.int64)
    ureq = np.asarray(ureq, dtype=np.int64).reshape(U, R)
    sreq = np.asarray(sreq, dtype=np.int64).reshape(S, R)
    # the largest magnitude any value or partial sum of a column can reach:
    # allocatable, usage with every extra, every victim's request summed
    # twice (freed, then re-added), and the pod's want
    vsum = pr.vreq.sum(axis=1) if pr.V else np.zeros_like(pr.alloc)
    colmax = lambda a: np.abs(a).max(axis=0, initial=0)  # noqa: E731
    mag = colmax(pr.alloc) + colmax(pr.base_req) + colmax(extra_req) + np.abs(sreq).sum(axis=0)
    mag = mag + 2 * colmax(vsum) + colmax(ureq)
    cnt_mag = int(np.abs(pr.base_cnt).max(initial=0) + np.abs(extra_cnt).max(initial=0)) + S + 2 * pr.V + 2
    worst = max(int(mag.max(initial=0)), cnt_mag, int(np.abs(pr.max_pods).max(initial=0)))
    if worst >= EXACT_LIMIT[dt]:
        raise ValueError(
            f"victim search values reach {worst}, beyond exact integers in {dt} ({EXACT_LIMIT[dt]})"
        )

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    args = (
        up(ucand), up(ureq, dt), up(np.asarray(uprio, dtype=np.int64)),
        up(np.asarray(smask, dtype=bool).reshape(U, S)), up(sreq, dt), up(np.asarray(snode, dtype=np.int32)),
        tables["alloc"], tables["base_req"], up(extra_req, dt), tables["base_cnt"], up(extra_cnt, dt),
        tables["max_pods"], tables["vreq"], tables["vprio"], tables["vvalid"], tables["vmatch"], tables["allowed"],
    )
    cand, victims, viol = search(*args)
    return {"cand": cand.cpu().numpy(), "victims": victims.cpu().numpy(), "viol": viol.cpu().numpy()}
