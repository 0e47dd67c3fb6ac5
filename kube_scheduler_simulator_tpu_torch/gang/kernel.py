"""The gang kernels: the per-window verdict (K6) and the all-or-nothing
feasibility scan (K7), plus the group-granularity victim search.

Port of the JAX package's ``gang/kernel.py``:

- ``run_window_verdict`` — ONE dispatch per replay window (not per group):
  over the window's per-member selections plus the members parked earlier,
  for all G groups at once, (a) all-or-nothing placement (no member
  failed, quorum met) and (b) the distinct topology domains the placed
  members span.  The reference's ``build_verdict_fn`` (:43).
- ``run_feasibility`` — per group, the member slots placed greedily over
  the node axis on free capacity, preferring nodes whose domain the group
  already uses, first maximum wins.  The reference's
  ``build_feasibility_fn`` (:108).
- ``group_victim_search`` — preemption/'s victim search (K5) at group
  granularity: each group's aggregate request is one preemptor row.

On the card the verdict's dispatch uploads its inputs in one pinned copy
and fetches one output buffer in one copy; the scan's goes through a
``Staging``: the inputs packed into one host buffer (pinned on the card)
go up in one copy, the kernel writes its outputs into one device buffer,
and they come back in one copy.  On the CPU the same buffer serves both
sides, so the layouts are exercised there too.

Each kernel has a plain PyTorch version here (``verdict_plain``,
``feasibility_plain``), which serves CPU tensors, and a hand-written CUDA
kernel in ``csrc/gang.cu`` behind ``ops/kernels.gang_verdict`` /
``gang_feasibility``, which serves CUDA tensors; the ``run_*`` functions
pick one by the device and never fall back.  Both take the true shapes:
no bucket padding.

Exactness: the verdict is int32 throughout.  The scan's resource columns
are GCD-scaled integers held in floats; every value it forms is a compare,
or a decrement that stays between 0 and the free capacity, so it is exact
while every magnitude stays below 2**24 (float32) or 2**53 (float64):
``run_feasibility`` checks that bound and raises ``ValueError`` past it.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.device import resolve_device, resolve_dtype

Obj = dict[str, Any]

EXACT_LIMIT = {torch.float32: 1 << 24, torch.float64: 1 << 53}


# ------------------------------------------------------------------ staging

_ALIGN = 16  # byte alignment of each array in a staged buffer


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def stage_layout(arrays: list) -> "tuple[list[int], int]":
    """(byte offset of each numpy array, bytes of them all) packed at
    16-byte boundaries in order."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += _up(a.nbytes)
    return offs, total


class Staging:
    """One dispatch's buffers: ``put`` packs numpy arrays at 16-byte offsets
    of one host buffer (pinned when the device is the card), moves them in
    one copy and hands back their views on the device, with an output
    buffer after them there; ``get`` brings the output back in one copy and
    waits for the stream.  On the CPU the host buffer is the device
    buffer."""

    def __init__(self, device: "str | torch.device") -> None:
        self.device = torch.device(device)

    def put(self, arrays: list, out_bytes: int) -> "tuple[list[torch.Tensor], torch.Tensor]":
        """(``arrays`` as tensors on the device, a uint8 output buffer of
        ``out_bytes`` there)."""
        offs, n_in = stage_layout(arrays)
        cuda = self.device.type == "cuda"
        nbytes = max(n_in + _up(out_bytes), _ALIGN)
        self._host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
        hn = self._host.numpy()
        for a, o in zip(arrays, offs):
            hn[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        self._dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device) if cuda else self._host
        if cuda:
            self._dev[:n_in].copy_(self._host[:n_in], non_blocking=True)
        self._out = (n_in, out_bytes)
        views = [
            self._dev[o : o + a.nbytes].view(getattr(torch, a.dtype.name)).reshape(a.shape)
            for a, o in zip(arrays, offs)
        ]
        return views, self._dev[n_in : n_in + out_bytes]

    def get(self) -> torch.Tensor:
        """The output buffer on the host."""
        o, n = self._out
        if self._dev is not self._host:
            self._host[o : o + n].copy_(self._dev[o : o + n], non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        return self._host[o : o + n]


# ------------------------------------------------------------ window verdict


def verdict_plain(gid, node, dom, prior_bound, min_member, D: int):
    """The window verdict in PyTorch, the reference's order of operations.

    gid [K] int32 (-1 pads), node [K] int32 (-1 = member failed), dom [G,N]
    int32, prior_bound [G] int32, min_member [G] int32.  Returns (feasible
    [G] bool, distinct [G] int32, placed [G] int32)."""
    G = dom.shape[0]
    dev = dom.device
    valid = gid >= 0
    placed = valid & (node >= 0)
    failed = valid & (node < 0)
    gsel = torch.where(valid, gid, 0).long()
    cnt = torch.zeros(G, dtype=torch.int32, device=dev).index_add_(0, gsel, placed.to(torch.int32))
    nfail = torch.zeros(G, dtype=torch.int32, device=dev).index_add_(0, gsel, failed.to(torch.int32))
    feasible = (nfail == 0) & ((cnt + prior_bound) >= min_member)
    # distinct domains spanned by the placed members: the reference reads
    # dom[gsel, clip(node, 0)] for every slot and marks only placed ones
    dm = dom[gsel, node.clamp(min=0).long()].clamp(min=0).long()
    used = torch.zeros(G * D, dtype=torch.int32, device=dev).index_add_(0, gsel * D + dm, placed.to(torch.int32))
    distinct = (used.view(G, D) > 0).sum(dim=1).to(torch.int32)
    return feasible, distinct, cnt


def verdict_layout(G: int) -> int:
    """Bytes of the verdict's one output buffer: distinct [G] int32, placed
    [G] int32, then feasible [G] bool."""
    return 9 * G


def verdict_views(buf: torch.Tensor, G: int):
    """(feasible [G] bool, distinct [G] int32, placed [G] int32): views of a
    uint8 buffer of ``verdict_layout(G)`` bytes."""
    return buf[8 * G : 9 * G].view(torch.bool), buf[: 4 * G].view(torch.int32), buf[4 * G : 8 * G].view(torch.int32)


def window_verdict(gid, node, dom, prior_bound, min_member, D: int, out: "torch.Tensor | None" = None):
    """The verdict on the tensors' device: the CUDA kernel for CUDA tensors
    (a build or launch failure propagates; ``out`` as kernels.gang_verdict),
    the plain version for CPU tensors."""
    if dom.is_cuda:
        from kube_scheduler_simulator_tpu_torch.ops import kernels as K

        return K.gang_verdict(gid, node, dom, prior_bound, min_member, D, out=out)
    return verdict_plain(gid, node, dom, prior_bound, min_member, D)


def run_window_verdict(
    gid, node, dom, prior_bound, min_member, D: int, device: "str | torch.device | None" = None,
    split: "dict | None" = None,
) -> dict:
    """Dispatch the window verdict on ``device`` (the card unless the caller
    passes "cpu"); ``dom`` may already be a tensor there (the round keeps
    it resident).  On the card gid, node, prior_bound and min_member go up
    in one pinned copy and the three outputs come back in one.  Returns
    numpy ``feasible``, ``distinct_domains`` and ``placed`` per group.
    ``split``: a dict that gets the dispatch's host seconds on the card by
    stage: ``stage_s`` (the inputs into pinned memory), ``launch_s`` (the
    copy in, the output buffer, the launch and the copy out enqueued),
    ``wait_s`` (the stream's synchronize, with ``pending``: whether work
    was still queued there) and ``views_s``."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    host = [np.ascontiguousarray(a.cpu() if isinstance(a, torch.Tensor) else a, dtype=np.int32).reshape(-1)
            for a in (gid, node, prior_bound, min_member)]
    dom_t = dom.to(dev) if isinstance(dom, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(dom, dtype=np.int32)).to(dev)
    G = dom_t.shape[0]
    D = max(int(D), 1)
    if G == 0:
        z = np.zeros(0, dtype=np.int32)
        return {"feasible": z.astype(bool), "distinct_domains": z, "placed": z}
    if dev.type != "cuda":
        gid_t, node_t, prior_t, min_t = (torch.from_numpy(a) for a in host)
        feasible, distinct, placed = window_verdict(gid_t, node_t, dom_t, prior_t, min_t, D)
        return {"feasible": feasible.numpy(), "distinct_domains": distinct.numpy(), "placed": placed.numpy()}
    sizes = [a.size for a in host]
    staged = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=True)
    staged.numpy()[:] = np.concatenate(host)
    t1 = time.perf_counter()
    gid_t, node_t, prior_t, min_t = staged.to(dev, non_blocking=True).split(sizes)
    out = torch.empty(verdict_layout(G), dtype=torch.uint8, device=dev)
    window_verdict(gid_t, node_t, dom_t, prior_t, min_t, D, out=out)
    res = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
    res.copy_(out, non_blocking=True)
    t2 = time.perf_counter()
    stream = torch.cuda.current_stream(dev)
    pending = split is not None and not stream.query()
    stream.synchronize()
    t3 = time.perf_counter()
    feasible, distinct, placed = verdict_views(res, G)
    r = {"feasible": feasible.numpy(), "distinct_domains": distinct.numpy(), "placed": placed.numpy()}
    if split is not None:
        split.update(stage_s=t1 - t0, launch_s=t2 - t1, wait_s=t3 - t2, pending=pending,
                     views_s=time.perf_counter() - t3)
    return r


# --------------------------------------------------------- feasibility scan


def feasibility_plain(req, valid, free, cnt_free, dom, D: int):
    """The all-or-nothing scan in PyTorch, vectorised over the groups, a
    Python loop over the member slots.

    req [G,M,R] float; valid [G,M] bool; free [N,R] float; cnt_free [N]
    float; dom [G,N] int32.  Every group starts from the same free
    capacity.  Per slot: the nodes where the member fits (every column and
    a pod to spare) rank 2 when their domain is already used by the group,
    1 otherwise; the lowest-index node of the highest rank takes the
    member.  An invalid slot places nothing and leaves the verdict alone; a
    valid slot that fits nowhere fails the group, and the scan goes on.
    Returns (feasible [G] bool, distinct [G] int32, assignment [G,M] int32,
    -1 where nothing was placed)."""
    G, M, R = req.shape
    N = free.shape[0]
    dev, dt = free.device, free.dtype
    fr = free.unsqueeze(0).expand(G, N, R).clone()
    cf = cnt_free.unsqueeze(0).expand(G, N).clone()
    used = torch.zeros((G, max(int(D), 1)), dtype=torch.bool, device=dev)
    ok = torch.ones(G, dtype=torch.bool, device=dev)
    sel = torch.full((G, M), -1, dtype=torch.int32, device=dev)
    ar = torch.arange(N, device=dev)
    domL = dom.long()
    zero = torch.zeros((), dtype=dt, device=dev)
    for m in range(M):
        rq = req[:, m, :]  # [G,R]
        fits = (rq.unsqueeze(1) <= fr).all(dim=-1) & (cf >= 1)  # [G,N]
        packed = torch.gather(used, 1, domL)
        rank = torch.where(fits, 1 + packed.to(torch.int32), 0)
        best = rank.max(dim=1, keepdim=True).values if N else torch.zeros((G, 1), dtype=torch.int32, device=dev)
        # the first maximum: the lowest node index of the best rank
        pick = torch.where(rank == best, ar, N).min(dim=1).values if N else torch.zeros(G, dtype=torch.long, device=dev)
        anyfit = fits.any(dim=1)
        place = valid[:, m] & anyfit
        ok = ok & (anyfit | ~valid[:, m])
        if N:
            one = (ar.unsqueeze(0) == pick.unsqueeze(1)) & place.unsqueeze(1)  # [G,N]
            fr = fr - torch.where(one.unsqueeze(-1), rq.unsqueeze(1), zero)
            cf = cf - one.to(dt)
            d = torch.gather(domL, 1, pick.unsqueeze(1))  # [G,1]
            used.scatter_(1, d, torch.gather(used, 1, d) | place.unsqueeze(1))
        sel[:, m] = torch.where(place, pick.to(torch.int32), -1)
    return ok, used.sum(dim=1).to(torch.int32), sel


def feasibility_layout(G: int, M: int) -> int:
    """Bytes of the scan's one output buffer: assignment [G,M] int32,
    distinct [G] int32, then feasible [G] bool."""
    return 4 * G * M + 5 * G


def feasibility_views(buf: torch.Tensor, G: int, M: int):
    """(feasible [G] bool, distinct [G] int32, assignment [G,M] int32):
    views of a uint8 buffer of ``feasibility_layout(G, M)`` bytes."""
    a = 4 * G * M
    return buf[a + 4 * G : a + 5 * G].view(torch.bool), buf[a : a + 4 * G].view(torch.int32), \
        buf[:a].view(torch.int32).view(G, M)


def _into(views, res):
    """Copy the plain version's results into the output buffer's views."""
    for v, r in zip(views, res):
        v.copy_(r)
    return views


def feasibility(req, valid, free, cnt_free, dom, D: int, out: "torch.Tensor | None" = None):
    """The scan on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors; with ``out`` (as
    kernels.gang_feasibility) the results are views of it on either."""
    if free.is_cuda:
        from kube_scheduler_simulator_tpu_torch.ops import kernels as K

        return K.gang_feasibility(req, valid, free, cnt_free, dom, D, out=out)
    res = feasibility_plain(req, valid, free, cnt_free, dom, D)
    return res if out is None else _into(feasibility_views(out, *req.shape[:2]), res)


def run_feasibility(
    pr: Any, device: "str | torch.device | None" = None, dtype: "torch.dtype | None" = None,
    split: "dict | None" = None,
) -> dict:
    """Dispatch the scan for an encoded ``gang.encode.GangFeasibilityProblem``
    on ``device`` (the card unless the caller passes "cpu") in ``dtype``
    (float32 on the card, float64 on the CPU): one dispatch covers every
    group, its inputs up in one copy and its outputs back in one
    (``Staging``).  Raises ``ValueError`` when a magnitude is beyond exact
    integers in the dtype.  ``split``: a dict that gets the dispatch's host
    seconds by stage: ``stage_s`` (the inputs packed and their copy
    enqueued), ``launch_s``, ``wait_s`` (the copy out and the stream's
    synchronize) and ``views_s``."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    # the largest magnitude the scan forms: a free capacity, a request or a
    # pod budget (a decrement stays between 0 and the capacity it comes from)
    worst = max(int(np.abs(a).max(initial=0)) for a in (pr.free, pr.req, pr.cnt_free))
    if worst >= EXACT_LIMIT[dt]:
        raise ValueError(f"feasibility scan values reach {worst}, beyond exact integers in {dt} ({EXACT_LIMIT[dt]})")
    G, M = pr.req.shape[:2]
    if G == 0:
        return {
            "feasible": np.zeros(0, dtype=bool),
            "distinct_domains": np.zeros(0, dtype=np.int32),
            "assignment": np.zeros(pr.req.shape[:2], dtype=np.int32),
        }
    npdt = np.float32 if dt == torch.float32 else np.float64
    st = Staging(dev)
    (req, valid, free, cnt, dom), out = st.put([
        pr.req.astype(npdt), np.asarray(pr.valid, dtype=bool), pr.free.astype(npdt), pr.cnt_free.astype(npdt),
        np.asarray(pr.dom, dtype=np.int32),
    ], feasibility_layout(G, M))
    t1 = time.perf_counter()
    feasibility(req, valid, free, cnt, dom, max(int(pr.D), 1), out=out)
    t2 = time.perf_counter()
    res = st.get()
    t3 = time.perf_counter()
    ok, distinct, sel = feasibility_views(res, G, M)
    r = {"feasible": ok.numpy(), "distinct_domains": distinct.numpy(), "assignment": sel.numpy()}
    if split is not None:
        split.update(stage_s=t1 - t0, launch_s=t2 - t1, wait_s=t3 - t2, views_s=time.perf_counter() - t3)
    return r


# ----------------------------------------------------- group victim search


def group_victim_search(
    node_infos: list[Any],
    groups: "list[tuple[list[Obj], int]]",
    pdbs: "list[Obj] | None" = None,
    device: "str | torch.device | None" = None,
    dtype: "torch.dtype | None" = None,
) -> list[dict]:
    """Group-granularity victim search on preemption/'s kernel: each
    group's AGGREGATE member request is one preemptor row, so one dispatch
    answers, per group, which single node could host the whole gang after
    evicting lower-priority pods (and whom).

    ``groups``: [(unbound member pods, group priority)].  Returns one dict
    per group: ``{"node": name | None, "victims": [pod names]}`` — an
    estimation surface, never a placement decision.  ``device``/``dtype``
    as ``preemption.kernel.run_search``."""
    from kube_scheduler_simulator_tpu_torch.preemption import encode as PE
    from kube_scheduler_simulator_tpu_torch.preemption import kernel as PK

    if not groups:
        return []
    all_members = [p for ms, _prio in groups for p in ms]
    resource_names = PE.fit_resource_axis(all_members) or ["cpu"]
    res_idx = {r: j for j, r in enumerate(resource_names)}
    max_prio = max((prio for _ms, prio in groups), default=0)
    pr = PE.encode_preemption(node_infos, resource_names, pdbs or [], max_pending_priority=max_prio)
    U, N, R = len(groups), len(node_infos), len(resource_names)
    ureq = np.zeros((U, R), dtype=np.int64)
    uprio = np.zeros(U, dtype=np.int64)
    for u, (ms, prio) in enumerate(groups):
        for p in ms:
            ureq[u] += PE._req_vec(p, res_idx)
        uprio[u] = prio
    for r in range(R):
        PE.gcd_scale_columns([pr.alloc[:, r], pr.base_req[:, r], pr.vreq[:, :, r], ureq[:, r]])
    if pr.V == 0:
        return [{"node": None, "victims": []} for _ in groups]
    masks = PK.run_search(
        pr, np.ones((U, N), dtype=bool), ureq, uprio,
        np.zeros((U, 0), dtype=bool), np.zeros((0, R), dtype=np.int64), np.zeros((0,), dtype=np.int32),
        device=device, dtype=dtype,
    )
    out = []
    for u in range(U):
        ids = np.nonzero(masks["cand"][u])[0]
        if ids.size == 0:
            out.append({"node": None, "victims": []})
            continue
        # fewest victims, then lowest node index — a preview ranking (the
        # exact pickOneNodeForPreemption criteria live in preemption/)
        nv = masks["victims"][u].sum(axis=-1)
        best = int(min(ids, key=lambda n: (int(nv[n]), int(n))))
        sl = np.nonzero(masks["victims"][u, best])[0]
        out.append(
            {
                "node": pr.node_names[best],
                "victims": [pr.victim_pods[best][int(s)]["metadata"]["name"] for s in sl],
            }
        )
    return out

