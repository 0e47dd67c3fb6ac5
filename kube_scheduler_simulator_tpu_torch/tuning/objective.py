"""Scenario objectives: one scalar a rollout, higher is better.

Port of the JAX package's ``tuning/objective.py``.  Each objective reads
what a rollout leaves in its outputs (``final_nonzero`` [N,2] or the
per-pod ``selected``) and the problem's static planes, and returns one
scalar; cost-shaped objectives (fragmentation, pending-age) are negated
here, once.

- ``utilization`` and ``fragmentation`` read the final resource carry,
  which the relaxed head's soft one-hot feeds: real gradients.
- ``pending_age`` reads the per-pod selections, which carry no gradient
  (the CEM tuner covers it).

Every sum is a fixed pairwise tree (``tree_sum``): the values padded with
zeros to a power of two, then halved as ``x[:h] + x[h:]`` until one value
is left.  The objective kernel (csrc/tune.cu) adds in the same tree, so
the two are bitwise equal.  ``objective_value`` and ``objective_grad``
take the kernel for tensors on the card and these plain versions for
tensors on the CPU; both take a leading lane axis.  ``objective_grad`` is
the cotangent F = d objective / d final_nonzero that the scan's grad mode
(K2g) reads: the reference's autodiff of the same formulas, with the
derivative JAX gives ``jnp.abs`` (``select(x >= 0, 1, -1)``: +1 at 0, so
an empty active node carries one) and utilization's guarded
denominator.
"""

from __future__ import annotations

from typing import Any

import torch

OBJECTIVES = ("utilization", "fragmentation", "pending_age")


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the fixed pairwise tree of csrc/tune.cu."""
    n = x.shape[-1]
    pw = 1 << max(n - 1, 0).bit_length()
    if pw > n:
        x = torch.cat([x, torch.zeros((*x.shape[:-1], pw - n), dtype=x.dtype, device=x.device)], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _full(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full_like(x, v)


def _den(cap: torch.Tensor) -> torch.Tensor:
    return torch.where(cap == 0, _full(cap, 1.0), cap)


def _used_frac(used: torch.Tensor, dp: Any) -> "tuple[torch.Tensor, torch.Tensor]":
    """([..., N, 2] committed cpu/mem fraction over active nodes, 0 where
    the node allocates none of the resource or is padding; the mask)."""
    cap = dp.nz_alloc
    cond = (cap > 0) & dp.node_active[:, None]
    return torch.where(cond, used / _den(cap), torch.zeros_like(used)), cond


def _sums(name: str, ys: dict, dp: Any, age_w: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """The objective's two tree sums per lane: (sum f, sum f^2) for
    utilization, (active nodes, sum |f0 - f1| active) for fragmentation,
    (sum age_w, pending age mass) for pending_age."""
    if name == "pending_age":
        pending = (ys["selected"] < 0) & dp.pod_active
        return tree_sum(age_w.expand(pending.shape)), tree_sum(age_w * pending.to(age_w.dtype))
    f, _cond = _used_frac(ys["final_nonzero"], dp)
    if name == "utilization":
        flat = f.reshape(*f.shape[:-2], -1)
        return tree_sum(flat), tree_sum(flat * flat)
    act = dp.node_active.to(f.dtype).expand(f.shape[:-1])
    return tree_sum(act), tree_sum(torch.abs(f[..., 0] - f[..., 1]) * act)


def objective_plain(name: str, ys: dict, dp: Any, age_w: torch.Tensor) -> torch.Tensor:
    """The named objective's value (a lane axis in ``ys`` gives one a lane)."""
    s1, s2 = _sums(name, ys, dp, age_w)
    if name == "utilization":
        return s2 / torch.where(s1 == 0, _full(s1, 1.0), s1)
    floor = 1.0 if name == "fragmentation" else 1e-9
    return -s2 / torch.maximum(s1, _full(s1, floor))


def objective_grad_plain(name: str, ys: dict, dp: Any, age_w: torch.Tensor) -> torch.Tensor:
    """F = d objective / d final_nonzero, shaped as ``final_nonzero``."""
    used = ys["final_nonzero"]
    f, cond = _used_frac(used, dp)
    if name == "pending_age":
        return torch.zeros_like(used)
    s1, s2 = (v[..., None, None] for v in _sums(name, ys, dp, age_w))
    if name == "utilization":
        sp = torch.where(s1 == 0, _full(s1, 1.0), s1)
        gS = torch.where(s1 != 0, (-s2 / sp) / sp, _full(s1, 0.0))
        df = _full(f, 2.0) * f * (_full(sp, 1.0) / sp) + gS
    else:
        d = f[..., 0] - f[..., 1]
        act = dp.node_active.to(f.dtype)
        sg = torch.where(d >= 0, _full(d, 1.0), _full(d, -1.0))
        g = _full(s1[..., 0], -1.0) / torch.maximum(s1[..., 0], _full(s1[..., 0], 1.0)) * act * sg
        df = torch.stack([g, -g], dim=-1)
    return torch.where(cond, df / _den(dp.nz_alloc), torch.zeros_like(df))


def _laned(ys: dict) -> "tuple[dict, bool]":
    """``ys`` with a leading lane axis on the fields the objectives read."""
    one = ys["final_nonzero"].dim() == 2
    if one:
        ys = {"final_nonzero": ys["final_nonzero"][None], "selected": ys["selected"][None]}
    return ys, one


def _check(name: str) -> None:
    if name not in OBJECTIVES:
        raise ValueError(f"unknown objective {name!r}; choose from {OBJECTIVES}")


def objective_value(name: str, ys: dict, dp: Any, age_w: torch.Tensor) -> torch.Tensor:
    """The named objective's scalar (higher = better) for one rollout, or
    [L] for a lane axis: the objective kernel on the card, the plain
    version on the CPU."""
    _check(name)
    if ys["final_nonzero"].device.type != "cuda":
        return objective_plain(name, ys, dp, age_w)
    from kube_scheduler_simulator_tpu_torch.ops import kernels

    lys, one = _laned(ys)
    v = kernels.objective(
        name, lys["final_nonzero"].contiguous(), lys["selected"].contiguous(), dp.nz_alloc, dp.node_active,
        dp.pod_active, age_w,
    )
    return v[0] if one else v


def objective_grad(name: str, ys: dict, dp: Any, age_w: torch.Tensor) -> torch.Tensor:
    """F = d objective / d final_nonzero: the objective kernel's backward
    mode on the card, the plain version on the CPU."""
    _check(name)
    if ys["final_nonzero"].device.type != "cuda":
        return objective_grad_plain(name, ys, dp, age_w)
    from kube_scheduler_simulator_tpu_torch.ops import kernels

    lys, one = _laned(ys)
    F = kernels.objective(
        name, lys["final_nonzero"].contiguous(), lys["selected"].contiguous(), dp.nz_alloc, dp.node_active,
        dp.pod_active, age_w, backward=True,
    )
    return F[0] if one else F
