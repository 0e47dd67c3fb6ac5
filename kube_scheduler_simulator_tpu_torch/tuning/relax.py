"""Whole rollouts as functions of the weights: value, population, gradient.

Port of the JAX package's ``tuning/relax.py``.  The scan's decision is an
argmax over weighted plugin scores, piecewise constant in the weights.
The reference makes the commit one-hot straight-through,

    soft = softmax(totals / tau) over the sampled nodes
    oh   = soft + stop_gradient(hard - soft),

whose forward values are the hard rollout's and whose backward flows
d(committed planes)/d(weights) through the softmax, and takes the gradient
by autodiff through the whole scan.

Here the gradient is a ``torch.autograd.Function`` (``RolloutValue``):

- forward: the hard rollout in the scan's grad mode (K2g's forward,
  ``kernels.scan_grad_forward`` on the card, ``grad_residual_plain`` on
  the CPU), which also folds the residual M [2, S, N] of every committed
  pod's softmax term over the pod chain, and the objective (csrc/tune.cu
  on the card);
- backward: the objective's cotangent F = d objective / d final_nonzero,
  then its contraction with M (``kernels.grad_contract``,
  ``grad_contract_plain`` on the CPU): no second pass over the pod chain
  (ops/batch.grad_plain gives the formula and why no carry passes
  gradient, grad_residual_plain why M carries it).

``BatchConfig.relax_tau`` keeps the reference's straight-through head in
the plain scan, so torch autograd through ``scan_plain`` checks the
closed form on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from kube_scheduler_simulator_tpu_torch.ops import batch as B
from kube_scheduler_simulator_tpu_torch.tuning.objective import objective_grad, objective_value


def rollout(cfg: "B.BatchConfig", dims: dict, dp: Any, W: torch.Tensor) -> dict:
    """The hard rollouts under the rows of ``W`` [L, S] (the problem's
    dtype and device), every output with a leading lane axis: one
    population launch (K9) on the card, ``scan_lanes_plain`` on the CPU."""
    if dp.alloc.device.type == "cuda":
        from kube_scheduler_simulator_tpu_torch.ops import kernels

        return kernels.scan_population(cfg, dims, dp, W)
    return B.scan_lanes_plain(cfg, dims, dp, weights=W)


def rollout_residual(cfg: "B.BatchConfig", dims: dict, dp: Any, w: torch.Tensor, tau: float):
    """(K2g's residual M [2, S, N] float64, the hard rollout under ``w``):
    the grad forward on the card, ``grad_residual_plain`` on the CPU."""
    if dp.alloc.device.type == "cuda":
        from kube_scheduler_simulator_tpu_torch.ops import kernels

        return kernels.scan_grad_forward(cfg, dims, dp, w, tau)
    return B.grad_residual_plain(cfg, dims, dp, w, tau)


def contract(M: torch.Tensor, F: torch.Tensor, tau: float) -> torch.Tensor:
    """d objective / d weights [S] float64 from M and F: the contraction
    kernel on the card, ``grad_contract_plain`` on the CPU."""
    if M.device.type == "cuda":
        from kube_scheduler_simulator_tpu_torch.ops import kernels

        return kernels.grad_contract(M, F, tau)
    return B.grad_contract_plain(M, F, tau)


class RolloutValue(torch.autograd.Function):
    """value(w) of one rollout at the temperature ``tau``: the forward is
    K2g's grad forward and the objective, the backward the cotangent and
    the contraction."""

    @staticmethod
    def forward(ctx, w, cfg, dims, dp, age_w, objective, tau):
        wd = w.detach().to(device=dp.alloc.device, dtype=dp.alloc.dtype).contiguous()
        M, out = rollout_residual(cfg, dims, dp, wd, tau)
        ys = {k: out[k] for k in ("final_nonzero", "selected")}
        ctx.args = (M, dp, age_w, objective, tau, ys, w.device, w.dtype)
        return objective_value(objective, ys, dp, age_w)

    @staticmethod
    def backward(ctx, g):
        M, dp, age_w, objective, tau, ys, w_dev, w_dt = ctx.args
        F = objective_grad(objective, ys, dp, age_w)
        dw = contract(M, F, tau)
        return (g.double() * dw).to(device=w_dev, dtype=w_dt), None, None, None, None, None, None


def build_value_fn(
    cfg: "B.BatchConfig", dims: dict, objective: str, relax_tau: float = 0.0,
) -> "Callable[[Any, Any, Any], torch.Tensor]":
    """``value(dp, w, age_w) -> scalar`` (higher = better): one full
    rollout under the [S] weight vector ``w`` and its objective.
    ``relax_tau > 0`` makes the value differentiable in ``w`` (a
    ``RolloutValue``); its forward equals the hard build's."""
    cfg = cfg._replace(relax_tau=0.0, trace=False)
    tau = float(relax_tau)

    def value(dp, w, age_w):
        w = torch.as_tensor(w, dtype=dp.alloc.dtype, device=dp.alloc.device) if not torch.is_tensor(w) else w
        if tau > 0:
            return RolloutValue.apply(w, cfg, dims, dp, age_w, objective, tau)
        W = w.detach().to(device=dp.alloc.device, dtype=dp.alloc.dtype).contiguous()[None]
        return objective_value(objective, rollout(cfg, dims, dp, W), dp, age_w)[0]

    value.cfg, value.dims, value.objective, value.tau = cfg, dims, objective, tau
    return value


def build_population_fn(value_fn: Callable) -> Callable:
    """``evaluate(dp, W[pop,S], age_w) -> [pop]`` hard objectives in ONE
    launch: the rollouts run as lanes over the weight rows (K9), the
    problem shared, then one objective launch over the lanes."""
    cfg, dims, objective = value_fn.cfg, value_fn.dims, value_fn.objective

    def evaluate(dp, W, age_w):
        W = torch.as_tensor(W).to(device=dp.alloc.device, dtype=dp.alloc.dtype).contiguous()
        return objective_value(objective, rollout(cfg, dims, dp, W), dp, age_w)

    return evaluate


def build_grad_fn(value_fn: Callable) -> Callable:
    """``grad(dp, w, age_w) -> (value, dvalue/dw)``: ``value_fn`` must come
    from a ``relax_tau > 0`` build for the gradient to be nonzero."""

    def grad(dp, w, age_w):
        w = torch.as_tensor(w, dtype=torch.float64).clone().requires_grad_(True)
        v = value_fn(dp, w, age_w)
        if not v.requires_grad:  # a hard build: the gradient is zero
            return v, torch.zeros_like(w.detach())
        (g,) = torch.autograd.grad(v, w)
        return v.detach(), g

    return grad
