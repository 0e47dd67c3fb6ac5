"""The weight tuners: whole-rollout optimization on the card.

Port of the JAX package's ``tuning/tuner.py``.  A :class:`TuningSession`
encodes a scenario ONCE (host), places it ONCE on the service's device and
dtype, and then every tuner iteration exchanges only a weight vector [S]
against one scalar objective (or one [S] gradient):

- ``run_cem``: cross-entropy method over the HARD objective — one
  population launch (K9: the scan over the population's weight rows,
  then one objective launch) evaluates a whole generation.  Needs
  nothing differentiable, so it covers every objective.
- ``run_grad``: normalized gradient ascent through the straight-through
  relaxed rollout (tuning/relax.py): per step one hard rollout (K9 with
  one lane), the objective and its cotangent, and the scan's grad mode
  (K2g).  Forward values equal the hard rollout's, so the reported
  objectives need no re-evaluation.

``rollouts``, ``dispatches`` and ``grad_dispatches`` keep the reference's
meaning (one dispatch per evaluate, population or value-and-grad call);
the kernel launches count in ``ops/kernels.LAUNCHES`` as
``scan_population``, ``objective`` and ``scan_grad``.  A problem whose
resource values would go inexact in float32 runs in float64
(``ops/batch.exactness_bound`` / ``round_dtype``; ``bound``,
``promotion``).

Knobs (all overridable per call, env defaults validated hard like
``KSS_PLACER_SCATTER_FRAC``):

- ``KSS_TUNING_STEPS`` (default 8): tuner iterations.
- ``KSS_TUNING_POP`` (default 16): CEM population per generation.
- ``KSS_TUNING_TAU`` (default 50.0): softmax temperature of the relaxed
  head — roughly the score-total gap (in weighted normalized-score
  points) at which two nodes share gradient mass.
- ``KSS_TUNING_LR`` (default 1.0): normalized-gradient step size, in
  weight units — large enough to cross a decision boundary (weights are
  O(1)–O(3)) within a few steps.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

import torch

from kube_scheduler_simulator_tpu_torch.device import resolve_device, resolve_dtype
from kube_scheduler_simulator_tpu_torch.tuning.objective import OBJECTIVES
from kube_scheduler_simulator_tpu_torch.tuning.scenario import FAMILIES, build_family
from kube_scheduler_simulator_tpu_torch.tuning.validate import (
    WeightValidationError,
    validate_plugin_weights,
)

Obj = dict[str, Any]


def _env_pos(name: str, default: float, integer: bool = False):
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return int(default) if integer else float(default)
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a positive number, got {raw!r}") from None
    if v <= 0 or (integer and v != int(v)):
        kind = "positive integer" if integer else "positive number"
        raise ValueError(f"{name} must be a {kind}, got {raw!r}")
    return int(v) if integer else v


def tuning_defaults() -> dict:
    return {
        "steps": _env_pos("KSS_TUNING_STEPS", 8, integer=True),
        "pop": _env_pos("KSS_TUNING_POP", 16, integer=True),
        "tau": _env_pos("KSS_TUNING_TAU", 50.0),
        "lr": _env_pos("KSS_TUNING_LR", 1.0),
    }


def profile_scores(
    svc: Any = None, device: "str | torch.device | None" = None,
) -> "tuple[list[tuple[str, int]], list[str]]":
    """(score plugins with default weights, filter plugin names) — from a
    live SchedulerService's default profile when given, else from a
    throwaway default-config port service on ``device`` (what the
    standalone bench/smoke paths tune against)."""
    if svc is None:
        from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
        from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

        svc = SchedulerService(ClusterStore(), device=device)
        svc.start_scheduler(None)
    fw = svc.framework
    assert fw is not None, "scheduler not started"
    scores = [
        (wp.original.name, fw.score_weights.get(wp.original.name, 1))
        for wp in fw.plugins["score"]
    ]
    filters = [wp.original.name for wp in fw.plugins["filter"]]
    return scores, filters


class TuningSession:
    """One scenario placed on the device + its rollout closures.

    ``rollouts`` counts objective evaluations (CEM counts every
    population member), ``dispatches`` the evaluate / population /
    value-and-grad calls, and ``grad_dispatches`` the value-and-grad
    calls — the reference's numbers.  ``device``: the card unless the
    caller passes "cpu" (the plain versions); ``dtype``: float32 on the
    card, float64 on the CPU unless given, promoted to float64 when the
    problem's bound (``bound``) passes float32's exact integers
    (``promotion`` says why)."""

    def __init__(
        self,
        nodes: "list[Obj]",
        pods: "list[Obj]",
        scores: "list[tuple[str, int]]",
        filters: "list[str] | None" = None,
        objective: str = "utilization",
        dtype: Any = None,
        device: "str | torch.device | None" = None,
    ):
        from kube_scheduler_simulator_tpu_torch.ops import batch as B
        from kube_scheduler_simulator_tpu_torch.ops import encode as E

        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; choose from {OBJECTIVES}")
        if not scores:
            raise ValueError("tuning needs at least one score plugin")
        self.objective = objective
        self.scores = list(scores)
        kernel_filters = tuple(
            f
            for f in (filters if filters is not None else B.FILTER_KERNELS)
            if f in set(B.FILTER_KERNELS)
        )
        for s, _w in scores:
            if s not in set(B.SCORE_KERNELS):
                raise ValueError(f"score plugin {s} has no batch kernel to tune")
        pr = E.encode(nodes, pods, pods, None)
        pr = E.pad_problem(pr)
        self.device = resolve_device(device)
        self.bound = B.exactness_bound(pr)
        dt, self.promotion = B.round_dtype(self.bound, resolve_dtype(self.device, dtype))
        # ONE placement; every rollout reuses the resident planes and
        # ships only the weights
        dp, dims = B.lower(pr, dtype=dt, device=self.device)
        self.cfg = B.BatchConfig(
            filters=kernel_filters,
            scores=tuple((s, w) for s, w in scores),
            trace=False,
            tie_break="first",
        )
        self.dims = dims
        self.pr = pr
        self.dp = dp
        self.age_w = torch.as_tensor(E.objective_planes(pr, pods)["age_w"], dtype=dt).to(self.device)
        from kube_scheduler_simulator_tpu_torch.tuning import relax

        self._relax = relax
        self._value = relax.build_value_fn(self.cfg, dims, objective)
        self._pop_fn = None
        self._grad_fns: dict[float, Any] = {}
        self.rollouts = 0
        self.dispatches = 0
        self.grad_dispatches = 0

    def _w(self, w) -> np.ndarray:
        w = np.asarray(w, dtype=np.float64)
        if w.shape != (len(self.scores),):
            raise WeightValidationError(
                f"weight vector shape {w.shape} != ({len(self.scores)},)"
            )
        return w

    def evaluate(self, w) -> float:
        """One hard rollout → the objective scalar (higher = better)."""
        v = self._value(self.dp, self._w(w), self.age_w)
        self.rollouts += 1
        self.dispatches += 1
        return float(v)

    def evaluate_population(self, W: np.ndarray) -> np.ndarray:
        """[pop,S] weight matrix → [pop] objectives, ONE dispatch."""
        if self._pop_fn is None:
            self._pop_fn = self._relax.build_population_fn(
                self._relax.build_value_fn(self.cfg, self.dims, self.objective)
            )
        W = np.asarray(W, dtype=np.float64)
        v = self._pop_fn(self.dp, W, self.age_w).cpu().numpy().astype(np.float64)
        self.rollouts += len(W)
        self.dispatches += 1
        return v

    def value_and_grad(self, w, tau: float) -> "tuple[float, np.ndarray]":
        """Relaxed-rollout objective + d(objective)/d(weights); the value
        is bit-identical to ``evaluate`` (straight-through forward)."""
        fn = self._grad_fns.get(float(tau))
        if fn is None:
            fn = self._grad_fns[float(tau)] = self._relax.build_grad_fn(
                self._relax.build_value_fn(
                    self.cfg, self.dims, self.objective, relax_tau=float(tau)
                )
            )
        v, g = fn(self.dp, self._w(w), self.age_w)
        self.rollouts += 1
        self.dispatches += 1
        self.grad_dispatches += 1
        return float(v), g.cpu().numpy().astype(np.float64)


def run_cem(
    session: TuningSession,
    init: np.ndarray,
    steps: "int | None" = None,
    pop: "int | None" = None,
    elite_frac: float = 0.25,
    seed: int = 0,
) -> dict:
    """Cross-entropy search from ``init``; returns best weights/objective
    plus the per-generation history (best-so-far is monotone by
    construction — the smoke test pins it)."""
    d = tuning_defaults()
    steps = int(steps if steps is not None else d["steps"])
    pop = max(int(pop if pop is not None else d["pop"]), 2)
    rng = np.random.default_rng(seed)
    mean = np.asarray(init, dtype=np.float64).copy()
    std = np.maximum(mean * 0.5, 0.5)
    n_elite = max(int(pop * elite_frac), 1)
    best_w, best_v = mean.copy(), -np.inf
    history = []
    # Generation-0 screening candidates: the zero vector and each
    # plugin's one-hot (at its default magnitude).  Gaussian samples
    # around the profile default can't reach structurally different
    # corners of the weight simplex (e.g. "ignore this plugin entirely")
    # within a few generations — the screen hands CEM every single-
    # plugin policy up front and the Gaussian refines from whichever
    # region wins.  At most half the population, so random exploration
    # survives even tiny pops.
    screen = [np.zeros_like(mean)] + [
        np.eye(len(mean))[j] * max(mean[j], 1.0) for j in range(len(mean))
    ]
    for t in range(steps):
        W = rng.normal(mean, std, size=(pop, len(mean))).clip(0.0, None)
        W[0] = mean  # elitist: the current mean is always a candidate
        if t == 0:
            for j, cand in enumerate(screen[: max(pop // 2, 1)]):
                W[1 + j] = cand
        vals = session.evaluate_population(W)
        order = np.argsort(-vals, kind="stable")
        elites = W[order[:n_elite]]
        mean = elites.mean(axis=0)
        std = np.maximum(elites.std(axis=0), 0.05)
        if float(vals[order[0]]) > best_v:
            best_v = float(vals[order[0]])
            best_w = W[order[0]].copy()
        history.append(
            {"step": t, "generationBest": float(vals[order[0]]), "bestSoFar": best_v}
        )
    return {"weights": best_w.tolist(), "objective": best_v, "history": history}


def run_grad(
    session: TuningSession,
    init: np.ndarray,
    steps: "int | None" = None,
    lr: "float | None" = None,
    tau: "float | None" = None,
) -> dict:
    """Normalized gradient ascent through the straight-through relaxed
    rollout.  The step is ``lr · g/‖g‖`` — weight-scale moves regardless
    of the objective's raw gradient magnitude."""
    d = tuning_defaults()
    steps = int(steps if steps is not None else d["steps"])
    lr = float(lr if lr is not None else d["lr"])
    tau = float(tau if tau is not None else d["tau"])
    w = np.asarray(init, dtype=np.float64).copy()
    best_w, best_v = w.copy(), -np.inf
    history = []
    for t in range(steps):
        v, g = session.value_and_grad(w, tau)
        if v > best_v:
            best_v, best_w = v, w.copy()
        gn = float(np.linalg.norm(g))
        history.append({"step": t, "objective": v, "gradNorm": gn, "bestSoFar": best_v})
        if gn < 1e-12:
            break  # flat surrogate (e.g. pending_age): stop honestly
        w = np.clip(w + lr * g / gn, 0.0, None)
    # the post-update endpoint may beat every visited point
    v_end = session.evaluate(w)
    if v_end > best_v:
        best_v, best_w = v_end, w.copy()
    return {"weights": best_w.tolist(), "objective": best_v, "history": history}


def run_tuning(
    family: str = "imbalance",
    objective: "str | None" = None,
    tuner: str = "cem",
    n_nodes: int = 12,
    n_pods: int = 96,
    steps: "int | None" = None,
    pop: "int | None" = None,
    lr: "float | None" = None,
    tau: "float | None" = None,
    seed: int = 0,
    weights: Any = None,
    svc: Any = None,
    device: "str | torch.device | None" = None,
    dtype: Any = None,
) -> dict:
    """One tuning run: build the scenario family, evaluate the profile's
    default weights, run the named tuner, and report the comparison —
    the shape ``/api/v1/tuning``, ``bench.py --tune-report`` and
    ``scripts/tune_smoke.py`` all consume.

    ``weights``: optional user-supplied STARTING vector (validated
    against the profile's score plugins — arity/finite/non-negative,
    :class:`WeightValidationError` on failure).  ``svc``: a live
    SchedulerService whose profile defines the plugin set, whose device
    and dtype the session takes, and whose ``tuning_*`` counters absorb
    this run's dispatch counts.  Without ``svc``: ``device`` (the card
    unless "cpu") and ``dtype`` (float32 on the card, float64 on the
    CPU)."""
    if tuner not in ("cem", "grad"):
        raise ValueError(f"tuner must be cem|grad, got {tuner!r}")
    scores, filters = profile_scores(svc, device=device)
    if svc is not None:
        device, dtype = svc.device, svc.dtype
    names = [s for s, _w in scores]
    default_w = np.asarray([float(w) for _s, w in scores], dtype=np.float64)
    init = (
        validate_plugin_weights(weights, names, defaults=dict(scores))
        if weights is not None
        else default_w
    )
    nodes, pods, fam_obj = build_family(family, n_nodes=n_nodes, n_pods=n_pods, seed=seed)
    objective = objective or fam_obj
    session = TuningSession(nodes, pods, scores, filters=filters, objective=objective, dtype=dtype, device=device)
    default_v = session.evaluate(default_w)
    if tuner == "cem":
        res = run_cem(session, init, steps=steps, pop=pop, seed=seed)
    else:
        res = run_grad(session, init, steps=steps, lr=lr, tau=tau)
    tuned_v = float(res["objective"])
    report = {
        "family": family,
        "objective": objective,
        "tuner": tuner,
        "nodes": len(nodes),
        "pods": len(pods),
        "scorePlugins": names,
        "defaultWeights": default_w.tolist(),
        "defaultObjective": default_v,
        "weights": res["weights"],
        "tunedObjective": tuned_v,
        "improvement": tuned_v - default_v,
        "rollouts": session.rollouts,
        "dispatches": session.dispatches,
        "gradDispatches": session.grad_dispatches,
        "history": res["history"],
    }
    report["kernelPlatform"] = session.device.type
    if svc is not None and hasattr(svc, "note_tuning_run"):
        svc.note_tuning_run(session, report)
    return report


def tuning_families() -> "list[str]":
    return sorted(FAMILIES)
