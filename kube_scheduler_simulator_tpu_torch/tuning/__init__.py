"""Learned scoring head: the plugin weights as a kernel argument, and the
tuner around them.

Port of the JAX package's ``tuning/``:

- ``validate``  — weight-vector validation at the API/config boundary
  (finite, non-negative, profile arity) + finalScore rendering shared by
  the batch formatter and the sequential result store.
- ``objective`` — utilization / fragmentation / pending-age objectives
  reduced from a rollout's final carry or selections (the objective
  kernel, csrc/tune.cu, on the card), and their cotangents.
- ``relax``     — the straight-through relaxed decision head: the value of
  a whole rollout and its gradient in the weights (a
  ``torch.autograd.Function`` whose backward is the scan's grad mode,
  K2g).
- ``tuner``     — CEM (one population launch, K9, per generation) and
  normalized gradient ascent; ``run_tuning`` is the entry point.
- ``scenario``  — deterministic scenario families with real weight/
  objective trade-offs.

This module imports only the validation boundary; the rest loads when a
tuning run starts.
"""

from kube_scheduler_simulator_tpu_torch.tuning.validate import (  # noqa: F401
    WeightValidationError,
    format_weighted_score,
    validate_plugin_weights,
)

__all__ = [
    "WeightValidationError",
    "format_weighted_score",
    "validate_plugin_weights",
    "run_tuning",
    "tuning_defaults",
    "tuning_families",
]


def __getattr__(name: str):  # lazy: keep torch's tuner out of light importers
    if name in ("run_tuning", "tuning_defaults", "tuning_families", "TuningSession"):
        from kube_scheduler_simulator_tpu_torch.tuning import tuner

        return getattr(tuner, name)
    raise AttributeError(name)
