"""Plugin-weight validation + rendering shared by every weight boundary.

The port's own copy of the JAX package's ``tuning/validate.py``.  Light
(numpy only): the scheduler service, the batch engine and the result store
import it — a user-supplied weight vector is rejected HERE, at the config
boundary, with an error that names the problem, never later as a shape
error inside a kernel launch.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np


class WeightValidationError(ValueError):
    """A user-supplied plugin-weight vector failed validation (the HTTP
    layer maps this to 422 Unprocessable Entity)."""


def _check_value(name: str, v: Any) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float, np.integer, np.floating)):
        raise WeightValidationError(
            f"plugin weight for {name} must be a number, got {type(v).__name__}"
        )
    f = float(v)
    if not np.isfinite(f):
        raise WeightValidationError(f"plugin weight for {name} must be finite, got {v!r}")
    if f < 0:
        raise WeightValidationError(f"plugin weight for {name} must be non-negative, got {v!r}")
    return f


def validate_plugin_weights(
    weights: Any,
    score_plugins: "Sequence[str]",
    defaults: "Mapping[str, float] | None" = None,
) -> np.ndarray:
    """Validate a user-supplied weight vector against a profile's score
    plugins and return it as a float64 [S] array in plugin order.

    Accepts a sequence (must match the profile's score-plugin arity, in
    profile order) or a mapping plugin-name → weight (unknown names are
    rejected; omitted names fall back to ``defaults`` when given, else
    are rejected).  Every value must be a finite, non-negative number.
    Raises :class:`WeightValidationError` otherwise."""
    names = list(score_plugins)
    if isinstance(weights, Mapping):
        unknown = [k for k in weights if k not in names]
        if unknown:
            raise WeightValidationError(
                f"unknown score plugin(s) {unknown} — this profile scores {names}"
            )
        out = []
        for n in names:
            if n in weights:
                out.append(_check_value(n, weights[n]))
            elif defaults is not None and n in defaults:
                out.append(_check_value(n, defaults[n]))
            else:
                raise WeightValidationError(
                    f"missing weight for score plugin {n} (profile scores {names})"
                )
        return np.asarray(out, dtype=np.float64)
    if isinstance(weights, (str, bytes)) or not isinstance(weights, Sequence):
        try:
            import numpy as _np

            if isinstance(weights, _np.ndarray):
                weights = list(weights)
            else:
                raise TypeError
        except TypeError:
            raise WeightValidationError(
                f"pluginWeights must be a list of {len(names)} numbers (profile "
                f"score order {names}) or a plugin-name → weight mapping, got "
                f"{type(weights).__name__}"
            ) from None
    vals = list(weights)
    if len(vals) != len(names):
        raise WeightValidationError(
            f"expected {len(names)} weights for score plugins {names}, got {len(vals)}"
        )
    return np.asarray([_check_value(n, v) for n, v in zip(names, vals)], dtype=np.float64)


def format_weighted_score(normalized: int, weight: Any) -> str:
    """Render a finalScore annotation value (normalized × weight) — the
    SAME bytes as the integer path (``str(int(norm) * int(w))``) whenever
    the product is integral, a fixed ``%.10g`` rendering otherwise, so
    the batch trace formatter and the sequential result store can never
    disagree about a tuned (float) weight's annotation bytes."""
    p = float(int(normalized)) * float(weight)
    if p == int(p):
        return str(int(p))
    return format(p, ".10g")
