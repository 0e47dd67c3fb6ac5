"""Byte-parity verdicts: diff two runs' annotation trails and classify.

A comparison's surface is :func:`utils.parity.pod_parity_state` — the
binding, the full sorted annotation trail, and the failure conditions,
per pod — the SAME surface every existing parity harness compares (a
drifting comparator copy is itself a bug class; see utils/parity.py).

Classification: the engines are allowed to take different *routes* to
the same bytes — exactness gates drain batch rounds to the sequential
cycle, stream waves to the serial path, preemption to the host oracle —
and every such drain is **counted** (``batch_fallbacks``,
``stream_drains_by_reason``, ``preempt_fallbacks``, ``gang_fallbacks``,
``kernel error: *``).  A verdict therefore carries two things: the byte
diff (any mismatch at all is a **divergence** — gates never excuse
bytes) and the counted-gate deltas observed during the run (the
*explained* routing detours, reported for triage and for the smoke's
composition histogram).
"""

from __future__ import annotations

from typing import Any

Obj = dict[str, Any]

# the service counters whose deltas "explain" a run's routing detours
GATE_COUNTERS = (
    "batch_fallbacks",
    "preempt_fallbacks",
    "gang_fallbacks",
    "stream_drains_by_reason",
    "encode_fallbacks_by_reason",
)


def gate_snapshot(metrics: Obj) -> dict[str, dict[str, int]]:
    """The counted exactness-gate maps out of a ``service.metrics()``."""
    return {k: dict(metrics.get(k) or {}) for k in GATE_COUNTERS}


def gate_delta(before: dict, after: dict) -> dict[str, dict[str, int]]:
    """Per-reason counter deltas between two gate snapshots, zero rows
    dropped."""
    out: dict[str, dict[str, int]] = {}
    for k in GATE_COUNTERS:
        d = {
            reason: after.get(k, {}).get(reason, 0) - before.get(k, {}).get(reason, 0)
            for reason in set(after.get(k, {})) | set(before.get(k, {}))
        }
        d = {r: n for r, n in sorted(d.items()) if n}
        if d:
            out[k] = d
    return out


def diff_states(a: Obj, b: Obj) -> list[Obj]:
    """Pod-level byte mismatches between two parity states: missing pods
    and differing rows, in sorted pod order."""
    out: list[Obj] = []
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key), b.get(key)
        if ra != rb:
            out.append({"pod": key, "a": _row(ra), "b": _row(rb)})
    return out


def _row(row: Any) -> Any:
    """JSON-serializable form of a parity row (tuples -> lists)."""
    if row is None:
        return None
    node, annotations, *rest = row
    return [node, [list(kv) for kv in annotations], *rest]


def compare(kind: str, state_a: Obj, state_b: Obj, explained: "Obj | None" = None) -> Obj:
    """One comparison verdict; ``equal`` is the whole judgment — the
    ``explained`` gate deltas are triage context, never an excuse."""
    mismatches = diff_states(state_a, state_b)
    return {
        "kind": kind,
        "equal": not mismatches,
        "mismatch_count": len(mismatches),
        # the full diff can be megabytes of annotation text; the verdict
        # keeps the first mismatch (the shrinker re-derives the rest)
        "first_mismatch": mismatches[0] if mismatches else None,
        "explained": explained or {},
    }


def verdict(scenario: Obj, comparisons: list[Obj]) -> Obj:
    """The scenario-level verdict: comparisons + the divergence list."""
    return {
        "scenario": scenario["name"],
        "features": list(scenario["features"]),
        "comparisons": comparisons,
        "divergences": [c["kind"] for c in comparisons if not c["equal"]],
    }
