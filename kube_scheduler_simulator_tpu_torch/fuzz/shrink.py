"""Automatic shrinking: minimize a diverging scenario to a fixture.

Given a scenario and a ``still_fails`` predicate (byte divergence
reproduces), the shrinker greedily deletes structure while the
divergence survives — delete-tick, halve-cluster, then delete-op passes,
iterated to a fixpoint under a check budget.  It is a pure function of
``(scenario, still_fails outcomes)``: the passes walk fixed orders and
take the first accepted reduction, so the same seed and the same
divergence always shrink to the byte-identical minimized scenario
(pinned by tests/test_torch_fuzz.py, against the JAX package's shrinker).

Minimized scenarios are committed under ``fuzz/fixtures/`` with EXACT
expected bytes — the oracle path's full parity state: a replay that
produces different bytes (or any divergence) fails the tests, so a
committed fixture can never silently regress.  The port's fixtures are
the JAX package's files, byte for byte.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

Obj = dict[str, Any]

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _with_ticks(scenario: Obj, ticks: list[list[Obj]]) -> Obj:
    out = dict(scenario)
    out["ticks"] = ticks
    return out


def shrink(
    scenario: Obj,
    still_fails: Callable[[Obj], bool],
    max_checks: int = 192,
) -> tuple[Obj, Obj]:
    """Minimize ``scenario`` while ``still_fails`` keeps returning True.

    Returns ``(minimized, stats)``; ``stats["steps"]`` counts ACCEPTED
    reductions (the ``fuzz_shrink_steps_total`` metric), ``checks`` the
    predicate invocations spent (bounded by ``max_checks``, the
    ``KSS_FUZZ_SHRINK_STEPS`` knob)."""
    stats = {"checks": 0, "steps": 0}

    def check(cand: Obj) -> bool:
        if stats["checks"] >= max_checks:
            return False  # budget exhausted: keep what we have
        stats["checks"] += 1
        return bool(still_fails(cand))

    cur = scenario
    changed = True
    while changed and stats["checks"] < max_checks:
        changed = False

        # pass 1: delete whole ticks (latest first — tails are usually
        # settle noise)
        for i in reversed(range(len(cur["ticks"]))):
            if stats["checks"] >= max_checks:
                break
            ticks = cur["ticks"][:i] + cur["ticks"][i + 1 :]
            if not ticks:
                continue
            cand = _with_ticks(cur, ticks)
            if check(cand):
                cur = cand
                stats["steps"] += 1
                changed = True

        # pass 2: halve the cluster — drop the back half of the node
        # creates in one candidate (references to removed nodes are
        # forgiven by the runner's op application)
        node_ops = [
            (ti, oi)
            for ti, ops in enumerate(cur["ticks"])
            for oi, op in enumerate(ops)
            if op["op"] == "create" and op["kind"] == "nodes"
        ]
        if len(node_ops) >= 2 and stats["checks"] < max_checks:
            drop = set(node_ops[len(node_ops) // 2 :])
            ticks = [
                [op for oi, op in enumerate(ops) if (ti, oi) not in drop]
                for ti, ops in enumerate(cur["ticks"])
            ]
            cand = _with_ticks(cur, ticks)
            if check(cand):
                cur = cand
                stats["steps"] += 1
                changed = True

        # pass 3: delete individual ops (latest first)
        for ti in reversed(range(len(cur["ticks"]))):
            for oi in reversed(range(len(cur["ticks"][ti]))):
                if stats["checks"] >= max_checks:
                    break
                ticks = [list(ops) for ops in cur["ticks"]]
                del ticks[ti][oi]
                if not any(ticks):
                    continue
                cand = _with_ticks(cur, ticks)
                if check(cand):
                    cur = cand
                    stats["steps"] += 1
                    changed = True
    return cur, stats


# ----------------------------------------------------------------- fixtures


def canonical_json(obj: Any) -> str:
    """The one serialization fixtures use — byte-stable across runs."""
    return json.dumps(obj, sort_keys=True, indent=2, ensure_ascii=False) + "\n"


def make_fixture(
    scenario: Obj,
    comparisons: "tuple[str, ...] | list[str]",
    expected: list,
    note: str = "",
    chaos: "Obj | None" = None,
) -> Obj:
    """A committed fixture: the (minimized) scenario, the comparisons to
    replay, the oracle path's EXACT expected parity bytes
    (:func:`fuzz.runner.encode_state`), an optional chaos plan, and the
    triage note explaining what the case pins."""
    out: Obj = {
        "name": scenario["name"],
        "note": note,
        "comparisons": list(comparisons),
        "expected": expected,
        "scenario": scenario,
    }
    if chaos is not None:
        out["chaos"] = chaos
    return out


def write_fixture(fixture: Obj, directory: str = FIXTURE_DIR) -> str:
    path = os.path.join(directory, f"{fixture['name']}.json")
    with open(path, "w", encoding="utf-8") as f:
        f.write(canonical_json(fixture))
    return path


def iter_fixture_paths(directory: str = FIXTURE_DIR) -> list[str]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        os.path.join(directory, fn)
        for fn in os.listdir(directory)
        if fn.endswith(".json")
    )


def load_fixture(path: str) -> Obj:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def replay_fixture(fixture: Obj, device: Any = None, dtype: Any = None) -> tuple[Obj, list]:
    """Re-run a committed fixture standalone (a fresh harness on ``device``
    in ``dtype``, None being the card and its default — fixtures must
    reproduce from scratch, not from a warmed sequence).  Returns
    ``(verdict, oracle_state_encoded)``; the replay test asserts no
    divergence AND byte-equality against ``fixture["expected"]``."""
    from kube_scheduler_simulator_tpu_torch.fuzz import runner

    v, states = runner.run_differential(
        fixture["scenario"],
        harness=None,
        comparisons=tuple(fixture["comparisons"]),
        chaos=fixture.get("chaos"),
        device=device,
        dtype=dtype,
    )
    oracle_role = "oracle" if "oracle" in states else sorted(states)[0]
    return v, runner.encode_state(states[oracle_role])
