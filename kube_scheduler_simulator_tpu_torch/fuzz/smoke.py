"""The bounded fuzz sweep and its KernelChaos leg (``python -m
kube_scheduler_simulator_tpu_torch.fuzz``, ``__main__.py``).

:func:`sweep` drives ``KSS_FUZZ_SCENARIOS`` generated scenarios (default
25) from a fixed seed list, ``(seed, seed + 1)``, each composing at least
three subsystems, through the two byte-diff comparisons: the batch engine
against the sequential oracle, and the streamed feed against the serial
one.  With ``KSS_FUZZ_BUDGET`` seconds set it keeps generating fresh
indices of ``seed`` until the budget is spent.  Every scenario after the
first runs under ``RecompileGuard(max_compiles=0)``: the kernels are built
and loaded once, then only launched.  A divergence is confirmed on a fresh
harness, shrunk (``KSS_FUZZ_SHRINK_STEPS`` checks) and its minimized
scenario written to a JSON file under the temp directory.

:func:`chaos_leg` re-runs one composite scenario with injected kernel
failures on the batch and streamed roles: parity must hold, the injection
must trip, and the degrade must be counted (``kernel error: ChaosError``).

The reference's ``shard-vs-single`` comparison runs on a two-shard mesh
of the harness's device; its streamed one over a mesh is not ported
(``ShardNotPorted``, ROADMAP 7c); its worker-fault leg is
``fuzz.chaos.WorkerChaos`` and its process-kill leg
``fuzz.chaos.ProcessChaos``, which ``chip_smoke.py`` drives on the card.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Callable

from kube_scheduler_simulator_tpu_torch.analysis.runtime import RecompileGuard
from kube_scheduler_simulator_tpu_torch.fuzz import chaos as chaos_mod
from kube_scheduler_simulator_tpu_torch.fuzz.coverage import CoverageMap
from kube_scheduler_simulator_tpu_torch.fuzz.generator import generate_scenario
from kube_scheduler_simulator_tpu_torch.fuzz.runner import FuzzHarness, run_differential
from kube_scheduler_simulator_tpu_torch.fuzz.shrink import shrink

Obj = dict[str, Any]

CHAOS_FEATURES = frozenset({"preemption", "churn", "retune"})
CHAOS_PLAN = {"roles": ["batch", "stream-on"], "fail_events": [0, 3]}


def triage(scn: Obj, kinds: "list[str]", shrink_budget: int, device: Any) -> Obj:
    """Confirm a divergence on a fresh harness, shrink it, and write the
    minimized scenario to a JSON file under the temp directory."""
    comparisons = tuple(kinds)
    # one standalone harness for the confirmation and every shrink check:
    # reset() keeps each candidate aligned (both members of a pair replay
    # the same candidate sequence)
    standalone = FuzzHarness(device)

    def still_fails(s: Obj) -> bool:
        v, _ = run_differential(s, standalone, comparisons=comparisons)
        return bool(v["divergences"])

    out: Obj = {"scenario": scn["name"], "kinds": list(kinds)}
    if not still_fails(scn):
        out["standalone"] = "did NOT reproduce standalone (cross-scenario context?)"
        return out
    mini, stats = shrink(scn, still_fails, max_checks=shrink_budget)
    out["standalone"] = "reproduced"
    out["shrink_steps"] = stats["steps"]
    path = os.path.join(tempfile.gettempdir(), f"kss_fuzz_{scn['name']}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"kinds": list(kinds), "scenario": mini}, f, sort_keys=True, indent=2)
    out["repro"] = path
    return out


def sweep(
    harness: FuzzHarness,
    knobs: Obj,
    log: Callable[[str], None] = print,
) -> Obj:
    """The seeded sweep of ``knobs`` (``fuzz_knobs()``' keys) on
    ``harness``.  Returns the report: ``scenarios``, ``divergences`` by
    kind, ``shrink_steps``, ``failures`` (triage records), ``coverage``,
    ``seconds`` a scenario, and ``compiles`` (library builds and loads
    after the first scenario: 0, or the guard raised)."""
    t0 = time.monotonic()
    cov = CoverageMap()
    report: Obj = {"scenarios": 0, "divergences": {}, "shrink_steps": 0, "failures": [], "seconds": []}

    def judge(scn: Obj) -> None:
        if len(scn["features"]) < 3:
            raise AssertionError(f"{scn['name']} composes only {scn['features']}")
        ts = time.perf_counter()
        v, _states = run_differential(scn, harness)
        report["seconds"].append(time.perf_counter() - ts)
        report["scenarios"] += 1
        for kind in v["divergences"]:
            report["divergences"][kind] = report["divergences"].get(kind, 0) + 1
        if v["divergences"]:
            log(f"fuzz DIVERGENCE {scn['name']} {v['divergences']}: {json.dumps(v['comparisons'])[:4000]}")
            tri = triage(scn, v["divergences"], knobs["shrink_steps"], harness.device)
            report["shrink_steps"] += tri.get("shrink_steps", 0)
            report["failures"].append(tri)
            log(f"fuzz triage: {json.dumps(tri)}")

    if knobs["budget_s"] > 0:
        # long-haul: fresh indices until the budget is spent
        order = ((knobs["seed"], i) for i in range(1 << 30))
    else:
        seeds = (knobs["seed"], knobs["seed"] + 1)
        per_seed = (knobs["scenarios"] + len(seeds) - 1) // len(seeds)
        order = iter([(s, i) for s in seeds for i in range(per_seed)])
    first = next(order, None)
    if first is not None:
        judge(generate_scenario(*first, coverage=cov))
    with RecompileGuard("the fuzz sweep after its first scenario", max_compiles=0) as guard:
        for seed, i in order:
            if knobs["budget_s"] > 0 and time.monotonic() - t0 >= knobs["budget_s"]:
                break
            judge(generate_scenario(seed, i, coverage=cov))
    report["compiles"] = guard.compiles
    report["coverage"] = cov.summary()
    return report


def chaos_leg(harness: FuzzHarness, seed: int) -> Obj:
    """One composite scenario with injected kernel failures (``CHAOS_PLAN``)
    on the batch and streamed roles.  Returns ``divergences``, ``trips``
    and the ``kernel error`` counts the roles' services explained."""
    scn = generate_scenario(seed + 7, 0, features=CHAOS_FEATURES)
    trips = {"n": 0}
    orig_exit = chaos_mod.KernelChaos.__exit__

    def spy_exit(self: Any, *exc: Any) -> None:
        trips["n"] += self.trips
        return orig_exit(self, *exc)

    chaos_mod.KernelChaos.__exit__ = spy_exit
    try:
        v, _ = run_differential(scn, harness, chaos=CHAOS_PLAN)
    finally:
        chaos_mod.KernelChaos.__exit__ = orig_exit
    explained = {k: n for c in v["comparisons"] for k, n in c["explained"].items()}
    kernel_errors = {
        f"{counter}: {reason}": n
        for counter, reasons in explained.items()
        for reason, n in reasons.items()
        if reason.startswith("kernel error")
    }
    return {"scenario": scn["name"], "divergences": v["divergences"], "trips": trips["n"],
            "kernel_errors": kernel_errors}
