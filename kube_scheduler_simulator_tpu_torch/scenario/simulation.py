"""KEP-184 SchedulerSimulation: one-shot Scenario × N-scheduler runs.

The reference designs (design-only — no code ships) a `SchedulerSimulation`
CRD whose controller spins a `Simulator` Pod per run, injects a
"scenario-runner" container that posts the Scenario into the simulator's
apiserver, waits for completion, and collects the result file
(reference keps/184-scheduler-simulation/README.md:44-158).  The
motivation is comparative: "run the same scenario with various schedulers
and see which scheduler is the best one" (README.md:18).

This build realizes that flow in process: each entry in
``spec.simulators`` gets an ISOLATED simulator instance — its own
ClusterStore, controller manager, and SchedulerService (the in-process
analog of the KEP's Simulator Pod; KEP-159's Simulator objects ride the
same substrate) — the Scenario runs deterministically in each via the
KEP-140 engine, and the status carries a per-simulator report built from
the KEP-140 result-calculation package (allocation rate, per-node
utilization — keps/140-scenario-based-simulation/README.md:553-565) plus
a cross-simulator comparison, which is the part the reference leaves to
"analyzes the results ... and calculates a score" user code
(keps/184 README.md:186-190).

Spec (`simulation.kube-scheduler-simulator.sigs.k8s.io/v1alpha1`,
kind ``SchedulerSimulation``):

    spec:
      scenario: {<ScenarioSpec>}          # inline; or
      scenarioTemplateFilePath: path.yaml # the KEP's file indirection
      simulators:
        - name: default                   # one isolated run per entry
          schedulerConfig: {<KubeSchedulerConfiguration>}  # optional
          useBatch: auto|off|force        # optional (default auto)
          seed: 0                         # optional

Status: ``phase`` (Completed/Failed), RFC3339 ``startTime`` /
``completionTime``, ``message`` (on failure), ``results[]`` (per
simulator: scenario phase, step count, report) and ``comparison``.

The port's copy of the JAX package's ``scenario/simulation.py``.  Every
isolated instance runs on the caller's ``device`` (the card unless the
caller passes "cpu"), in the calling thread; the template path stays
confined to ``KSS_SCENARIO_TEMPLATE_DIR``.
"""

from __future__ import annotations

import copy
import time
from typing import Any

from kube_scheduler_simulator_tpu_torch.scenario.result import allocation_rate, node_utilization

Obj = dict[str, Any]


def now_rfc3339() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())

GROUP = "simulation.kube-scheduler-simulator.sigs.k8s.io"
API_VERSION = f"{GROUP}/v1alpha1"
KIND = "SchedulerSimulation"


class SchedulerSimulationError(Exception):
    pass


def _resolve_template_path(path: str) -> str:
    """Resolve ``spec.scenarioTemplateFilePath`` INSIDE the configured
    template directory ($KSS_SCENARIO_TEMPLATE_DIR).  The field arrives
    from API clients (POST /api/v1/schedulersimulations, the CRD), so an
    unrestricted open() is a file-disclosure primitive; with no directory
    configured the indirection is disabled outright."""
    import os

    base = os.environ.get("KSS_SCENARIO_TEMPLATE_DIR")
    if not base:
        raise SchedulerSimulationError(
            "spec.scenarioTemplateFilePath is disabled: set "
            "KSS_SCENARIO_TEMPLATE_DIR to the scenario-template directory"
        )
    root = os.path.realpath(base)
    full = os.path.realpath(os.path.join(root, path))
    if full != root and not full.startswith(root + os.sep):
        raise SchedulerSimulationError(
            "spec.scenarioTemplateFilePath escapes the scenario-template directory"
        )
    return full


def _load_scenario_spec(spec: Obj) -> Obj:
    scenario = spec.get("scenario")
    if scenario is None:
        path = spec.get("scenarioTemplateFilePath")
        if not path:
            raise SchedulerSimulationError(
                "spec.scenario or spec.scenarioTemplateFilePath is required"
            )
        import json

        full = _resolve_template_path(path)
        try:
            with open(full) as f:
                text = f.read()
        except OSError:
            raise SchedulerSimulationError(f"cannot read scenario template {path!r}")
        # Parser exceptions embed file-content snippets (YAML error
        # context) — never reflect their text into status.message.
        try:
            doc = json.loads(text)
        except ValueError:
            try:
                import yaml

                doc = yaml.safe_load(text)
            except ImportError:  # pragma: no cover - yaml is bundled
                raise SchedulerSimulationError(
                    f"cannot parse scenario template {path!r} (yaml unavailable)"
                )
            except Exception:
                raise SchedulerSimulationError(
                    f"cannot parse scenario template {path!r} as JSON or YAML"
                )
        # accept either a full Scenario object or a bare spec
        scenario = doc.get("spec", doc) if isinstance(doc, dict) else None
    if not isinstance(scenario, dict):
        raise SchedulerSimulationError("scenario must be an object")
    return scenario


def _run_in_isolated_simulator(scenario_spec: Obj, sim: Obj, device: Any = None) -> "tuple[Obj, Obj]":
    """One simulator instance, one deterministic scenario run — returns
    (final scenario status, report).  The instance is the in-process
    analog of the KEP's Simulator Pod: nothing is shared with the caller
    or with sibling runs."""
    from kube_scheduler_simulator_tpu_torch.scenario.engine import ScenarioEngine
    from kube_scheduler_simulator_tpu_torch.server.di import DIContainer

    di = DIContainer(
        initial_scheduler_cfg=sim.get("schedulerConfig"),
        use_batch=sim.get("useBatch", "auto"),
        seed=int(sim.get("seed") or 0),
        # the ephemeral store never holds Simulator/SchedulerSimulation
        # CRs — don't boot an operator that reconciles nothing
        enable_simulator_operator=False,
        device=device,
    )
    try:
        engine = ScenarioEngine(
            di.cluster_store, di.scheduler_service(), di.controller_manager()
        )
        done = engine.run({"spec": copy.deepcopy(scenario_spec)})
        status = done.get("status") or {}
        store = di.cluster_store
        pods = store.list("pods", copy_objects=False)
        scheduled = sum(1 for p in pods if (p.get("spec") or {}).get("nodeName"))
        timeline = ((status.get("scenarioResult") or {}).get("timeline")) or {}
        report = {
            "allocationRate": round(allocation_rate(store), 6),
            "nodeUtilization": node_utilization(store),
            "pods": len(pods),
            "scheduledPods": scheduled,
            "unscheduledPods": len(pods) - scheduled,
            "timelineEvents": sum(len(v) for v in timeline.values()),
            "steps": len(timeline),
        }
        return status, report
    finally:
        di.close()


def _bindings_of(status: Obj) -> dict[str, str]:
    """pod → node bindings drawn from the scenario timeline's generated
    ``podScheduled`` events (the KEP-140 result "simple data"), for
    divergence reporting."""
    out: dict[str, str] = {}
    timeline = ((status.get("scenarioResult") or {}).get("timeline")) or {}
    for events in timeline.values():
        for ev in events:
            pod = (ev.get("podScheduled") or {}).get("result") or {}
            name = (pod.get("metadata") or {}).get("name")
            node = (pod.get("spec") or {}).get("nodeName")
            if name and node:
                out[name] = node
    return out


def run_scheduler_simulation(obj: Obj, device: Any = None) -> Obj:
    """Execute a SchedulerSimulation object to completion (the KEP's
    controller flow, steps 1-7, collapsed into one synchronous pass over
    in-process simulator instances on ``device``).  Returns the object
    with status."""
    obj = copy.deepcopy(obj)
    spec = obj.get("spec") or {}
    status: Obj = {"phase": "Running", "startTime": now_rfc3339()}
    obj["status"] = status
    try:
        scenario_spec = _load_scenario_spec(spec)
        simulators = spec.get("simulators") or [{"name": "default"}]
        if not isinstance(simulators, list) or not simulators:
            raise SchedulerSimulationError("spec.simulators must be a non-empty list")
        names = [s.get("name") or f"simulator-{i}" for i, s in enumerate(simulators)]
        if len(set(names)) != len(names):
            raise SchedulerSimulationError(f"duplicate simulator names: {names}")
        results = []
        bindings: dict[str, dict[str, str]] = {}
        for name, sim in zip(names, simulators):
            scn_status, report = _run_in_isolated_simulator(scenario_spec, sim, device)
            if scn_status.get("phase") not in ("Succeeded", "Paused"):
                raise SchedulerSimulationError(
                    f"simulator {name!r}: scenario phase {scn_status.get('phase')!r}: "
                    f"{scn_status.get('message')}"
                )
            bindings[name] = _bindings_of(scn_status)
            results.append(
                {"simulator": name, "scenarioPhase": scn_status.get("phase"), "report": report}
            )
        status["results"] = results
        status["comparison"] = _compare(results, bindings)
        status["phase"] = "Completed"
    except Exception as e:
        status["phase"] = "Failed"
        status["message"] = f"{type(e).__name__}: {e}"
    status["completionTime"] = now_rfc3339()
    return obj


def _compare(results: list[Obj], bindings: dict[str, dict[str, str]]) -> Obj:
    """The cross-simulator table the KEP's user stories compute by hand:
    headline metrics side by side plus where the schedulers diverged."""
    metrics = {
        r["simulator"]: {
            "allocationRate": r["report"]["allocationRate"],
            "scheduledPods": r["report"]["scheduledPods"],
            "unscheduledPods": r["report"]["unscheduledPods"],
        }
        for r in results
    }
    names = list(bindings)
    divergent: dict[str, dict[str, "str | None"]] = {}
    if len(names) > 1:
        all_pods = sorted(set().union(*[set(b) for b in bindings.values()]))
        for pod in all_pods:
            placed = {n: bindings[n].get(pod) for n in names}
            if len(set(placed.values())) > 1:
                divergent[pod] = placed
    best = max(metrics, key=lambda n: metrics[n]["allocationRate"]) if metrics else None
    return {
        "metrics": metrics,
        "divergentPlacements": divergent,
        "divergentCount": len(divergent),
        "bestAllocationRate": best,
    }
