"""Scenario replay engine (KEP-140 scenario-based simulation).

The reference only scaffolds this (a scenario/ controller project with an
empty Reconcile, reference scenario/controllers/scenario_controller.go:48-55);
the full design lives in keps/140-scenario-based-simulation/README.md and
is implemented here as a first-class engine over the in-memory store.

The port's copy exports the engine, the operator and the result functions.
The JAX package's ``simulation.py`` (KEP-184 SchedulerSimulation runs) and
``simulator_operator.py`` (KEP-159 Simulator objects) build on ``server/``,
which the port does not have yet; they come with it.
"""

from kube_scheduler_simulator_tpu_torch.scenario.engine import ScenarioEngine
from kube_scheduler_simulator_tpu_torch.scenario.operator import ScenarioOperator
from kube_scheduler_simulator_tpu_torch.scenario.result import allocation_rate, node_utilization

__all__ = [
    "ScenarioEngine",
    "ScenarioOperator",
    "allocation_rate",
    "node_utilization",
]
