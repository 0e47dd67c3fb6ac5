"""Scenario replay engine (KEP-140 scenario-based simulation).

The reference only scaffolds this (a scenario/ controller project with an
empty Reconcile, reference scenario/controllers/scenario_controller.go:48-55);
the full design lives in keps/140-scenario-based-simulation/README.md and
is implemented here as a first-class engine over the in-memory store.

The port's copy exports what the JAX package's does: the engine, the
operator, the result functions, KEP-184 SchedulerSimulation runs
(``simulation.py``) and the KEP-159 Simulator operator
(``simulator_operator.py``).
"""

from kube_scheduler_simulator_tpu_torch.scenario.engine import ScenarioEngine
from kube_scheduler_simulator_tpu_torch.scenario.operator import ScenarioOperator
from kube_scheduler_simulator_tpu_torch.scenario.result import allocation_rate, node_utilization
from kube_scheduler_simulator_tpu_torch.scenario.simulation import run_scheduler_simulation
from kube_scheduler_simulator_tpu_torch.scenario.simulator_operator import SimulatorOperator

__all__ = [
    "ScenarioEngine",
    "ScenarioOperator",
    "SimulatorOperator",
    "allocation_rate",
    "node_utilization",
    "run_scheduler_simulation",
]
