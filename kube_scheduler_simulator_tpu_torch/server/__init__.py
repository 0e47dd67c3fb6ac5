"""HTTP API layer (reference simulator/server + handler + di)."""

from kube_scheduler_simulator_tpu_torch.server.di import DIContainer
from kube_scheduler_simulator_tpu_torch.server.server import SimulatorServer

__all__ = ["DIContainer", "SimulatorServer"]
