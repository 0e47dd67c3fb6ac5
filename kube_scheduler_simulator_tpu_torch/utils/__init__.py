"""Small helpers shared by the port's modules."""

from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

__all__ = ["SimClock"]
