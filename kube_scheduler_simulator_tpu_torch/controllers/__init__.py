"""Mini controller-manager (reference simulator/controller/controller.go).

The reference runs exactly three upstream controllers — deployment,
replicaset, and persistentvolume (newControllerInitializers,
controller.go:77-83) — so users can create Deployments/ReplicaSets and see
Pods appear, and PVCs bind to PVs.  This package reconciles the same three
on the in-memory store, synchronously and deterministically (scenario
replay needs convergence to be observable, KEP-140 ControllerWaiter).
"""

from kube_scheduler_simulator_tpu_torch.controllers.manager import ControllerManager

__all__ = ["ControllerManager"]
