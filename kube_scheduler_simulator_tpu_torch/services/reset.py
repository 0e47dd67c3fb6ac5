"""Reset service: restore the boot-time cluster state + scheduler config.

Rebuild of the reference's reset service (reference
simulator/reset/reset.go:32-84): at construction it captures the store's
current contents (the etcd-keyspace snapshot analog of reset.go:44-53);
``reset()`` deletes everything, restores that initial data, and resets the
scheduler configuration to its initial value.
"""

from __future__ import annotations

from typing import Any


class ResetService:
    def __init__(self, cluster_store: Any, scheduler_service: Any):
        self.cluster_store = cluster_store
        self.scheduler_service = scheduler_service
        # Capture initial state NOW (boot time), like NewResetService.
        self._initial = cluster_store.dump()

    def reset(self) -> None:
        self.cluster_store.restore(self._initial)
        self.scheduler_service.reset_scheduler_configuration()
