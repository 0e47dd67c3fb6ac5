"""Gang scheduling engine: all-or-nothing PodGroup placement.

Port of the JAX package's ``gang/``.  Modules:

- ``podgroups``: the PodGroup kind — admission/validation, the
  coscheduling membership label, and the quorum/minResources gates both
  scheduling paths share;
- ``plugin``: the Coscheduling oracle plugin (PreFilter quorum gate,
  Permit gang parking/release over the WaitingPod machinery, PostFilter
  + Unreserve all-or-nothing rejection cascades);
- ``encode`` / ``kernel``: the gang kernels — the per-replay-window
  verdict (K6, csrc/gang.cu on the card) and the greedy all-or-nothing
  feasibility scan over G groups × N nodes (K7, the same source), each
  with its plain PyTorch version for CPU tensors, and a group-granularity
  victim search on preemption/'s kernel (K5);
- ``engine``: the batched gang replay (park / atomic wave release /
  window verdict) with counted fallbacks, and ``group_preview``;
- ``scenario``: the distributed-training scenario family (gangs with
  arrival/completion churn).
"""

# engine/kernel (and their torch dependency) load lazily: the registry
# imports gang.plugin on every service build
from kube_scheduler_simulator_tpu_torch.gang.podgroups import (  # noqa: F401
    POD_GROUP_LABEL,
    gang_batch_enabled,
    gang_scheduler_config,
    gang_scheduler_profile,
    group_gate,
    group_info,
    group_status,
    partially_bound_groups,
    pod_group_name,
    validate_pod_group,
)


def prepare_round(*args, **kwargs):
    """Lazy forwarder to :func:`gang.engine.prepare_round`."""
    from kube_scheduler_simulator_tpu_torch.gang.engine import prepare_round as _prepare

    return _prepare(*args, **kwargs)
