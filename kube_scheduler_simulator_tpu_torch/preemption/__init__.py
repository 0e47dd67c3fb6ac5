"""Batched preemption: upstream DefaultPreemption's victim search as one
dispatch over U unschedulable pods × N candidate nodes (K5), so a
kernel-failed pod's PostFilter stays on the batch round.

Port of the JAX package's ``preemption/``.  Modules:

- ``encode``: host-side encoding of the victim-search problem (per-node
  MoreImportantPod-ordered victim slots, PDB match matrix, GCD-scaled
  resource columns);
- ``kernel``: the search — ``preempt_plain`` (PyTorch, CPU tensors) and the
  hand-written CUDA kernel ``csrc/preempt.cu`` (CUDA tensors), with
  ``run_search`` around them;
- ``engine``: the round context (``prepare_round``/``decide``) plus the
  supportability gates that keep the batched search byte-identical to the
  sequential oracle (plugins/intree/queue_bind.DefaultPreemption).
"""

from kube_scheduler_simulator_tpu_torch.preemption.engine import (  # noqa: F401
    Decision,
    PreemptionRound,
    nomination_gate,
    prepare_round,
)
