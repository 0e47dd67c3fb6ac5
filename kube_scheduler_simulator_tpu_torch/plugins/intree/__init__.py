"""In-tree plugin implementations (upstream v1.26 semantics).

Each plugin implements the per-pod Python protocol from models.framework
(exact upstream messages and integer math — the parity oracle of the
sequential cycle); the batch engine computes the same plugins in the
scan kernel (``ops``).  The registry also holds the reference's
Coscheduling gang oracle (``gang/plugin.py``), enabled by name.
"""

from kube_scheduler_simulator_tpu_torch.plugins.intree.registry import (
    DEFAULT_PLUGIN_ORDER,
    DEFAULT_SCORE_WEIGHTS,
    in_tree_registry,
)

__all__ = ["in_tree_registry", "DEFAULT_PLUGIN_ORDER", "DEFAULT_SCORE_WEIGHTS"]
