"""Kernel-contract analysis, runtime side: the RecompileGuard.

:class:`RecompileGuard` asserts the zero-steady-state-builds contract: after
the warmup, no kernel library is built or loaded again (``runtime.py``).
The JAX package's static side (its AST rules over the tree) is not part of
the port yet.
"""

from kube_scheduler_simulator_tpu_torch.analysis.runtime import (  # noqa: F401
    RecompileError,
    RecompileGuard,
    compile_count,
)
