"""Kernel-contract analysis: AST rules + runtime build discipline.

The static side (``run_analysis``) holds the port's tree to six rules —
KSS-DTYPE, KSS-HOST-SYNC, KSS-HOT-RENDER, KSS-PINNED, KSS-ENV, KSS-LOCK —
with every suppression justified in ``analysis/baseline.toml``
(framework.py says which rule is the reference's and which is re-targeted
to the port's contracts).  The runtime side (:class:`RecompileGuard`)
asserts the zero-steady-state-builds contract: after the warmup, no kernel
library is built or loaded again (``runtime.py``).  ``python -m
kube_scheduler_simulator_tpu_torch.analysis`` is the CLI (the reference's
``scripts/check_contracts.py``).
"""

from kube_scheduler_simulator_tpu_torch.analysis.framework import (  # noqa: F401
    BaselineError,
    Finding,
    apply_baseline,
    default_rules,
    load_baseline,
    render_report,
    run_analysis,
)
from kube_scheduler_simulator_tpu_torch.analysis.runtime import (  # noqa: F401
    RecompileError,
    RecompileGuard,
    compile_count,
)
