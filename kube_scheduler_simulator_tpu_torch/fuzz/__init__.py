"""Differential scenario fuzzer + chaos engine.

Every subsystem ships with a sequential oracle and a byte-parity bar, a
free differential-testing oracle.  This package (a port of the JAX
package's ``fuzz/``) is the engine that drives it:

- :mod:`fuzz.generator` + :mod:`fuzz.coverage` — seeded composite
  scenarios (gang x preemption x autoscale x churn x retune), sampled
  for structural diversity over coverage buckets;
- :mod:`fuzz.runner` + :mod:`fuzz.verdict` — each scenario executed
  through independent paths (batch vs sequential oracle, streamed vs
  serial, sharded vs single-device) with the full annotation trail
  diffed byte-for-byte; counted exactness-gate drains are explained
  routing, any byte mismatch is a divergence (the sharded comparison on
  a two-shard mesh; the streamed one over a mesh raises
  :class:`ShardNotPorted`);
- :mod:`fuzz.shrink` — deterministic minimization of diverging
  scenarios down to committed ``fuzz/fixtures/`` with exact expected
  bytes;
- :mod:`fuzz.chaos` — mid-run kernel-failure injection; the engines
  must degrade to the sequential path without committing a partial or
  divergent wave; process, disk and scan-ensemble worker faults.

``python -m kube_scheduler_simulator_tpu_torch.fuzz`` runs a bounded
seeded sweep on the card (``--device cpu`` on the CPU; ``__main__.py``);
the ``KSS_FUZZ_*`` knobs select seed, scenario budget, shrink budget and
the long-haul mode.
"""

from kube_scheduler_simulator_tpu_torch.fuzz.coverage import (
    FEATURES,
    MESH_STREAM,
    MIN_COMPOSE,
    CoverageMap,
)
from kube_scheduler_simulator_tpu_torch.fuzz.generator import generate_scenario
from kube_scheduler_simulator_tpu_torch.fuzz.runner import (
    DEFAULT_COMPARISONS,
    FuzzHarness,
    FuzzHarnessError,
    ShardNotPorted,
    encode_state,
    fuzz_knobs,
    run_differential,
)
from kube_scheduler_simulator_tpu_torch.fuzz.shrink import (
    FIXTURE_DIR,
    canonical_json,
    iter_fixture_paths,
    load_fixture,
    make_fixture,
    replay_fixture,
    shrink,
    write_fixture,
)
from kube_scheduler_simulator_tpu_torch.fuzz.chaos import (
    ChaosError,
    DiskChaos,
    FailoverChaos,
    KernelChaos,
    ProcessChaos,
    ProcessChaosError,
    WorkerChaos,
)

__all__ = [
    "FEATURES",
    "MESH_STREAM",
    "MIN_COMPOSE",
    "CoverageMap",
    "generate_scenario",
    "DEFAULT_COMPARISONS",
    "FuzzHarness",
    "FuzzHarnessError",
    "ShardNotPorted",
    "encode_state",
    "fuzz_knobs",
    "run_differential",
    "FIXTURE_DIR",
    "canonical_json",
    "iter_fixture_paths",
    "load_fixture",
    "make_fixture",
    "replay_fixture",
    "shrink",
    "write_fixture",
    "ChaosError",
    "DiskChaos",
    "FailoverChaos",
    "KernelChaos",
    "ProcessChaos",
    "ProcessChaosError",
    "WorkerChaos",
]
