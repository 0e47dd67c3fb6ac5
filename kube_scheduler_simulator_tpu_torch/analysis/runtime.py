"""Runtime build discipline: build counting and the RecompileGuard.

A steady-state workload's contract is: after the warmup, the kernels are
only launched, never built or loaded again.  The port's kernels are shared
libraries that ``ops/kernels.build`` compiles (one ``nvcc`` per source whose
library is missing) and loads (``ctypes.CDLL``) once a process; both bump
``kernels.BUILDS``, so a build or load inside a guarded region means
something there dropped the process's libraries or started another process
that had to load them.  :class:`RecompileGuard` snapshots the count on
entry and asserts the delta on exit.

Usage::

    warmup()                        # the first round builds and loads
    with RecompileGuard("steady-state waves"):
        for _ in range(n):          # launches only
            step()

The fuzz sweep (``python -m kube_scheduler_simulator_tpu_torch.fuzz``)
runs every scenario after its first under ``RecompileGuard(max_compiles=0)``,
and each ProcessChaos child reports its own delta over its scenario.  On
the CPU the plain versions run and the count stays 0.
"""

from __future__ import annotations


def compile_count() -> int:
    """Monotone count of kernel library builds (each ``nvcc`` that
    ``kernels.build`` started) and loads (each ``ctypes.CDLL``) in this
    process."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels

    return kernels.BUILDS["nvcc"] + kernels.BUILDS["loads"]


class RecompileError(AssertionError):
    """A guarded region built or loaded a library when its contract said it
    must not."""


class RecompileGuard:
    """Assert at most ``max_compiles`` library builds and loads inside the
    block.

    ``name`` labels the violated contract in the error message.  Each
    instance snapshots independently, and the guard is usable as a plain
    counter: ``guard.compiles`` after exit holds the delta whether or not it
    raised; it raises only when the delta exceeds ``max_compiles``.
    """

    def __init__(self, name: str = "steady state", max_compiles: int = 0):
        self.name = name
        self.max_compiles = int(max_compiles)
        self.compiles = 0
        self._t0 = 0

    def __enter__(self) -> "RecompileGuard":
        self._t0 = compile_count()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.compiles = compile_count() - self._t0
        if exc_type is None and self.compiles > self.max_compiles:
            raise RecompileError(
                f"RecompileGuard({self.name!r}): {self.compiles} kernel library "
                f"build(s) or load(s) inside a region whose contract allows "
                f"{self.max_compiles}: something in the guarded path dropped the "
                "process's libraries (kernels._LIBS) or rebuilt them."
            )
        return False
