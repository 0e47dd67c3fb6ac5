"""Process-wide kernel substrate shared by every tenant.

The port's copy of the JAX package's ``tenancy/substrate.py``, re-targeted.
The JAX registry dedupes the jit-wrapped executables engines build per
shape key, so the k+1-th tenant's first dispatch traces and compiles
nothing.  The port builds no executable per engine: its kernels are
compiled once per process into the libraries of ``ops/kernels.py``, and
what it derives per shape at run time is the compaction's launch plan.
So the registry's families here are what the port really resolves per
launch, process-wide:

- ``"kernel_entry"``: a scan library's entry point for one (library,
  dtype), resolved from the loaded kernel libraries (``kernels._entry``,
  read by every scan, lane, population and grad-forward launch);
- ``"compact_plan"``: the compaction's launch plan for one (manifest, N,
  W, WS, in-step width, profile) (``kernels.compact``, K3), whose
  process-wide store is ``kernels._COMPACT_PLANS``.

Each launch that resolves one of these while the registry is enabled is
one lookup: a hit when any engine in the process (the default session's,
a tenant's, a KEP-159/184 instance's) resolved the same key before, a
miss (then a publish) otherwise.  The protocol (``lookup``/``publish``,
refcounted ``enable``) and the counters are the reference's.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Hashable


class ExecutableSubstrate:
    """One process-wide table per family (kernel entry, compaction plan).

    ``lookup`` / ``publish`` are the whole protocol: engines look up
    before building and publish what they built.  ``publish`` keeps the
    FIRST entry on a race (two tenants tracing the same key
    concurrently) so every later caller converges on one object.

    The registry is an opt-in seam: it only engages while a session
    plane holds it enabled (refcounted — ``SessionManager`` construction
    enables, its ``close`` disables).  Disabled, ``lookup`` misses
    nothing and ``publish`` registers nothing, so a plain single-tenant
    process — and every existing test's engine — behaves byte-for-byte
    as before.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tables: dict[str, dict[Hashable, Any]] = {}
        self._enabled = 0
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------- gating

    def enable(self) -> None:
        with self._lock:
            self._enabled += 1

    def disable(self) -> None:
        with self._lock:
            self._enabled = max(0, self._enabled - 1)

    @property
    def enabled(self) -> bool:
        # lock-free: GIL-atomic read of an int refcount; a stale read only
        # routes one publish/lookup through the inert path, which is safe
        return self._enabled > 0

    # ----------------------------------------------------------- protocol

    def lookup(self, family: str, key: Hashable) -> Any:
        with self._lock:
            if not self._enabled:
                return None
            fn = self._tables.get(family, {}).get(key)
            if fn is None:
                self.misses += 1
            else:
                self.hits += 1
            return fn

    def publish(self, family: str, key: Hashable, fn: Any) -> Any:
        """Register ``fn`` under ``key``; returns the registered object
        (the first one to land, under a race)."""
        with self._lock:
            if not self._enabled:
                return fn
            table = self._tables.setdefault(family, {})
            return table.setdefault(key, fn)

    def get_or_build(self, family: str, key: Hashable, build: Callable[[], Any]) -> Any:
        fn = self.lookup(family, key)
        if fn is None:
            fn = self.publish(family, key, build())
        return fn

    def entries(self) -> int:
        with self._lock:
            return sum(len(t) for t in self._tables.values())

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "substrate_fn_hits_total": self.hits,
                "substrate_fn_misses_total": self.misses,
                "substrate_fn_entries": sum(len(t) for t in self._tables.values()),
            }

    def clear(self) -> None:
        """Test isolation only — a live process never drops entries."""
        with self._lock:
            self._tables.clear()
            self._enabled = 0
            self.hits = 0
            self.misses = 0


#: the process-wide registry every kernel launch consults
SUBSTRATE = ExecutableSubstrate()
