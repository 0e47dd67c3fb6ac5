"""The kernel-library cache: built kernel libraries kept on disk, so a
fresh process (or another checkout of the same sources) loads them instead
of running the compiler.

This is the port's counterpart of the JAX package's ``AotScanCache``
(``ops/aot.py`` there: ``jax.export`` artifacts of the lowered scan).  The
port has nothing to trace or lower: its device programs are the CUDA
libraries ``ops/kernels.build`` compiles from ``csrc/`` with ``nvcc``.  What
a fresh process pays is that build, so the cache keeps the built libraries.

One entry per library (``kernels.SOURCES``), in the cache directory:

- ``<name>.<sha>.so`` — the library, named after the first hex digits of
  its own sha256 (a library of other bytes never shares a path with one this
  process has loaded: ``dlopen`` returns a loaded library by its path);
- ``<name>.json`` — the sidecar: ``library`` (that file name), ``sha256``,
  ``kernel-digest`` (the digest of every source and the compiler flags that
  keys the library in the build directory), ``toolchain`` (the compiler's
  release line from ``<compiler> --version``: the counterpart of
  ``jax-version``) and ``platform`` (the card's compute capability and the
  ``-gencode`` target).

The cache can only make a build cheaper, never wronger:

- an entry that is not there counts as a **miss**;
- an entry that is there but rejected counts as a **fallback**, by the
  first sidecar field that differs from this process's (``kernel-digest``,
  ``toolchain``, ``platform``), or as ``corrupt`` (an unreadable sidecar, a
  library whose sha256 is not the sidecar's, a library or entry point that
  ``ctypes`` cannot load);
- a process that cannot run the compiler (a worker that loads and never
  builds, its ``nvcc`` off the path) cannot name its toolchain: it loads an
  entry whose other checks all pass (``kernel-digest``, which covers every
  source byte and the flags, ``platform``, ``sha256`` and every entry
  point), counted as a hit and as ``toolchain_unverified``; a compiler that
  runs and names another release still falls back by ``toolchain``;
- either way the caller builds the library (``kernels.build``: through the
  compile-cache directory, with the compiler where that has none) and saves
  it: the library first, then the sidecar, each through a temporary file
  and ``os.replace``, so a save killed half-way leaves a new library beside
  an old sidecar, which the next load rejects (counted) and the next save
  replaces; a save that fails counts ``save-error`` and never fails the
  build.

A library the compiler has just built that does not load is a build error
(``kernels.KernelBuildError``), never a fallback: only what comes out of the
cache falls back.

The reference's other reasons have no counterpart here: ``dtype-regime``
(one library serves float32 and float64: each has an entry point for both),
``mesh-spec`` (the port has no mesh yet), ``split-carry`` and
``export-unavailable`` (the port never donates a buffer, and there is
nothing to export: a built library is what is saved).  Nor has the
reference's committed ``aot_artifacts/`` directory, with its
``reference_scan_workload`` and ``reference_engine``: the port commits no
binary and builds every library from the repo's sources.

``KSS_AOT_CACHE_DIR`` turns the cache on (unset or empty: off, and
``kernels.build`` runs exactly as without this module).  The counters are
the process's (``stats``), not an engine's as in the reference: a library is
loaded once a process and serves every engine.

The compiler command, the toolchain and the platform are arguments of the
cache, so the same logic runs with ``gcc`` on a C source in tests.  The
toolchain (one ``<compiler> --version`` a process and compiler) and the
platform (a callable, for the kernels the card's compute capability) are
read only when an entry is checked or saved, so a process with the cache
off, or one that never builds, never starts the compiler or CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Iterable, Sequence

__all__ = [
    "FALLBACK_REASONS",
    "LibraryCache",
    "aot_cache_dir",
    "reset_stats",
    "stats",
    "toolchain_of",
]

# the sidecar fields a load checks, in this order: the first that differs
# names the fallback
SIDECAR_CHECKS = ("kernel-digest", "toolchain", "platform")
FALLBACK_REASONS = SIDECAR_CHECKS + ("corrupt", "save-error")

_MU = threading.Lock()
_COUNTS = {"hits": 0, "misses": 0, "saves": 0, "toolchain_unverified": 0}
_FALLBACKS: "dict[str, int]" = {}
_TOOLCHAINS: "dict[str, str | None]" = {}


def aot_cache_dir() -> "str | None":
    """The ``KSS_AOT_CACHE_DIR`` knob: a directory turns the cache on;
    unset or empty leaves it off."""
    d = os.environ.get("KSS_AOT_CACHE_DIR", "").strip()
    return d or None


def _count(key: str) -> None:
    with _MU:
        _COUNTS[key] += 1


def _fallback(reason: str) -> None:
    with _MU:
        _FALLBACKS[reason] = _FALLBACKS.get(reason, 0) + 1


# the counters ``SchedulerService.metrics()`` carries: the reference's keys
METRIC_KEYS = (
    "aot_cache_hits_total", "aot_cache_misses_total", "aot_cache_saves_total", "aot_cache_fallbacks_by_reason",
)


def stats() -> dict:
    """This process's cache counters under the reference's metric names,
    and the hits whose toolchain could not be checked
    (``aot_cache_toolchain_unverified_total``: no compiler ran)."""
    with _MU:
        return {
            "aot_cache_hits_total": _COUNTS["hits"],
            "aot_cache_misses_total": _COUNTS["misses"],
            "aot_cache_saves_total": _COUNTS["saves"],
            "aot_cache_fallbacks_by_reason": dict(_FALLBACKS),
            "aot_cache_toolchain_unverified_total": _COUNTS["toolchain_unverified"],
        }


def reset_stats() -> None:
    """Test hook: zero the process's counters."""
    with _MU:
        for k in _COUNTS:
            _COUNTS[k] = 0
        _FALLBACKS.clear()


def toolchain_of(compiler: str) -> "str | None":
    """The compiler's release line: the line of ``<compiler> --version``
    that names a release (nvcc's "Cuda compilation tools, release 12.4,
    V12.4.131"), else its first line; None when the compiler could not be
    run or printed nothing.  Run once a process and compiler."""
    with _MU:
        if compiler in _TOOLCHAINS:
            return _TOOLCHAINS[compiler]
    try:
        proc = subprocess.run([compiler, "--version"], capture_output=True, text=True, timeout=60)
        lines = [ln.strip() for ln in (proc.stdout or proc.stderr).splitlines() if ln.strip()]
    except (OSError, subprocess.SubprocessError):
        lines = []
    line = next((ln for ln in lines if "release" in ln), lines[0] if lines else None)
    with _MU:
        _TOOLCHAINS[compiler] = line
    return line


def _discard(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class LibraryCache:
    """Built libraries on disk, one entry per library name.

    ``compiler`` is the compile command's prefix (its first word is asked
    for ``--version``); ``platform`` the target the libraries run on, or a
    callable returning it, called at most once.  ``load`` returns a loaded
    library or None (counted); ``save`` stores a built one (counted, never
    raising)."""

    def __init__(self, cache_dir: "str | os.PathLike", compiler: Sequence[str],
                 platform: "str | Callable[[], str]"):
        self.cache_dir = str(cache_dir)
        self.compiler = tuple(compiler)
        self._platform = platform
        self._platform_value: "str | None" = None

    # ---------------------------------------------------------- identity

    def toolchain(self) -> "str | None":
        return toolchain_of(self.compiler[0])

    def platform(self) -> str:
        if self._platform_value is None:
            p = self._platform
            self._platform_value = str(p() if callable(p) else p)
        return self._platform_value

    def _current(self, field: str, digest: str) -> "str | None":
        if field == "kernel-digest":
            return digest
        return self.toolchain() if field == "toolchain" else self.platform()

    def sidecar_path(self, name: str) -> str:
        return os.path.join(self.cache_dir, f"{name}.json")

    def _read_sidecar(self, name: str) -> dict:
        with open(self.sidecar_path(name), "r", encoding="utf-8") as f:
            side = json.load(f)
        if not isinstance(side, dict) or not isinstance(side.get("library"), str):
            raise ValueError("not a library sidecar")
        return side

    # -------------------------------------------------------------- load

    def load(self, name: str, digest: str, entries: Iterable[str]) -> "ctypes.CDLL | None":
        """The cached library of ``name`` built under ``digest``, loaded with
        every entry point of ``entries`` resolved; None when there is no
        entry (a miss) or it is rejected (a fallback by reason)."""
        side_path = self.sidecar_path(name)
        if not os.path.exists(side_path):
            _count("misses")
            return None
        try:
            side = self._read_sidecar(name)
        except (OSError, ValueError):
            _fallback("corrupt")
            return None
        lib_path = os.path.join(self.cache_dir, os.path.basename(side["library"]))
        if not os.path.exists(lib_path):
            _count("misses")
            return None
        unverified = False
        for field in SIDECAR_CHECKS:
            current = self._current(field, digest)
            if current is None and field == "toolchain":
                unverified = True  # no compiler ran: the other checks decide
                continue
            if side.get(field) != current:
                _fallback(field)
                return None
        try:
            if _sha256(lib_path) != side.get("sha256"):
                _fallback("corrupt")
                return None
            lib = ctypes.CDLL(lib_path)
            for entry in entries:
                getattr(lib, entry)
        except (OSError, AttributeError):
            _fallback("corrupt")
            return None
        _count("hits")
        if unverified:
            _count("toolchain_unverified")
        return lib

    # -------------------------------------------------------------- save

    def save(self, name: str, digest: str, built: "str | os.PathLike") -> "str | None":
        """Store the library ``built`` (built under ``digest``) as the entry
        of ``name``; returns the cached library's path, or None when the
        save failed (counted ``save-error``).  An entry that already holds
        these bytes under this process's identity is kept as it is (no save
        counted); any other is replaced."""
        tmp = None
        try:
            sha = _sha256(str(built))
            meta = {f: self._current(f, digest) for f in SIDECAR_CHECKS}
            if meta["toolchain"] is None:
                raise ValueError("no toolchain to record: the compiler does not run here")
            lib_name = f"{name}.{sha[:16]}.so"
            lib_path = os.path.join(self.cache_dir, lib_name)
            old = None
            try:
                side = self._read_sidecar(name)
                if (side["library"] == lib_name and side.get("sha256") == sha
                        and all(side.get(f) == meta[f] for f in SIDECAR_CHECKS)
                        and os.path.exists(lib_path) and _sha256(lib_path) == sha):
                    return lib_path
                old = os.path.basename(side["library"])
            except (OSError, ValueError, KeyError):
                pass  # no entry, or one to replace
            os.makedirs(self.cache_dir, exist_ok=True)
            suffix = f".{os.getpid()}.{threading.get_ident()}.tmp"
            tmp = lib_path + suffix
            Path(tmp).write_bytes(Path(built).read_bytes())
            os.replace(tmp, lib_path)
            side_path = self.sidecar_path(name)
            tmp = side_path + suffix
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(dict(meta, library=lib_name, sha256=sha), f, indent=1, sort_keys=True)
            os.replace(tmp, side_path)
            tmp = None
            if old is not None and old != lib_name:
                # the replaced entry's library (a process that loaded it
                # keeps its mapping)
                _discard(os.path.join(self.cache_dir, old))
        except Exception:  # noqa: BLE001 - a save never fails the build
            if tmp is not None:
                _discard(tmp)
            _fallback("save-error")
            return None
        _count("saves")
        return lib_path
