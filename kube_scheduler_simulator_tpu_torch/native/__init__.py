"""The C renderer of the annotation trail, compiled on first import.

``fastjson.c`` assembles the Go-json bytes of the annotation documents and
of the result history (escape, history splice, filter and score documents,
a whole commit wave's documents in a few calls) at memcpy speed; its module
is ``_kss_fastjson_torch``.  Every function has a pure-Python counterpart
in ``utils/gojson.py``, ``plugins/storereflector.py`` and
``scheduler/batch_engine.py`` that writes the same bytes: with no compiler,
a failed build or ``KSS_NO_NATIVE=1`` the package runs unchanged, slower.

The build is one ``cc -O2 -fPIC -shared -I <Python include>`` (~1 s) into
``native/build/`` (ignored by git), the file named by a hash of the source,
the flags and the interpreter, so a checkout never loads a stale library.
Concurrent first imports (test workers) each compile to a temporary name of
their own and rename it into place.  ``status()`` says whether the renderer
loaded, from where, and if not, why.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

MODULE = "_kss_fastjson_torch"
SOURCE = Path(__file__).resolve().parent / "fastjson.c"
BUILD_DIR = SOURCE.parent / "build"
CFLAGS = ("-O2", "-fPIC", "-shared")

fastjson = None
_status: dict = {}


def _include() -> str:
    return sysconfig.get_paths()["include"]


def library_path() -> Path:
    """Where the library of the current source, flags and interpreter lives."""
    tag = sys.implementation.cache_tag
    key = SOURCE.read_bytes() + " ".join(CFLAGS).encode() + _include().encode() + tag.encode()
    return BUILD_DIR / f"{MODULE}-{hashlib.sha256(key).hexdigest()[:16]}.{tag}.so"


def _build(cc: str, so: Path) -> "str | None":
    """Compile ``so`` unless it exists; returns why it could not, or None."""
    if so.exists():
        return None
    if shutil.which(cc) is None:
        return f"no compiler: {cc!r} is not on PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cc, *CFLAGS, "-I", _include(), str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr[-4000:]}"
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"{' '.join(cmd)} failed: {exc!r}"
    finally:
        if tmp.exists():
            tmp.unlink()
    _status["built"] = True
    return None


def _load() -> None:
    global fastjson
    cc = os.environ.get("CC", "cc")
    _status.update(loaded=False, path=None, reason=None, build_s=0.0, built=False, compiler=cc,
                   include=_include(), python_h=os.path.exists(os.path.join(_include(), "Python.h")))
    if os.environ.get("KSS_NO_NATIVE"):
        _status["reason"] = "KSS_NO_NATIVE is set: the Python renderer runs"
        return
    t0 = time.perf_counter()
    so = library_path()
    why = _build(cc, so)
    _status["build_s"] = time.perf_counter() - t0
    if why is not None:
        _status["reason"] = why
        return
    try:
        spec = importlib.util.spec_from_file_location(MODULE, so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except Exception as exc:  # a library the interpreter cannot load
        _status["reason"] = f"loading {so} failed: {exc!r}"
        return
    fastjson = mod
    _status.update(loaded=True, path=str(so))


def status() -> dict:
    """Whether the renderer loaded (``loaded``, ``path``), why not
    (``reason``: the compiler's message, no compiler, or KSS_NO_NATIVE),
    the build's seconds in this process and whether it compiled
    (``build_s``, ``built``), the compiler and the Python headers used."""
    return dict(_status)


_load()
