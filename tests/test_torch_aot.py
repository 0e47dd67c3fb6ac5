"""The port's kernel-library cache (ops/aot.py) and the compile-cache
directory (``KSS_COMPILE_CACHE_DIR``), in the spirit of tests/test_aot.py.

``kernels.build`` runs here as on the card, with ``gcc`` in nvcc's place on
two C fixtures (``-x c`` reads the ``.cu`` names as C): a round trip loads
the same bytes, every fallback reason is counted and only that library is
rebuilt, a stale entry is refreshed, an unwritable cache never fails a
build, the knob unset is the path without the cache, a library just built
that does not load stays a ``KernelBuildError``, ``metrics()`` and
``/metrics`` read the counters, and nothing here initialises CUDA.  A
process that cannot run the compiler (a child with it off its path) loads
a valid entry, counted ``toolchain_unverified``, and still refuses a wrong
digest, platform or sha256; a compiler that runs and names another release
falls back ``toolchain``.  The platform is the bound card's (a test on the
card).  The
port's fallback reasons are the reference's, renamed as the module says.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import pytest

from kube_scheduler_simulator_tpu_torch.ops import aot
from kube_scheduler_simulator_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None, reason="needs gcc: the cache's logic runs on C fixtures")

SOURCES = {"alpha": "alpha.cu", "beta": "beta.cu"}
ENTRIES = {"alpha": {"kss_alpha": [ctypes.c_int]}, "beta": {"kss_beta": [ctypes.c_int]}}
FLAGS = ("-x", "c", "-shared", "-fPIC", "-O1")
PLATFORM = "fixture-platform; x86_64"
REAL_PLATFORM = K.cuda_platform


def c_source(entry: str, add: int) -> str:
    return f"int {entry}(int x) {{ return x + {add}; }}\n"


@pytest.fixture
def fx(tmp_path, monkeypatch):
    """``kernels`` pointed at the C fixtures: its sources, entries, flags,
    compiler and platform, with fresh counters (the process's own are put
    back after the test)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "alpha.cu").write_text(c_source("kss_alpha", 1))
    (csrc / "beta.cu").write_text(c_source("kss_beta", 2))
    monkeypatch.setattr(K, "CSRC", csrc)
    monkeypatch.setattr(K, "BUILD_DIR", csrc / "build")
    monkeypatch.setattr(K, "SOURCES", dict(SOURCES))
    monkeypatch.setattr(K, "ENTRIES", dict(ENTRIES))
    monkeypatch.setattr(K, "NVCC_FLAGS", FLAGS)
    monkeypatch.setattr(K, "_nvcc", lambda: "gcc")
    monkeypatch.setattr(K, "cuda_platform", lambda: PLATFORM)
    monkeypatch.setattr(K, "_LIBS", {})
    monkeypatch.setattr(K, "BUILDS", {"nvcc": 0, "loads": 0})
    monkeypatch.setattr(aot, "_COUNTS", {"hits": 0, "misses": 0, "saves": 0, "toolchain_unverified": 0})
    monkeypatch.setattr(aot, "_FALLBACKS", {})
    monkeypatch.setattr(aot, "_TOOLCHAINS", {})
    monkeypatch.delenv("KSS_AOT_CACHE_DIR", raising=False)
    monkeypatch.delenv("KSS_COMPILE_CACHE_DIR", raising=False)

    class Fixture:
        root = tmp_path
        cache = tmp_path / "cache"
        runs = 0

        def fresh_process(self, cache=True):
            """A new process's view: nothing loaded, an empty build
            directory, the cache knob set (or not); returns the libraries
            and the counts this build added."""
            self.runs += 1
            monkeypatch.setattr(K, "_LIBS", {})
            monkeypatch.setenv("KSS_COMPILE_CACHE_DIR", str(tmp_path / f"build-{self.runs}"))
            if cache:
                monkeypatch.setenv("KSS_AOT_CACHE_DIR", str(self.cache))
            else:
                monkeypatch.delenv("KSS_AOT_CACHE_DIR", raising=False)
            before, nvcc = aot.stats(), K.BUILDS["nvcc"]
            libs = K.build()
            after = aot.stats()
            delta = {k: after[k] - before[k] for k in after
                     if k not in ("aot_cache_fallbacks_by_reason", "aot_cache_toolchain_unverified_total")}
            fb = {r: n - before["aot_cache_fallbacks_by_reason"].get(r, 0)
                  for r, n in after["aot_cache_fallbacks_by_reason"].items()
                  if n != before["aot_cache_fallbacks_by_reason"].get(r, 0)}
            return libs, dict(delta, fallbacks=fb, nvcc=K.BUILDS["nvcc"] - nvcc)

        def sidecar(self, name):
            return json.loads((self.cache / f"{name}.json").read_text())

        def edit_sidecar(self, name, **fields):
            side = self.sidecar(name)
            side.update(fields)
            (self.cache / f"{name}.json").write_text(json.dumps(side))

        def cached_library(self, name) -> Path:
            return self.cache / self.sidecar(name)["library"]

    return Fixture()


def calls(libs) -> dict:
    return {"alpha": libs["alpha"].kss_alpha(40), "beta": libs["beta"].kss_beta(40)}


def counts(hits=0, misses=0, saves=0, nvcc=0, fallbacks=None) -> dict:
    return {"aot_cache_hits_total": hits, "aot_cache_misses_total": misses, "aot_cache_saves_total": saves,
            "nvcc": nvcc, "fallbacks": fallbacks or {}}


def test_a_round_trip_loads_the_same_bytes(fx):
    libs, got = fx.fresh_process()
    assert got == counts(misses=2, saves=2, nvcc=2)
    assert calls(libs) == {"alpha": 41, "beta": 42}
    for name, fn in SOURCES.items():
        built = K._lib_path(K.CSRC / fn)
        side = fx.sidecar(name)
        assert fx.cached_library(name).read_bytes() == built.read_bytes()
        assert side["kernel-digest"] == K.lib_digest(K.CSRC / fn) and side["platform"] == PLATFORM
        assert side["toolchain"] == aot.toolchain_of("gcc") and side["sha256"] == aot._sha256(str(built))
    libs, got = fx.fresh_process()
    assert got == counts(hits=2)
    assert calls(libs) == {"alpha": 41, "beta": 42}
    assert not any(K.build_dir().iterdir())  # nothing built, nothing copied
    assert K.BUILDS == {"nvcc": 2, "loads": 4}


TAMPER = {
    "kernel-digest": lambda fx: fx.edit_sidecar("alpha", **{"kernel-digest": "0" * 16}),
    "toolchain": lambda fx: fx.edit_sidecar("alpha", toolchain="gcc (another release) 1.0"),
    "platform": lambda fx: fx.edit_sidecar("alpha", platform="sm_80; arch=compute_80,code=sm_80"),
    "corrupt: a truncated library": lambda fx: fx.cached_library("alpha").write_bytes(
        fx.cached_library("alpha").read_bytes()[:100]),
    "corrupt: an unreadable sidecar": lambda fx: (fx.cache / "alpha.json").write_text("{not json"),
    "corrupt: a library without its entry point": lambda fx: swap_library(fx, "int kss_other(int x) { return x; }\n"),
}


def swap_library(fx, source: str) -> None:
    """Put a valid library without alpha's entry point in alpha's entry,
    its sha256 recorded, so only ``ctypes`` can tell."""
    src = fx.root / "other.c"
    src.write_text(source)
    out = fx.root / "other.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(out), str(src)], check=True)
    lib = fx.cached_library("alpha")
    lib.unlink()
    lib = fx.cache / "alpha.other.so"
    shutil.copyfile(out, lib)
    fx.edit_sidecar("alpha", library=lib.name, sha256=aot._sha256(str(lib)))


@pytest.mark.parametrize("case", sorted(TAMPER))
def test_each_fallback_reason_is_counted_and_only_that_library_rebuilt(fx, case):
    fx.fresh_process()
    TAMPER[case](fx)
    libs, got = fx.fresh_process()
    reason = case.split(":")[0]
    assert got == counts(hits=1, saves=1, nvcc=1, fallbacks={reason: 1})
    assert calls(libs) == {"alpha": 41, "beta": 42}
    assert [p.name for p in K.build_dir().iterdir() if p.suffix == ".so"] == [K._lib_path(K.CSRC / "alpha.cu").name]
    # the entry was saved again: the next process loads both
    libs, got = fx.fresh_process()
    assert got == counts(hits=2) and calls(libs) == {"alpha": 41, "beta": 42}


def test_a_stale_entry_is_refreshed_not_kept(fx):
    fx.fresh_process()
    old = fx.cached_library("alpha")
    (K.CSRC / "alpha.cu").write_text(c_source("kss_alpha", 100))
    libs, got = fx.fresh_process()
    # every library's digest covers every source: both entries are stale
    assert got == counts(saves=2, nvcc=2, fallbacks={"kernel-digest": 2})
    assert calls(libs) == {"alpha": 140, "beta": 42}
    assert not old.exists() and fx.cached_library("alpha") != old
    assert sorted(p.name for p in fx.cache.iterdir()) == sorted(
        ["alpha.json", "beta.json", fx.cached_library("alpha").name, fx.cached_library("beta").name])
    libs, got = fx.fresh_process()
    assert got == counts(hits=2) and calls(libs) == {"alpha": 140, "beta": 42}


def test_an_unwritable_cache_never_fails_a_build(fx):
    fx.cache = fx.root / "a-file"
    fx.cache.write_text("not a directory")
    libs, got = fx.fresh_process()
    assert got == counts(misses=2, nvcc=2, fallbacks={"save-error": 2})
    assert calls(libs) == {"alpha": 41, "beta": 42}
    assert sorted(p.name for p in fx.root.iterdir() if ".tmp" in p.name) == []


def test_the_knob_unset_builds_and_loads_as_before(fx, monkeypatch):
    assert aot.aot_cache_dir() is None and K.library_cache() is None
    monkeypatch.setenv("KSS_AOT_CACHE_DIR", "  ")
    assert aot.aot_cache_dir() is None
    libs, got = fx.fresh_process(cache=False)
    assert got == counts(nvcc=2)
    assert calls(libs) == {"alpha": 41, "beta": 42}
    assert not fx.cache.exists() and aot._TOOLCHAINS == {}
    # a second process over the same build directory loads, builds nothing
    monkeypatch.setattr(K, "_LIBS", {})
    K.build(compile=False)
    assert K.BUILDS == {"nvcc": 2, "loads": 4}


def test_a_library_just_built_that_does_not_load_is_a_build_error(fx, monkeypatch):
    (K.CSRC / "beta.cu").write_text("int kss_not_beta(int x) { return x; }\n")
    with pytest.raises(K.KernelBuildError, match="cannot load the library of csrc/beta.cu"):
        fx.fresh_process()
    assert aot.stats()["aot_cache_fallbacks_by_reason"] == {}
    assert not (fx.cache / "beta.json").exists()


def test_the_compile_cache_directory(fx, monkeypatch):
    monkeypatch.delenv("KSS_COMPILE_CACHE_DIR", raising=False)
    assert K.build_dir() == K.BUILD_DIR
    monkeypatch.setenv("KSS_COMPILE_CACHE_DIR", str(fx.root / "chosen"))
    K.build()
    assert sorted(p.name for p in (fx.root / "chosen").iterdir()) == sorted(
        K._lib_path(K.CSRC / fn).name for fn in SOURCES.values())
    monkeypatch.setattr(K, "_PRIVATE_BUILD_DIR", None)
    monkeypatch.setenv("KSS_COMPILE_CACHE_DIR", "0")
    private = K.build_dir()
    try:
        assert private == K.build_dir() and private.is_dir() and not any(private.iterdir())
        assert private not in (K.BUILD_DIR, fx.root / "chosen")
        # a child that may not compile finds nothing there ...
        monkeypatch.setattr(K, "_LIBS", {})
        with pytest.raises(K.KernelBuildError, match="build\\(compile=False\\)"):
            K.build(compile=False)
        # ... but loads from a warm library cache
        cache = K.library_cache(fx.cache)
        monkeypatch.setenv("KSS_COMPILE_CACHE_DIR", str(fx.root / "chosen"))
        assert all(K.save_libraries(cache).values())
        monkeypatch.setenv("KSS_COMPILE_CACHE_DIR", "0")
        monkeypatch.setenv("KSS_AOT_CACHE_DIR", str(fx.cache))
        nvcc = K.BUILDS["nvcc"]
        libs = K.build(compile=False)
        assert calls(libs) == {"alpha": 41, "beta": 42} and K.BUILDS["nvcc"] == nvcc
        assert aot.stats()["aot_cache_hits_total"] == 2 and aot.stats()["aot_cache_saves_total"] == 2
    finally:
        shutil.rmtree(private, ignore_errors=True)


def test_metrics_read_the_process_counters(fx):
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.server import DIContainer
    from kube_scheduler_simulator_tpu_torch.server.metrics import render_metrics
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    fx.fresh_process()
    fx.edit_sidecar("beta", platform="elsewhere")
    fx.fresh_process()
    svc = SchedulerService(ClusterStore(), device="cpu")
    svc.start_scheduler(None)
    m = svc.metrics()
    assert {k: m[k] for k in aot.METRIC_KEYS} == {k: aot.stats()[k] for k in aot.METRIC_KEYS} == {
        "aot_cache_hits_total": 1, "aot_cache_misses_total": 2, "aot_cache_saves_total": 3,
        "aot_cache_fallbacks_by_reason": {"platform": 1},
    }
    # the reference's keys only: the unverified hits stay in aot.stats()
    assert aot.stats()["aot_cache_toolchain_unverified_total"] == 0
    assert "aot_cache_toolchain_unverified_total" not in m
    text = render_metrics(DIContainer(device="cpu"))
    for line in ("aot_cache_hits_total 1", "aot_cache_misses_total 2", "aot_cache_saves_total 3",
                 'aot_cache_fallbacks_total{reason="platform"} 1'):
        assert f"simulator_{line}" in text.splitlines(), line
    assert "no such cache" not in text


def test_nothing_here_initialises_cuda(fx, monkeypatch):
    """The card's capability is read only by the kernels' platform callable,
    once a process, and only when the cache checks or saves an entry; the
    knob unset, a build and ``metrics()`` never reach it."""
    import torch

    asked = []

    def capability(*a):
        asked.append(a)
        return (9, 0)

    monkeypatch.setattr(torch.cuda, "get_device_capability", capability)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(K, "cuda_platform", REAL_PLATFORM)
    monkeypatch.setattr(K, "_PLATFORM", None)
    fx.fresh_process(cache=False)
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    SchedulerService(ClusterStore(), device="cpu").metrics()
    assert asked == [] and K._PLATFORM is None
    fx.fresh_process()
    fx.fresh_process()
    assert asked == [(0,)] and K._PLATFORM == "sm_90; " and fx.sidecar("alpha")["platform"] == "sm_90; "
    assert not torch.cuda.is_initialized()


def test_the_reasons_are_the_references_renamed():
    from kube_scheduler_simulator_tpu.ops import aot as ref

    renamed = {"jax-version": "toolchain", "platform": "platform", "kernel-digest": "kernel-digest",
               "corrupt": "corrupt", "export-error": "save-error"}
    no_counterpart = {"dtype-regime", "mesh-spec", "split-carry", "export-unavailable"}
    assert set(ref._SIDECAR_CHECKS) <= set(renamed) | no_counterpart
    assert set(renamed.values()) == set(aot.FALLBACK_REASONS)
    assert set(aot.SIDECAR_CHECKS) == {renamed[r] for r in ("kernel-digest", "jax-version", "platform")}
    doc = aot.__doc__
    assert all(r in doc for r in no_counterpart) and "aot_artifacts" in doc


# ------------------------------------------------ without the compiler

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
from kube_scheduler_simulator_tpu_torch.ops import aot
from kube_scheduler_simulator_tpu_torch.ops import kernels as K
K.CSRC = Path({csrc!r})
K.SOURCES = {sources!r}
K.ENTRIES = {{name: {{e: [K.ctypes.c_int] for e in es}} for name, es in {entries!r}.items()}}
K.NVCC_FLAGS = {flags!r}
K._nvcc = lambda: {compiler!r}
K.cuda_platform = lambda: {platform!r}
libs = K.build(compile=False)
print(json.dumps(dict(aot.stats(), builds=K.BUILDS, alpha=libs["alpha"].kss_alpha(40), beta=libs["beta"].kss_beta(40))))
"""


def child_build(fx, compiler: str) -> dict:
    """``kernels.build(compile=False)`` in a child process whose compiler is
    ``compiler``, over the fixtures' sources and ``fx.cache``, with an empty
    build directory: its cache counters, builds and the entries' results."""
    import os
    import sys

    build = fx.root / f"child-build-{fx.runs}"
    fx.runs += 1
    code = CHILD.format(root=str(Path(__file__).resolve().parent.parent), csrc=str(K.CSRC), sources=dict(SOURCES),
                        entries={n: list(e) for n, e in ENTRIES.items()}, flags=FLAGS, compiler=compiler,
                        platform=PLATFORM)
    env = dict(os.environ, KSS_AOT_CACHE_DIR=str(fx.cache), KSS_COMPILE_CACHE_DIR=str(build),
               PATH=str(fx.root / "no-compilers-here"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip().splitlines()[-1]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_process_without_the_compiler_loads_a_valid_entry(fx):
    fx.fresh_process()
    got = child_build(fx, "/nonexistent/cc")
    assert got["alpha"] == 41 and got["beta"] == 42, got
    assert got["aot_cache_hits_total"] == 2 and got["aot_cache_toolchain_unverified_total"] == 2, got
    assert got["aot_cache_fallbacks_by_reason"] == {} and got["aot_cache_misses_total"] == 0, got
    assert got["builds"] == {"nvcc": 0, "loads": 2} and got["aot_cache_saves_total"] == 0, got
    # a compiler that cannot be run has no toolchain (and nothing in this
    # process loaded unverified)
    assert aot.toolchain_of("/nonexistent/cc") is None and aot.stats()["aot_cache_toolchain_unverified_total"] == 0


NO_COMPILER_TAMPER = {r: TAMPER[r] for r in ("kernel-digest", "platform", "corrupt: a truncated library")}


@pytest.mark.parametrize("case", sorted(NO_COMPILER_TAMPER))
def test_without_the_compiler_the_other_checks_still_refuse(fx, case):
    fx.fresh_process()
    NO_COMPILER_TAMPER[case](fx)
    got = child_build(fx, "/nonexistent/cc")
    # alpha's entry is refused by its reason; with no library to load and
    # no compiler to build one, the child's build(compile=False) raises
    assert "KernelBuildError" in got["error"] and "csrc/alpha.cu" in got["error"], got
    cache = K.library_cache(fx.cache)
    cache.compiler = ("/nonexistent/cc",)
    before = aot.stats()["aot_cache_fallbacks_by_reason"]
    assert cache.load("alpha", K.lib_digest(K.CSRC / "alpha.cu"), ENTRIES["alpha"]) is None
    reason = case.split(":")[0]
    assert aot.stats()["aot_cache_fallbacks_by_reason"].get(reason, 0) == before.get(reason, 0) + 1
    assert aot.stats()["aot_cache_toolchain_unverified_total"] == 0


def test_a_compiler_that_runs_and_names_another_release_falls_back(fx):
    fx.fresh_process()
    fake = fx.root / "fakecc"
    fake.write_text("#!/bin/sh\necho 'fakecc (a release of its own) 9.9'\n")
    fake.chmod(0o755)
    cache = aot.LibraryCache(fx.cache, (str(fake), *FLAGS), PLATFORM)
    assert cache.load("alpha", K.lib_digest(K.CSRC / "alpha.cu"), ENTRIES["alpha"]) is None
    assert aot.stats()["aot_cache_fallbacks_by_reason"] == {"toolchain": 1}
    assert aot.stats()["aot_cache_toolchain_unverified_total"] == 0


def test_a_save_without_a_compiler_is_a_counted_save_error(fx):
    fx.fresh_process()
    cache = aot.LibraryCache(fx.root / "other-cache", ("/nonexistent/cc", *FLAGS), PLATFORM)
    assert cache.save("alpha", K.lib_digest(K.CSRC / "alpha.cu"), K._lib_path(K.CSRC / "alpha.cu")) is None
    assert aot.stats()["aot_cache_fallbacks_by_reason"] == {"save-error": 1}
    assert not (fx.root / "other-cache" / "alpha.json").exists()


@pytest.mark.gpu
def test_the_platform_is_the_bound_cards(monkeypatch):
    """``cuda_platform`` reads the card the process is bound to
    (``torch.cuda.current_device()``), not device 0."""
    if not torch_cuda_available():
        pytest.skip("needs an NVIDIA GPU: the platform is a card's compute capability")
    import torch

    monkeypatch.setattr(K, "_PLATFORM", None)
    last = torch.cuda.device_count() - 1
    with torch.cuda.device(last):
        major, minor = torch.cuda.get_device_capability(last)
        assert K.cuda_platform().startswith(f"sm_{major}{minor}; ")
    monkeypatch.setattr(K, "_PLATFORM", None)
    asked = []
    real = torch.cuda.get_device_capability
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: asked.append(d) or real(d))
    with torch.cuda.device(last):
        K.cuda_platform()
    assert asked == [last]


def torch_cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()
