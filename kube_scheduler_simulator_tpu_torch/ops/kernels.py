"""The hand-written CUDA kernels of the batch round: build, binding, launch
counters and the wrappers.

- ``scan``    (csrc/scan.cu) — the whole pod loop of a round in one launch:
              the pairwise feature gathers, the fifteen filters, the rotated
              sampling prefix sum, the seven scores and their
              normalization, selection (first or reservoir), the commit
              of every carry (PodTopologySpread's counts, InterPodAffinity's
              term-group counts, host ports, conflict volumes, cloud-disk
              counts, CSI attachments) and, with ``ws0``, the score rows
              compacted in the step.  A launch may run one window of pods
              from a given initial carry (``offset``, ``window``,
              ``carry0``); it always hands on the whole final carry, so
              windows chain on the card.  One thread-block cluster of
              ``cluster_width(N, 1)`` blocks (csrc/scan_trace.cu with the
              trace on, csrc/scan_cluster.cu without);
              ``blocks=`` launches the redundant chains instead, for
              comparisons.
- ``scan_lanes`` (csrc/scan_masked.cu, K8) — the same kernel over G
              lanes in its masked mode, one block of ``lane_tile`` threads
              a lane on the grid's y axis: lane g runs the whole pod loop
              over its own rows (node_active = lane_active[g]) and writes
              its slices of the packed outputs and the final carries (the
              capacity engine's scale-up estimate: one node group a lane).
- ``scan_population`` (csrc/scan_cluster.cu, K9) — the same kernel over
              the rows of a [pop, S] weight matrix, one shared node mask:
              lane g is the whole rollout under weights[g] (the tuner's
              population).
- ``scan_grad_forward`` (csrc/scan_grad.cu, K2g) — the scan's grad mode:
              the one-lane rollout, folding the residual M [2, S, N] of the
              straight-through softmax head over the committed pods;
              ``grad_contract`` (csrc/tune.cu) contracts it with the
              objective's cotangent F [N,2] into d objective / d weights;
              ``scan_grad`` is the two.
- ``objective`` (csrc/tune.cu, part of K9) — each lane's final carry or
              selections reduced to its objective (utilization,
              fragmentation, pending_age) over a fixed pairwise tree, or
              (backward) the cotangent F.
- ``compact`` (csrc/compact.cu) — the trace planes → the manifest's byte
              blob in one launch: a warp a tile of the planes whose
              columns map to their sources by arithmetic (the fail
              planes, the score planes compacted in the scan's step),
              stored in words of up to 16 bytes; a block a row for the
              stable partition of the sampled mask (full score planes).
- ``scatter`` (csrc/scatter.cu) — ``buf[idx] = rows`` on a plane resident on
              the card: the DevicePlacer's row update.
- ``preempt`` (csrc/preempt.cu) — DefaultPreemption's victim search, one
              thread per (pod, node) lane: the lower slots, the fit with
              all of them removed, PDB violations by budget rank and the
              greedy reprieve (preemption/kernel.py holds its plain
              version).
- ``gang``    (csrc/gang.cu) — the gang round's per-window verdict (K6,
              one launch: placed and failed members per group by integer
              atomics in shared memory, the quorum test, distinct domains
              by a bitmap popcount, into one output buffer) and the
              PodGroup feasibility scan (K7: a warp or a block a group,
              each thread owning its nodes' state, a greedy slot loop
              with one redux.sync, and one barrier in a block, a slot,
              into one output buffer); gang/kernel.py holds their plain
              versions.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``csrc/build/`` (or the
``KSS_COMPILE_CACHE_DIR`` directory, ``build_dir``) keyed by a hash of the
sources and flags; the sources build in parallel.  With ``KSS_AOT_CACHE_DIR``
set, a library comes from the kernel-library cache (ops/aot.py) where it
holds a valid entry, and one built here is saved there.  The libraries are
loaded with ``ctypes``: every pointer and the stream travel as
``c_void_p``, the arguments as one struct whose fields are all 8 bytes
wide, and every entry point returns ``cudaGetLastError()``, which the
wrapper turns into an exception.

A wrapper takes CUDA tensors only: the plain versions in ops/batch.py and
preemption/kernel.py serve CPU tensors, and nothing here falls back to
them.  ``LAUNCHES`` counts the launches of each kernel, bumped only where
the kernel is launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

from kube_scheduler_simulator_tpu_torch.ops import aot
from kube_scheduler_simulator_tpu_torch.ops.batch import (
    CLOUD_LIMIT_COL,
    GOLDEN32,
    MASK32,
    BatchConfig,
    DeviceProblem,
    _mix32,
    check_lanes,
    check_slice,
    final_carry,
    in_step_width,
    log_table,
    plugin_gates,
    profile_weights,
    slice_pod_window,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = {
    "scan": "scan.cu", "scan_cluster": "scan_cluster.cu", "scan_trace": "scan_trace.cu", "scan_grad": "scan_grad.cu",
    "scan_masked": "scan_masked.cu",
    "scan_shard_trace": "scan_shard_trace.cu", "scan_shard_cluster": "scan_shard_cluster.cu",
    "scan_shard_masked": "scan_shard_masked.cu",
    "compact": "compact.cu", "scatter": "scatter.cu", "preempt": "preempt.cu", "gang": "gang.cu",
    "objective": "tune.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES = {
    "scan": 0, "scan_lanes": 0, "scan_sharded": 0, "scan_lanes_sharded": 0, "compact": 0, "scatter": 0, "preempt": 0,
    "gang_verdict": 0, "gang_feasibility": 0, "scan_population": 0, "objective": 0, "scan_grad": 0, "grad_contract": 0,
}

# the struct capacities of csrc/*.cu
MAXF, MAXS, MAXFR, MAXSHAPE, MAXSP, MAXC, MAXKU = 16, 8, 4, 16, 16, 8, 16
MAXMP = MAXSP + 2  # the compaction's mapped planes: two fail planes and the score planes
MAXR_PREEMPT = 16  # resource columns of a victim-search lane (csrc/preempt.cu)
# bytes of shared memory the scan may take for PodTopologySpread's domain
# sums; larger domain arrays go to per-block global scratch
DOM_SMEM_BYTES = 8192
# the scan's block width (csrc/scan.cu THREADS: one rank tile of nodes), the
# portable thread-block cluster size, the largest (non-portable) one the
# scan takes (csrc/scan.cu MAXCL), and the H100's SMs
SCAN_THREADS, MAX_CLUSTER, MAXCL, H100_SMS = 512, 8, 16, 132
# the masked lane scan's block widths (csrc/scan.cu MODE_MASKED), and the
# bytes of shared memory a lane's row list, flags, totals, raw scores and
# resource carries may take (else they stay in global scratch)
LANE_TILES = (64, 256, 512)
LANE_SMEM_BYTES = 160 * 1024
# bytes of shared memory a feasibility-scan block may take for its group's
# staged slots and, in the memory variants, its nodes' state (of the 227 KB
# an H100 block can have); a larger state goes to a per-group slice of
# global scratch
GANG_SMEM_BYTES = 200 * 1024
# the feasibility scan's kernel shapes (csrc/gang.cu launch_feasibility, in
# order): (threads a group, nodes a thread in registers), 0 nodes a thread
# for the state in memory; 32 threads is a warp a group, FEAS_GPB groups a
# block.  A register variant holds up to FEAS_RC resource columns (2 or 4),
# and every variant stages FEAS_SLOTS member slots at a time.  Built: the
# shapes that FEAS_TABLE picks (time_gang.py --variants on an H100 also
# timed 32 x 16, 128 x 8, 128 x 16, 256 x 16 and a memory variant of 256
# threads; none is the fastest at G 64 at any N swept).
FEAS_VARIANTS = ((32, 2), (32, 4), (32, 8), (256, 8), (512, 8), (512, 16), (512, 0))
FEAS_GPB, FEAS_RC, FEAS_SLOTS = 4, 4, 256
# the variant a scan takes, by dtype and by R up to 2 or up to FEAS_RC: (the
# largest N it serves, variant) in order; past the last, and past FEAS_RC
# columns, FEAS_MEM.  The fastest at G 64 x M 64 at each N of
# time_gang.py --variants (R 2; R 3 for the 4-column rows) on an H100; in
# float64 at 4 columns, 512 x 16 spills (and loses to FEAS_MEM at N 5 000).
FEAS_TABLE = {
    (torch.float32, 2): ((64, 0), (128, 1), (2048, 3), (4096, 4), (8192, 5)),
    (torch.float32, 4): ((64, 0), (128, 1), (2048, 3), (4096, 4), (8192, 5)),
    (torch.float64, 2): ((64, 0), (128, 1), (256, 2), (1024, 3), (4096, 4), (8192, 5)),
    (torch.float64, 4): ((64, 0), (128, 1), (512, 3), (4096, 4)),
}
FEAS_MEM = 6
# bytes of shared memory a window-verdict block takes for its groups'
# counters and domain bitmaps (the static limit: no attribute to set); more
# groups than fit take more blocks
VERDICT_SMEM_BYTES = 48 * 1024
_FILTER_IDS = {
    "NodeUnschedulable": 0,
    "NodeName": 1,
    "TaintToleration": 2,
    "NodeAffinity": 3,
    "NodeResourcesFit": 4,
    "PodTopologySpread": 5,
    "InterPodAffinity": 6,
    "NodePorts": 7,
    "VolumeRestrictions": 8,
    "EBSLimits": 9,
    "GCEPDLimits": 10,
    "AzureDiskLimits": 11,
    "NodeVolumeLimits": 12,
    "VolumeBinding": 13,
    "VolumeZone": 14,
}
_SCORE_IDS = {
    "NodeResourcesFit": 0,
    "NodeResourcesBalancedAllocation": 1,
    "ImageLocality": 2,
    "TaintToleration": 3,
    "NodeAffinity": 4,
    "PodTopologySpread": 5,
    "InterPodAffinity": 6,
}
_FIT_IDS = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}

_i64, _f64, _ptr = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p


class ScanArgs(ctypes.Structure):
    _fields_ = [
        (n, _i64) for n in (
            "P", "N", "R", "n_true", "sample_k", "start0", "tb_base", "seed_mix", "Psrc", "trace", "reservoir", "lanes",
            "na_stride", "w_stride", "grad", "cluster", "tile", "lane_smem", "nf",
        )
    ] + [
        ("filters", _i64 * MAXF),
        ("ns", _i64),
        ("scores", _i64 * MAXS),
        ("fit_strategy", _i64),
        ("n_fit_res", _i64),
        ("fit_col", _i64 * MAXFR),
        ("fit_w", _f64 * MAXFR),
        ("fit_wsum", _f64),
        ("n_shape", _i64),
        ("shape_u", _i64 * MAXSHAPE),
        ("shape_s", _i64 * MAXSHAPE),
        ("T_cols", _i64),
        ("M_cols", _i64),
        ("MP_cols", _i64),
        ("MC_cols", _i64),
    ] + [
        (n, _i64) for n in (
            "use_spread_f", "use_spread_s", "use_ipa",
            "KC", "KS", "KA", "KB", "KP", "KO", "KM", "SG", "G", "D", "dom_cap", "dom_smem",
        )
    ] + [
        ("key_base", _i64 * MAXKU),
        ("key_size", _i64 * MAXKU),
    ] + [
        (n, _i64) for n in (
            "ws0", "use_ports", "use_restr", "use_cloud", "use_csi",
            "PT", "VR", "VID", "DR", "KPT", "KVR", "KV", "VB_cols",
        )
    ] + [
        ("cloud_limit", _f64 * 3),
        ("tau", _f64),
    ] + [
        (n, _ptr)
        for n in (
            "alloc", "max_pods", "nz_alloc", "pod_req", "pod_nonzero", "fit_checked",
            "taint_cls", "taint_prefer_cls", "taint_unsched_cls", "pod_tol_idx",
            "node_taint_idx", "node_unsched", "aff_code_cls", "aff_pref_cls",
            "pod_aff_idx", "pod_pref_idx", "node_label_idx", "img_cls", "pod_img_idx",
            "node_img_idx", "name_target", "pod_active", "node_active",
            "incl_cls", "node_domain",
            "spf_key", "spf_grp", "spf_ku", "spf_skew", "spf_self",
            "sps_key", "sps_grp", "sps_ku", "sps_skew", "spread_match",
            "gdom", "term_match", "ip_match_g", "ip_aff_g", "ip_anti_g", "ip_pref_g", "ip_pref_w",
            "ip_own_g", "ip_own_w", "ip_self_match",
            "port_cols", "port_conflict", "restr_cols", "restr_conflict", "cloud_cnt", "csi_cols", "csi_drv",
            "csi_seed_used", "csi_limit", "vb_cls", "vz_cls", "pod_vol_idx", "log_table", "weights", "resid",
            "requested0", "nonzero0", "pod_count0", "spread_counts0", "ip_sel0", "ip_own0", "ip_anti0",
            "ports_used0", "restr_used0", "cloud_used0", "csi_attached0", "start_ptr",
            "s_requested", "s_nonzero", "s_pod_count", "s_spread", "s_ip_sel", "s_ip_own", "s_ip_anti",
            "s_raw_spread", "s_raw_ipa", "s_dom", "s_domflag", "s_total", "s_flags",
            "s_rank", "s_ports", "s_restr", "s_cloud", "s_csi", "s_csi_cnt", "s_norm",
            "packed", "final_start", "final_requested", "final_nonzero", "final_pod_count",
            "final_ports_used", "final_restr_used", "final_cloud_used", "final_csi_att",
            "final_spread", "final_ip_sel", "final_ip_own", "final_ip_anti",
            "fail_plug", "fail_code", "feasible",
        )
    ] + [
        ("raw", _ptr * MAXS),
        ("norm", _ptr * MAXS),
        ("trace_meta", _ptr),
    ] + [
        (n, _i64) for n in ("shards", "shard", "node_off", "N_glob", "slot_bytes", "spin_cap")
    ] + [
        (n, _ptr) for n in ("mbox_flags", "mbox", "mbox_err", "xwait")
    ]


class CompactArgs(ctypes.Structure):
    _fields_ = [
        (n, _i64) for n in (
            "P", "N", "n_true", "WS", "ws0", "filters", "off_sids", "rows", "n_sp", "n_mp", "map_tiles", "w_sids",
        )
    ] + [
        (n, _i64 * MAXSP) for n in ("sp_off", "sp_nb", "sp_w")
    ] + [
        (n, _i64 * MAXMP) for n in ("mp_kind", "mp_src", "mp_width", "mp_nb", "mp_vec", "mp_off", "mp_tiles", "mp_first")
    ] + [
        ("sp_src", _ptr * MAXSP),
    ] + [
        (n, _ptr) for n in (
            "fail_plug", "fail_code", "feasible", "sample_start", "sample_processed", "feasible_count", "blob",
        )
    ]


PREEMPT_TENSORS = (
    "ucand", "ureq", "uprio", "smask", "sreq", "snode", "alloc", "base_req", "extra_req", "base_cnt",
    "extra_cnt", "max_pods", "vreq", "vprio", "vvalid", "vmatch", "allowed",
)


class ObjArgs(ctypes.Structure):
    _fields_ = [(n, _i64) for n in ("L", "N", "P", "kind", "backward", "pw")] + [
        (n, _ptr) for n in ("used", "nz_alloc", "node_active", "selected", "pod_active", "age_w", "scratch", "value", "F")
    ]


class ContractArgs(ctypes.Structure):
    _fields_ = [(n, _i64) for n in ("S", "N", "pw")] + [("tau", _f64)] + [
        (n, _ptr) for n in ("F", "M", "scratch", "dw")
    ]


# the objective kernel's kinds (csrc/tune.cu)
OBJECTIVE_IDS = {"utilization": 0, "fragmentation": 1, "pending_age": 2}


class PreemptArgs(ctypes.Structure):
    _fields_ = [(n, _i64) for n in ("U", "N", "V", "R", "PDB", "S")] + [
        (n, _ptr) for n in PREEMPT_TENSORS + ("cand", "victims", "viol", "slist")
    ]


class GangVerdictArgs(ctypes.Structure):
    _fields_ = [(n, _i64) for n in ("K", "G", "N", "D", "W", "gb")] + [
        (n, _ptr) for n in ("gid", "node", "dom", "prior_bound", "min_member", "distinct", "placed", "feasible")
    ]


class GangFeasArgs(ctypes.Structure):
    _fields_ = [(n, _i64) for n in ("G", "M", "N", "R", "variant", "mc", "smem")] + [
        (n, _ptr) for n in ("req", "valid", "free", "cnt_free", "dom", "scratch", "feasible", "distinct", "assignment")
    ]


# each library's extern "C" entry points and their argument types
ENTRIES = {
    **{lib: {f"kss_{lib}_{d}": [_ptr, _i64, _ptr] for d in ("f32", "f64")}
       for lib in ("scan", "scan_cluster", "scan_trace", "scan_grad", "scan_masked")},
    **{lib: {**{f"kss_{lib}_{d}": [_ptr, _ptr, _i64, _i64, _ptr] for d in ("f32", "f64")},
            f"kss_{lib}_peer": [_i64, _i64]}
       for lib in ("scan_shard_trace", "scan_shard_cluster", "scan_shard_masked")},
    "compact": {f"kss_compact_{d}": [_ptr, _ptr] for d in ("f32", "f64")},
    "scatter": {"kss_scatter_rows": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _ptr]},
    "preempt": {f"kss_preempt_{d}": [_ptr, _ptr] for d in ("f32", "f64")},
    "gang": {f"kss_gang_{e}": [_ptr, _ptr] for e in ("verdict", "feasibility_f32", "feasibility_f64")},
    "objective": {f"kss_{e}_{d}": [_ptr, _ptr] for e in ("objective", "contract") for d in ("f32", "f64")},
}

_LIBS: "dict[str, ctypes.CDLL]" = {}
build_seconds = 0.0
# every nvcc that build() started and every library it loaded, since the
# process started (analysis/runtime.compile_count reads their sum)
BUILDS = {"nvcc": 0, "loads": 0}


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded (nvcc missing or
    failing, a library missing where ``build(compile=False)`` may not
    compile it, a library or entry point that does not load).  Never
    degraded to the sequential cycle: ``degradable`` lets it propagate."""


class KernelLaunchError(RuntimeError):
    """A wrapper's own failure on the card: a launch that returned a
    cudaError (an invalid configuration, too many resources).  Never
    degraded: a kernel that does not launch must not turn its rounds into
    host rounds."""


class KernelArgumentError(KernelLaunchError, ValueError):
    """A wrapper refused its arguments (a CPU or non-contiguous tensor, a
    dtype or shape the kernel does not take, a problem past its capacity).
    Never degraded, as ``KernelLaunchError``."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    return "nvcc"


def build_dir() -> Path:
    """The directory ``build`` compiles into and loads from, by the
    ``KSS_COMPILE_CACHE_DIR`` knob (the reference's persistent compilation
    cache): unset or empty, ``BUILD_DIR`` (csrc/build/, which .gitignore
    lists); a path, that directory; ``0``, a temporary directory of this
    process (removed at its exit), so every process compiles afresh.  A
    child that loads with ``build(compile=False)`` reads the same knob."""
    global _PRIVATE_BUILD_DIR
    d = os.environ.get("KSS_COMPILE_CACHE_DIR", "").strip()
    if d != "0":
        return Path(d) if d else BUILD_DIR
    if _PRIVATE_BUILD_DIR is None:
        import atexit
        import shutil
        import tempfile

        _PRIVATE_BUILD_DIR = Path(tempfile.mkdtemp(prefix="kss-kernels-"))
        atexit.register(shutil.rmtree, str(_PRIVATE_BUILD_DIR), True)
    return _PRIVATE_BUILD_DIR


_PRIVATE_BUILD_DIR: "Path | None" = None


def lib_digest(src: Path) -> str:
    """The key of ``src``'s library: a hash of every source (scan_cluster.cu,
    scan_trace.cu and scan_grad.cu include scan.cu), its name and the
    flags."""
    key = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cu"))) + src.name.encode()
    return hashlib.sha256(key + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def _lib_path(src: Path, directory: "Path | None" = None) -> Path:
    """The library of ``src`` in the build directory, keyed by its digest."""
    return (directory or build_dir()) / f"{src.stem}-{lib_digest(src)}.so"


_PLATFORM: "str | None" = None


def cuda_platform() -> str:
    """The compute capability of the card this process is bound to
    (``torch.cuda.current_device()``) and the ``-gencode`` target the
    libraries are built for (the kernel-library cache's ``platform``), read
    once a process and only when the cache checks or saves an entry."""
    global _PLATFORM
    if _PLATFORM is None:
        gencode = next((NVCC_FLAGS[i + 1] for i, f in enumerate(NVCC_FLAGS[:-1]) if f == "-gencode"), "")
        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(torch.cuda.current_device())
            _PLATFORM = f"sm_{major}{minor}; {gencode}"
        else:
            _PLATFORM = f"no device; {gencode}"
    return _PLATFORM


def library_cache(cache_dir: "str | os.PathLike | None" = None) -> "aot.LibraryCache | None":
    """The kernel-library cache in ``cache_dir``, by default the
    ``KSS_AOT_CACHE_DIR`` knob's directory (None when it is unset)."""
    d = aot.aot_cache_dir() if cache_dir is None else str(cache_dir)
    if d is None:
        return None
    return aot.LibraryCache(d, (_nvcc(), *NVCC_FLAGS), cuda_platform)


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    for entry, argtypes in ENTRIES[name].items():
        f = getattr(lib, entry)
        f.restype = ctypes.c_int
        f.argtypes = argtypes
    return lib


def build(compile: bool = True) -> "dict[str, ctypes.CDLL]":
    """Compile every kernel source that has no library for its current hash
    (one ``nvcc`` per source, all started together), then load them.  With
    ``compile=False`` a missing library raises instead (a child process
    loads what its parent built).  Every failure is a ``KernelBuildError``.

    With the kernel-library cache on (``KSS_AOT_CACHE_DIR``, ops/aot.py) a
    library comes from the cache where its entry is valid; a missing or
    rejected entry (counted) takes the path above, and the library is then
    saved into the cache.  A library built here that does not load stays a
    ``KernelBuildError``."""
    global build_seconds
    if len(_LIBS) == len(SOURCES):
        return _LIBS
    t0 = time.perf_counter()
    bdir = build_dir()
    cache = library_cache()
    loaded: "dict[str, ctypes.CDLL]" = {}
    if cache is not None:
        for name, fn in SOURCES.items():
            lib = cache.load(name, lib_digest(CSRC / fn), ENTRIES[name])
            if lib is not None:
                BUILDS["loads"] += 1
                loaded[name] = _bind(lib, name)
    bdir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, fn in SOURCES.items():
        src = CSRC / fn
        out = _lib_path(src, bdir)
        if name in loaded or out.exists():
            continue
        if not compile:
            raise KernelBuildError(f"no library for csrc/{fn} in {bdir} (build(compile=False))")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        except OSError as exc:
            raise KernelBuildError(f"cannot start nvcc for csrc/{fn}: {exc}") from exc
        BUILDS["nvcc"] += 1
        jobs[name] = (proc, tmp, out)
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed for csrc/{SOURCES[name]}:\n{log.decode(errors='replace')}")
        os.replace(tmp, out)
    for name, fn in SOURCES.items():
        if name in loaded:
            continue
        path = _lib_path(CSRC / fn, bdir)
        try:
            lib = _bind(ctypes.CDLL(str(path)), name)
            BUILDS["loads"] += 1
        except (OSError, AttributeError) as exc:
            raise KernelBuildError(f"cannot load the library of csrc/{fn}: {exc}") from exc
        loaded[name] = lib
        if cache is not None:
            cache.save(name, lib_digest(CSRC / fn), path)
    _LIBS.update(loaded)
    build_seconds = time.perf_counter() - t0
    return _LIBS


def save_libraries(cache: "aot.LibraryCache") -> "dict[str, str | None]":
    """Save every library this process loaded (after a ``build``: from the
    build directory or from another cache), else the build directory's,
    into ``cache``: the cached paths by library name, None where a save
    failed."""
    return {
        name: cache.save(name, lib_digest(CSRC / fn), _LIBS[name]._name if name in _LIBS else _lib_path(CSRC / fn))
        for name, fn in SOURCES.items()
    }


# every kernel error this process degraded, by "<site>: kernel error: <type>"
# (site: round, stream or estimate); chip_smoke.py fails a phase that adds one
DEGRADES: "dict[str, int]" = {}
_DEGRADES_MU = threading.Lock()


def degradable(err: BaseException, device: "str | torch.device", site: str) -> bool:
    """May a round, a streamed wave or an estimate (``site``) that raised
    ``err`` finish on the sequential cycle (or the estimator's resource-only
    first-fit)?  Never for a library build or load error, nor for a
    wrapper's own failure (``KernelLaunchError``: a launch's cudaError, an
    argument the kernel refuses), and on the card only while its CUDA
    context still answers a ``synchronize``: a lost context keeps the
    original error, so a dead card never turns later rounds into quiet host
    rounds.  What degrades is raised above the wrappers (a host fault, the
    engine-boundary ``ChaosError`` of fuzz/chaos.py).  A yes is counted in
    ``DEGRADES``."""
    if isinstance(err, (KernelBuildError, KernelLaunchError)):
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        try:
            torch.cuda.synchronize(dev)
        except Exception:  # noqa: BLE001 - any failure here means the context is gone
            return False
    key = f"{site}: kernel error: {type(err).__name__}"
    with _DEGRADES_MU:
        DEGRADES[key] = DEGRADES.get(key, 0) + 1
    return True


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t: torch.Tensor, name: str, dtype: "torch.dtype | None" = None) -> int:
    if not t.is_cuda:
        raise KernelArgumentError(f"{name} must be a CUDA tensor (the plain versions serve CPU tensors)")
    if not t.is_contiguous():
        raise KernelArgumentError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise KernelArgumentError(f"{name} must be {dtype}, got {t.dtype}")
    return t.data_ptr()


def _substrate():
    from kube_scheduler_simulator_tpu_torch.tenancy.substrate import SUBSTRATE

    return SUBSTRATE


def _entry(lib: str, dt: torch.dtype):
    """A scan library's entry for ``dt``, resolved through the tenants'
    substrate (``tenancy/substrate.py``, family "kernel_entry")."""
    if dt not in (torch.float32, torch.float64):
        raise KernelArgumentError(f"kernels take float32 or float64 problems, got {dt}")
    sub = _substrate()
    fn = sub.lookup("kernel_entry", (lib, dt))
    if fn is None:
        fn = sub.publish(
            "kernel_entry", (lib, dt), getattr(build()[lib], f"kss_{lib}_{'f32' if dt == torch.float32 else 'f64'}")
        )
    return fn


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelLaunchError(f"{what} kernel launch failed: {torch.cuda.get_device_name()} cudaError {rc}")


def domain_layout(dims: dict, dt: torch.dtype) -> "tuple[int, bool]":
    """(domains per PodTopologySpread constraint slot, whether the slots fit
    the scan's shared memory): a slot holds the per-domain sums and flags
    of the largest interned key; identity keys need none."""
    cap = max((size for kind, _base, size in dims["key_struct"] if kind != "identity"), default=0)
    slot_bytes = (dims["KC"] + dims["KS"]) * cap * (torch.empty((), dtype=dt, device="cpu").element_size() + 4)
    return cap, slot_bytes <= DOM_SMEM_BYTES


def cluster_width(N: int, lanes: int) -> int:
    """Blocks of each lane's thread-block cluster (every scan launch but
    the redundant chains): one a rank tile of the N nodes, at most 16 for
    one lane (a non-portable size) and 8 for several, which share the
    H100's 132 SMs; then the fewest blocks that keep the most tiles a block
    walks (10 tiles: 10 blocks for one lane, 5 for several); 1 where a lane
    has at most two tiles (there a cluster's barriers cost more than the
    tile they save).  PERF.md §6 has the card's times of each choice."""
    tiles = -(-N // SCAN_THREADS)
    if tiles <= 2:
        return 1
    top = MAXCL if lanes == 1 else max(1, min(MAX_CLUSTER, H100_SMS // lanes))
    per_block = -(-tiles // min(top, tiles))
    return -(-tiles // per_block)


def scan(
    cfg: BatchConfig, dims: dict, dp: DeviceProblem, blocks: "int | None" = None, ws0: "int | None" = None,
    carry0: "dict | None" = None, offset: int = 0, window: "int | None" = None,
    weights: "torch.Tensor | None" = None, cluster: "int | None" = None,
) -> dict:
    """Launch the scan kernel on a problem on the card; returns the outputs
    of ops/batch.scan_plain under the same keys (``ws0``, ``carry0``,
    ``offset``, ``window`` and ``weights`` as there: with ``window`` the
    launch runs pods [offset, offset + window) from ``carry0``, whose
    ``start0`` may be the previous window's ``final_start`` on the card).
    One thread-block cluster of ``cluster`` (default ``cluster_width(N,
    1)``) blocks walks the pod chain; ``blocks`` instead launches that many
    blocks, each running the whole chain on its own carry copy and writing
    its share of the trace rows: the earlier design, kept for comparisons
    (chip_smoke.py, time_scan.py), never chosen on the service's path.  A
    launch over no pods (P = 0, or an empty window) is refused: no caller
    makes one (the service, the background loop and a scenario's
    convergence pass return before the engine on an empty queue), and the
    kernel's trace meta of an empty round is not held against the plain
    version's."""
    if (dims["P"] if window is None else window) <= 0:
        raise KernelArgumentError(f"a scan over no pods (P={dims['P']}, window={window}): nothing to launch")
    out = _launch_scan(cfg, dims, dp, blocks, ws0, carry0, offset, window, weights=weights, cluster=cluster)
    LAUNCHES["scan"] += 1
    return out


def lane_tile(widest: int) -> int:
    """Threads of a masked lane block (K8): the narrowest of LANE_TILES that
    holds the widest lane's active rows in one tile, 512 past it (a wider
    lane walks several tiles).  A function of the shape; on the card
    (time_lanes.py --tiles, PERF.md §6) 64 wins at 64 rows a lane, 256 at
    200, 512 at 500 and 1 000; 128 won at none, so it is not built."""
    return next((t for t in LANE_TILES if t >= widest), LANE_TILES[-1])


def scan_lanes(
    cfg: BatchConfig, dims: dict, dp: DeviceProblem, lane_active: torch.Tensor, widest: "int | None" = None,
) -> dict:
    """Launch the scan kernel over G lanes (K8) on a problem on the card,
    lane g with ``node_active = lane_active[g]`` (a contiguous CUDA bool
    [G, N]), in its masked mode: one block of ``lane_tile(widest)`` threads
    a lane walks the lane's own rows.  ``widest``: the most active rows of
    any lane, as the caller knows it (None: read from the mask, which waits
    for the card; tests and timing force a tile t of LANE_TILES by
    ``widest=t``: a lane wider than its tile walks several).  Returns the
    outputs of ops/batch.scan_lanes_plain under the same keys, each with a
    leading lane axis.  The trace is off: the estimator reads decisions, not
    annotations."""
    check_lanes(cfg, dims, lane_active)
    _check(lane_active, "lane_active", torch.bool)
    if widest is None:
        widest = int(lane_active.sum(dim=1).max())
    out = _launch_scan(cfg, dims, dp, None, None, None, 0, None, lane_active=lane_active, tile=lane_tile(widest))
    LAUNCHES["scan_lanes"] += 1
    return out


def scan_population(cfg: BatchConfig, dims: dict, dp: DeviceProblem, weights: torch.Tensor) -> dict:
    """Launch the scan kernel over the rows of a [G, S] weight matrix (K9)
    on a problem on the card, every lane on the problem's own node_active:
    lane g is the rollout under ``weights[g]``, a cluster of
    ``cluster_width(N, G)`` blocks.  Returns the outputs of
    ops/batch.scan_lanes_plain(weights=) under the same keys, each with a
    leading lane axis.  Trace off."""
    check_lanes(cfg, dims, None, weights)
    _check(weights, "weights", dp.alloc.dtype)
    out = _launch_scan(cfg, dims, dp, None, None, None, 0, None, weights=weights)
    LAUNCHES["scan_population"] += 1
    return out


def scan_grad_forward(
    cfg: BatchConfig, dims: dict, dp: DeviceProblem, weights: torch.Tensor, tau: float,
) -> "tuple[torch.Tensor, dict]":
    """Launch the scan's grad mode (K2g's forward) on a problem on the card:
    (the residual M [2, S, N] float64, the hard rollout's outputs), as
    ops/batch.grad_residual_plain.  ``weights`` [S] in the problem's dtype;
    one lane, a cluster of ``cluster_width(N, 1)`` blocks, trace off."""
    if weights.shape != (len(cfg.scores),):
        raise KernelArgumentError(f"weights must be [{len(cfg.scores)}], got {tuple(weights.shape)}")
    if not tau > 0:
        raise KernelArgumentError(f"tau must be positive, got {tau}")
    out = _launch_scan(cfg._replace(trace=False), dims, dp, None, None, None, 0, None, weights=weights, grad=tau)
    LAUNCHES["scan_grad"] += 1
    return out.pop("resid"), out


def grad_contract(M: torch.Tensor, F: torch.Tensor, tau: float) -> torch.Tensor:
    """Launch K2g's contraction (csrc/tune.cu) on the card: d objective / d
    weights [S] float64 from the grad forward's residual ``M`` [2, S, N]
    float64 and the objective's cotangent ``F`` [N, 2], as
    ops/batch.grad_contract_plain (bitwise: the same products over the same
    tree)."""
    if M.dim() != 3 or M.shape[0] != 2 or F.shape != (M.shape[2], 2):
        raise KernelArgumentError(f"M must be [2, S, N] and F [N, 2], got {tuple(M.shape)} and {tuple(F.shape)}")
    if not tau > 0:
        raise KernelArgumentError(f"tau must be positive, got {tau}")
    S, N = M.shape[1], M.shape[2]
    a = ContractArgs()
    a.M = _check(M, "M", torch.float64)
    a.F = _check(F, "F")
    if F.dtype not in (torch.float32, torch.float64):
        raise KernelArgumentError(f"F must be float32 or float64, got {F.dtype}")
    fn = getattr(build()["objective"], f"kss_contract_{'f32' if F.dtype == torch.float32 else 'f64'}")
    pw = 1 << max(2 * N - 1, 0).bit_length()
    scratch = torch.empty((S, pw), dtype=torch.float64, device=M.device)
    dw = torch.empty(S, dtype=torch.float64, device=M.device)
    a.S, a.N, a.pw, a.tau = S, N, pw, float(tau)
    a.scratch, a.dw = scratch.data_ptr(), dw.data_ptr()
    rc = fn(ctypes.byref(a), torch.cuda.current_stream(M.device).cuda_stream)
    _raise_on(rc, "grad contraction")
    LAUNCHES["grad_contract"] += 1
    return dw


def scan_grad(
    cfg: BatchConfig, dims: dict, dp: DeviceProblem, weights: torch.Tensor, F: torch.Tensor, tau: float,
) -> "tuple[torch.Tensor, dict]":
    """K2g on a problem on the card: (d objective / d weights [S] float64,
    the hard rollout's outputs), as ops/batch.grad_plain (whose docstring
    gives the formula): the grad forward, then the contraction with ``F``
    [N, 2] (d objective / d final_nonzero, the problem's dtype)."""
    if F.shape != (dims["N"], 2):
        raise KernelArgumentError(f"F must be [{dims['N']}, 2], got {tuple(F.shape)}")
    _check(F, "F", dp.alloc.dtype)
    M, out = scan_grad_forward(cfg, dims, dp, weights, tau)
    return grad_contract(M, F, tau), out


def objective(
    name: str, final_nonzero: torch.Tensor, selected: torch.Tensor, nz_alloc: torch.Tensor,
    node_active: torch.Tensor, pod_active: torch.Tensor, age_w: torch.Tensor, backward: bool = False,
) -> torch.Tensor:
    """Launch the objective kernel (csrc/tune.cu) on a rollout on the card:
    ``final_nonzero`` [L, N, 2] and ``selected`` [L, P] → the L lanes'
    objective values [L], or with ``backward`` the cotangents F [L, N, 2]
    (d objective / d final_nonzero), as tuning/objective.py's plain
    versions."""
    if name not in OBJECTIVE_IDS:
        raise KernelArgumentError(f"unknown objective {name!r}; choose from {tuple(OBJECTIVE_IDS)}")
    L, N, _two = final_nonzero.shape
    P = selected.shape[1]
    dt = final_nonzero.dtype
    want = dict(
        final_nonzero=(final_nonzero, (L, N, 2), dt), selected=(selected, (L, P), torch.int32),
        nz_alloc=(nz_alloc, (N, 2), dt), node_active=(node_active, (N,), torch.bool),
        pod_active=(pod_active, (P,), torch.bool), age_w=(age_w, (P,), dt),
    )
    a = ObjArgs()
    for field, (t, shape, tdt) in want.items():
        if tuple(t.shape) != shape:
            raise KernelArgumentError(f"{field} has shape {tuple(t.shape)}, the objective wants {shape}")
        setattr(a, "used" if field == "final_nonzero" else field, _check(t, field, tdt))
    fn = _entry("objective", dt)
    n_vals = {"utilization": 2 * N, "fragmentation": N, "pending_age": P}[name]
    pw = 1 << max(n_vals - 1, 0).bit_length()
    dev = final_nonzero.device
    scratch = torch.empty((L, 2, pw), dtype=dt, device=dev)
    res = torch.empty((L, N, 2) if backward else (L,), dtype=dt, device=dev)
    a.L, a.N, a.P, a.kind, a.backward, a.pw = L, N, P, OBJECTIVE_IDS[name], int(backward), pw
    a.scratch = scratch.data_ptr()
    if backward:
        a.F = res.data_ptr()
    else:
        a.value = res.data_ptr()
    rc = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "objective")
    LAUNCHES["objective"] += 1
    return res


def _launch_scan(
    cfg, dims, dp, blocks, ws0, carry0, offset, window, lane_active=None, weights=None, grad=None, cluster=None,
    tile=None,
) -> dict:
    """One launch of csrc/scan.cu (``_scan_setup``'s arguments)."""
    fn, a, blocks_x, out, final_start, laned, dev = _scan_setup(
        cfg, dims, dp, blocks, ws0, carry0, offset, window, lane_active, weights, grad, cluster, tile)
    rc = fn(ctypes.byref(a), blocks_x, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "scan")
    return _scan_outputs(out, final_start, laned)


def _scan_outputs(out: dict, final_start: torch.Tensor, laned: bool) -> dict:
    packed = out["packed_pod"]
    out.update(
        selected=packed[..., 0, :],
        feasible_count=packed[..., 1, :],
        sample_start=packed[..., 2, :],
        sample_processed=packed[..., 3, :],
        final_start=final_start if laned else final_start[0],
    )
    out["final_carry"] = final_carry(out, final_start)
    return out


def _scan_setup(
    cfg, dims, dp, blocks, ws0, carry0, offset, window, lane_active=None, weights=None, grad=None, cluster=None,
    tile=None, shard: "dict | None" = None,
) -> tuple:
    """The arguments of one launch of csrc/scan.cu, its outputs allocated:
    (entry, ScanArgs, grid x, outputs, final_start, laned, device).  ``scan``'s
    arguments; with
    ``lane_active`` [G, N] and a ``tile`` (K8: the masked mode, one block of
    ``tile`` threads a lane over its own rows) or a [G, S] ``weights``
    matrix (K9) the lane axis (every output gets a leading lane axis); a
    lane of K9 or the one-lane scan is a cluster of ``cluster`` (default
    ``cluster_width``) blocks sharing one scratch slot, unless ``blocks``
    asks for the redundant chains; with ``grad=tau`` the grad mode (K2g's
    forward, ``resid`` in the outputs).  ``shard``: the shard mode's part
    (``_launch_sharded``): this shard's index, offset and mesh size, the
    whole axis's ``dims``, the mailbox, and the whole axis's outputs
    (packed, final_start, the trace), which it fills in instead of
    allocating them."""
    _check(dp.alloc, "alloc")
    check_slice(cfg)
    ws0 = in_step_width(cfg, shard["dims"] if shard else dims, ws0)
    Psrc = dims["P"]
    if window is not None:
        dp = slice_pod_window(dp, offset, window)
        dims = dict(dims, P=window)
    start_dev = None
    if carry0 is not None:
        start_dev = carry0["start0"] if isinstance(carry0["start0"], torch.Tensor) else None
        dp = dp._replace(**{f: v for f, v in carry0.items() if f != "start0"})
        if start_dev is None:
            dp = dp._replace(start0=int(carry0["start0"]))
    P, N, R = dims["P"], dims["N"], dims["R"]
    if R > 30:
        raise KernelArgumentError(f"{R} distinct checked resources exceed the int32 reason bitmask (30)")
    if len(cfg.fit_resources) > MAXFR or len(cfg.fit_shape) > MAXSHAPE:
        raise KernelArgumentError("NodeResourcesFit scoring resources or shape exceed the kernel's capacity")
    if max(dims["KC"], dims["KS"]) > MAXC:
        raise KernelArgumentError(f"more than {MAXC} PodTopologySpread constraints of one kind on a pod")
    if len(dims["key_struct"]) > MAXKU:
        raise KernelArgumentError(f"more than {MAXKU} topology keys in the spread constraints and inter-pod terms")
    dt = dp.alloc.dtype
    dev = dp.alloc.device
    i32 = torch.int32
    e = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype, device=dev)
    SG, G, D = dims["SG"], dims["G"], dims["D"]
    # the weights: the profile's row, one given row, or K9's [L, S] rows
    S = len(cfg.scores)
    w_rows = profile_weights(cfg, dt, dev) if weights is None else weights
    _check(w_rows, "weights", dt)
    if w_rows.shape[-1] != S or w_rows.dim() not in (1, 2):
        raise KernelArgumentError(f"weights must be [{S}] or [G, {S}], got {tuple(w_rows.shape)}")
    # the lane axis: L lanes, each output with a leading [L]
    laned = lane_active is not None or w_rows.dim() == 2
    L = lane_active.shape[0] if lane_active is not None else (w_rows.shape[0] if w_rows.dim() == 2 else 1)
    lead = (L,) if laned else ()
    o = lambda *shape, dtype=dt: e(*lead, *shape, dtype=dtype)

    def carried(t: torch.Tensor, rows: int) -> torch.Tensor:
        """A final-carry output the kernel writes ``rows`` rows of: a problem
        without selector groups or term groups still carries one padding
        row, handed on as it came in."""
        return o(*t.shape) if t.shape[0] == rows else t.expand(*lead, *t.shape).clone()

    out = {
        "packed_pod": shard["out"]["packed_pod"] if shard else o(5, P, dtype=i32),
        "final_requested": o(N, R),
        "final_nonzero": o(N, 2),
        "final_pod_count": o(N),
        "final_ports_used": o(*dp.ports_used0.shape),
        "final_restr_used": o(*dp.restr_used0.shape),
        "final_cloud_used": o(*dp.cloud_used0.shape),
        "final_csi_att": o(*dp.csi_attached0.shape),
        "final_spread_counts": carried(dp.spread_counts0, SG),
        "final_ip_sel": carried(dp.ip_sel0, G),
        "final_ip_own": carried(dp.ip_own0, G),
        "final_ip_anti": carried(dp.ip_anti0, G),
    }
    final_start = shard["final_start"] if shard else e(L, dtype=i32)
    gates = plugin_gates(cfg, dims)
    # column counts of the volume arrays (at least 1 each)
    PT, VR, VID, DR = (t.shape[1] for t in (dp.ports_used0, dp.restr_used0, dp.csi_attached0, dp.csi_seed_used))
    cap, in_smem = domain_layout(dims, dt)
    nslot = dims["KC"] + dims["KS"]
    # each lane a cluster of C blocks sharing one carry copy, or (``blocks``)
    # a carry copy for each block of each lane
    lane_smem = False
    if (lane_active is None) != (tile is None):
        raise KernelArgumentError("node-mask lanes run in the masked mode only, which takes them and a tile")
    if tile is not None:
        if blocks is not None or cluster is not None or tile not in LANE_TILES:
            raise KernelArgumentError(f"the masked mode takes one block a lane and a tile of {LANE_TILES}, got {tile}")
        C, lib, blocks_x, slots = 1, "scan_masked", 1, L
        # the list (int32), flags (uint8), and R + 6 rows of the dtype a node
        lane_smem = N * (5 + dp.alloc.element_size() * (R + 6)) <= LANE_SMEM_BYTES
    elif blocks is not None:
        if laned or grad is not None or cluster is not None or blocks < 1:
            raise KernelArgumentError("the redundant chains take one lane, no grad mode and no cluster width")
        C, lib, blocks_x, slots = 1, "scan", blocks, blocks
    else:
        C = cluster_width(N, L) if cluster is None else cluster
        if not 1 <= C <= MAXCL or (C > 1 and -(-N // SCAN_THREADS) > SCAN_THREADS):
            raise KernelArgumentError(f"a cluster of {C} blocks over {N} nodes: at most {MAXCL} blocks and "
                             f"{SCAN_THREADS} rank tiles of {SCAN_THREADS} nodes")
        lib = "scan_grad" if grad is not None else ("scan_trace" if cfg.trace else "scan_cluster")
        blocks_x, slots = C, L
    if shard:
        lib = {"scan_trace": "scan_shard_trace", "scan_cluster": "scan_shard_cluster",
               "scan_masked": "scan_shard_masked"}[lib]
    fn = _entry(lib, dt)
    scratch = dict(
        s_requested=e(slots, N, R), s_nonzero=e(slots, N, 2), s_pod_count=e(slots, N),
        s_spread=e(slots, SG, N) if SG > 0 else e(1),
        s_ip_sel=e(slots, G, D + 1) if gates["interpod"] else e(1),
        s_ip_own=e(slots, G, D + 1) if gates["interpod"] else e(1),
        s_ip_anti=e(slots, G, D + 1) if gates["interpod"] else e(1),
        s_raw_spread=e(slots, N), s_raw_ipa=e(slots, N),
        s_dom=e(1) if in_smem else e(slots, nslot * cap),
        s_domflag=e(1, dtype=i32) if in_smem else e(slots, nslot * cap, dtype=i32),
        s_total=e(slots, N), s_flags=e(slots, N, dtype=torch.uint8),
        s_rank=e(slots, N, dtype=i32) if ws0 or C > 1 or (tile and not lane_smem) or shard else e(1, dtype=i32),
        s_ports=e(slots, PT, N) if gates["ports"] else e(1),
        s_restr=e(slots, VR, N) if gates["restr"] else e(1),
        s_cloud=e(slots, 3, N) if gates["cloud"] else e(1),
        s_csi=e(slots, VID, N, dtype=torch.uint8) if gates["csi"] else e(1, dtype=torch.uint8),
        s_csi_cnt=e(slots, DR, N) if gates["csi"] else e(1),
        s_norm=e(slots, S, N) if grad is not None else e(1),
    )
    # (the shard mode: the topology sizes count the whole axis's nodes)
    logt = log_table(shard["dims"]["N"] if shard else N, dt, dev)
    a = ScanArgs()
    a.P, a.N, a.R, a.Psrc = P, N, R, Psrc
    a.n_true, a.sample_k, a.start0 = dp.n_true, dp.sample_k, dp.start0
    a.tb_base = dp.tb_base & 0xFFFFFFFF
    # mix32(seed ^ golden): the counter-independent half of the draw
    a.seed_mix = _mix32((cfg.seed ^ GOLDEN32) & MASK32)
    a.trace = int(cfg.trace)
    a.reservoir = int(cfg.tie_break == "reservoir")
    a.lanes, a.cluster = L, C
    a.tile, a.lane_smem = tile or 0, int(lane_smem)
    a.na_stride = N if lane_active is not None else 0
    a.w_stride = S if w_rows.dim() == 2 else 0
    a.weights = w_rows.data_ptr()
    a.nf = len(cfg.filters)
    for k, f in enumerate(cfg.filters):
        a.filters[k] = _FILTER_IDS[f]
    a.ns = len(cfg.scores)
    if S > MAXS:
        raise KernelArgumentError(f"{S} score plugins exceed the scan's capacity ({MAXS})")
    for k, (s, _w) in enumerate(cfg.scores):
        a.scores[k] = _SCORE_IDS[s]
    a.fit_strategy = _FIT_IDS[cfg.fit_strategy]
    a.n_fit_res = len(cfg.fit_resources)
    for j, (c, w) in enumerate(cfg.fit_resources):
        a.fit_col[j] = int(c)
        a.fit_w[j] = float(w)
    a.fit_wsum = float(sum(w for _, w in cfg.fit_resources)) or 1.0
    a.n_shape = len(cfg.fit_shape)
    for j, (u, s) in enumerate(cfg.fit_shape):
        a.shape_u[j], a.shape_s[j] = int(u), int(s)
    a.T_cols = dp.taint_cls.shape[1]
    a.M_cols = dp.aff_code_cls.shape[1]
    a.MP_cols = dp.aff_pref_cls.shape[1]
    a.MC_cols = dp.img_cls.shape[1]
    a.use_spread_f, a.use_spread_s = int(gates["spread_filter"]), int(gates["spread_score"])
    a.use_ipa = int(gates["interpod"])
    for name in ("KC", "KS", "KA", "KB", "KP", "KO", "SG", "G", "D"):
        setattr(a, name, int(dims[name]))
    a.KM = dp.ip_match_g.shape[1]
    a.dom_cap, a.dom_smem = cap, int(in_smem)
    a.ws0 = ws0 or 0
    a.use_ports, a.use_restr = int(gates["ports"]), int(gates["restr"])
    a.use_cloud, a.use_csi = int(gates["cloud"]), int(gates["csi"])
    a.PT, a.VR, a.VID, a.DR = PT, VR, VID, DR
    a.KPT, a.KVR, a.KV = (t.shape[1] for t in (dp.port_cols, dp.restr_cols, dp.csi_cols))
    a.VB_cols = dp.vb_cls.shape[1]
    for col, limit in CLOUD_LIMIT_COL.values():
        a.cloud_limit[col] = limit
    # (first domain id, domains; 0 = identity) of each used key, by value:
    # a device copy would block the host until the card drains
    for u, (kind, base, size) in enumerate(dims["key_struct"]):
        a.key_base[u], a.key_size[u] = base, 0 if kind == "identity" else size
    for name, want in (
        ("alloc", dt), ("max_pods", dt), ("nz_alloc", dt), ("pod_req", dt), ("pod_nonzero", dt),
        ("fit_checked", torch.bool), ("taint_cls", torch.int16), ("taint_prefer_cls", torch.int16),
        ("taint_unsched_cls", torch.bool), ("pod_tol_idx", i32), ("node_taint_idx", i32),
        ("node_unsched", torch.bool), ("aff_code_cls", torch.int8), ("aff_pref_cls", i32),
        ("pod_aff_idx", i32), ("pod_pref_idx", i32), ("node_label_idx", i32), ("img_cls", torch.int8),
        ("pod_img_idx", i32), ("node_img_idx", i32), ("name_target", i32), ("pod_active", torch.bool),
        ("node_active", torch.bool), ("incl_cls", torch.bool), ("node_domain", i32), ("spf_ku", i32),
        ("sps_ku", i32), ("gdom", i32), ("ip_match_g", i32), ("ip_aff_g", i32),
        ("ip_anti_g", i32), ("ip_pref_g", i32), ("ip_pref_w", dt), ("ip_own_g", i32), ("ip_own_w", dt),
        ("ip_self_match", torch.bool), ("requested0", dt), ("nonzero0", dt), ("pod_count0", dt),
        ("spread_counts0", dt), ("ip_sel0", dt), ("ip_own0", dt), ("ip_anti0", dt),
        ("port_cols", i32), ("port_conflict", dt), ("restr_cols", i32), ("restr_conflict", dt),
        ("cloud_cnt", dt), ("csi_cols", i32), ("csi_drv", i32), ("csi_seed_used", dt), ("csi_limit", dt),
        ("vb_cls", torch.int8), ("vz_cls", torch.int8), ("pod_vol_idx", i32),
        ("ports_used0", dt), ("restr_used0", dt), ("cloud_used0", dt), ("csi_attached0", dt),
    ):
        setattr(a, name, _check(getattr(dp, name), name, want))
    for name, t, want in (
        ("spf_key", dp.spf[0], i32), ("spf_grp", dp.spf[1], i32), ("spf_skew", dp.spf[2], dt),
        ("spf_self", dp.spf[3], dt), ("sps_key", dp.sps[0], i32), ("sps_grp", dp.sps[1], i32),
        ("sps_skew", dp.sps[2], dt), ("log_table", logt, dt),
    ):
        setattr(a, name, _check(t, name, want))
    # pods on the second axis: a window's view keeps the full problem's row
    # stride (Psrc), so only its columns need to be contiguous
    for name in ("spread_match", "term_match"):
        t = getattr(dp, name)
        if not t.is_cuda or t.dtype != dt or (t.numel() and (t.stride(1) != 1 or t.stride(0) != Psrc)):
            raise KernelArgumentError(f"{name} must be a {dt} CUDA tensor with rows of the full problem")
        setattr(a, name, t.data_ptr())
    if lane_active is not None:
        a.node_active = lane_active.data_ptr()
    a.start_ptr = _check(start_dev, "start0", i32) if start_dev is not None else None
    if grad is not None:
        if laned or cfg.trace:
            raise KernelArgumentError("the grad mode runs one lane with the trace off")
        # zeroed by the kernel
        out["resid"] = torch.empty((2, S, N), dtype=torch.float64, device=dev)
        a.grad, a.tau = 1, float(grad)
        a.resid = out["resid"].data_ptr()
    for name, t in scratch.items():
        setattr(a, name, t.data_ptr())
    a.packed = out["packed_pod"].data_ptr()
    a.final_start = final_start.data_ptr()
    for name in ("final_requested", "final_nonzero", "final_pod_count", "final_ports_used",
                 "final_restr_used", "final_cloud_used", "final_csi_att"):
        setattr(a, name, out[name].data_ptr())
    for name, key in (("final_spread", "final_spread_counts"), ("final_ip_sel", "final_ip_sel"),
                      ("final_ip_own", "final_ip_own"), ("final_ip_anti", "final_ip_anti")):
        setattr(a, name, out[key].data_ptr())
    if cfg.trace:
        planes = shard["out"] if shard else trace_outputs(cfg, P, N, ws0, e)
        out.update({k: v for k, v in planes.items() if k != "packed_pod"})
        a.fail_plug = out["fail_plug"].data_ptr()
        a.fail_code = out["fail_code"].data_ptr()
        if ws0 is None:
            a.feasible = out["feasible"].data_ptr()
        for k, (s, _w) in enumerate(cfg.scores):
            a.raw[k] = out[f"raw:{s}"].data_ptr()
            a.norm[k] = out[f"norm:{s}"].data_ptr()
        a.trace_meta = out["trace_meta"].data_ptr()
    if shard:
        out["_shard"] = shard["shard"]
        a.shards, a.shard, a.node_off = shard["shards"], shard["shard"], shard["node_off"]
        a.N_glob, a.slot_bytes, a.spin_cap = shard["dims"]["N"], shard["slot_bytes"], SHARD_SPIN_CAP
        a.mbox_flags, a.mbox, a.mbox_err, a.xwait = (
            shard[k].data_ptr() for k in ("mbox_flags", "mbox", "mbox_err", "xwait"))
        out["_scratch"] = (scratch, logt)  # alive until the launch is enqueued
    return fn, a, blocks_x, out, final_start, laned, dev


def trace_outputs(cfg, P: int, N: int, ws0: "int | None", e) -> dict:
    """The trace planes a traced launch writes, allocated by ``e(*shape,
    dtype=)`` (the working dtype by default): the failing plugin and code,
    the feasible flags (not with an in-step width), each score's raw and
    normalized plane ([P, N], or [P, ws0]) and the trace meta."""
    out = {"fail_plug": e(P, N, dtype=torch.int8), "fail_code": e(P, N, dtype=torch.int32)}
    if ws0 is None:
        out["feasible"] = e(P, N, dtype=torch.bool)
    for s, _w in cfg.scores:
        out[f"raw:{s}"] = e(P, ws0 or N)
        out[f"norm:{s}"] = e(P, ws0 or N)
    out["trace_meta"] = e(len(cfg.scores) + 1, 2, dtype=torch.int32)
    return out


# polls of a shard's mailbox wait before it gives up (csrc/scan.cu mb_spin:
# the shard's error word, which the wrapper raises): with the __nanosleep backoff's
# 1 us ceiling, some seconds, far past a pod step's exchange
SHARD_SPIN_CAP = 1 << 22
RC_NOT_RESIDENT = 1000  # csrc/scan.cu: the shards cannot all be resident
RC_NO_PEER = 1001  # csrc/scan.cu shard_peer: a card cannot map the first card's memory
# a shard left out of its card's launch, so that the other shards' waits
# for its flags reach the cap (tests of the cap); None launches every shard
SILENT_SHARD: "int | None" = None


def _mailbox_bytes(dims: dict, dt: torch.dtype) -> int:
    """One shard's mailbox slot (csrc/scan.cu XI/XT/XV): 384 bytes of
    scalars, then the largest vector an exchange sends: the domain sums and
    flags, the sampled-domain flags, the selected node's gdom column."""
    cap, _smem = domain_layout(dims, dt)
    esize = torch.finfo(dt).bits // 8
    vec = max((dims["KC"] + dims["KS"]) * cap * (esize + 4), dims["G"] * 4, 16)
    return 384 + -(-vec // 128) * 128


def _launch_sharded(cfg, dims, sp, ws0, carry0, offset, window, lane_active=None, tile=None, weights=None) -> dict:
    """The shard mode (csrc/scan.cu "SH") over a ``ShardedProblem``: one
    ScanArgs a shard (its own buffers, its global offset), one launch a card
    for the shards it holds, every card's launch issued before any wait; the
    mailbox, packed, final_start and the trace on the mesh's first device
    (other cards map them as peers).  Returns ``scan_plain_sharded``'s keys:
    the whole axis's packed outputs and trace, the per-shard final carries
    (``final_carry``, the next window's ``carry0``) and their whole-axis
    views.  Raises ``KernelArgumentError`` where the shards cannot all be
    resident at once, and ``KernelLaunchError`` where a mailbox wait hit its
    cap."""
    from kube_scheduler_simulator_tpu_torch.ops.batch import sharded_out

    shards = sp.shards
    n = len(shards)
    if n < 2:
        raise KernelArgumentError("the shard mode takes a mesh of two shards or more")
    dev0 = shards[0].alloc.device
    dt = shards[0].alloc.dtype
    N = dims["N"]
    Ns = N // n
    P = dims["P"] if window is None else window
    L = lane_active[0].shape[0] if lane_active is not None else 1
    laned = lane_active is not None
    lead = (L,) if laned else ()
    i32 = torch.int32
    e0 = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype, device=dev0)  # noqa: E731
    ws0w = in_step_width(cfg, dims, ws0)
    shared_out = {"packed_pod": e0(*lead, 5, P, dtype=i32)}
    if cfg.trace:
        shared_out.update(trace_outputs(cfg, P, N, ws0w, e0))
    slot = _mailbox_bytes(dims, dt)
    box = dict(
        mbox_flags=torch.zeros(L * n, dtype=i32, device=dev0),
        # zeros: what a shard that never ran leaves in its slots
        mbox=torch.zeros(2 * L * n * slot, dtype=torch.uint8, device=dev0),
        mbox_err=torch.zeros(L * n, dtype=i32, device=dev0),
        xwait=torch.zeros(L * n, dtype=torch.int64, device=dev0),
    )
    final_start = e0(L, dtype=i32)
    cards = {}
    for s, dp in enumerate(shards):
        if dp.alloc.device != dev0:
            # the peer mapping of the first card's mailbox and outputs
            _enable_peer(dp.alloc.device, dev0)
        part = dict(dims=dims, shards=n, shard=s, node_off=s * Ns, out=shared_out, final_start=final_start,
                    slot_bytes=slot, **box)
        sdims = dict(dims, N=Ns)
        fn, a, blocks_x, out, _fs, _l, dev = _scan_setup(
            cfg, sdims, dp, None, ws0w, None if carry0 is None else carry0[s], offset, window,
            lane_active=None if lane_active is None else lane_active[s], tile=tile, shard=part,
            weights=None if weights is None else weights.to(dp.alloc.device))
        cards.setdefault(dev, []).append((fn, a, blocks_x, out))
    # every card's checks (co-residency first) before any card launches: a
    # launched card whose peers are refused would spin to its waits' cap
    plan = []
    for dev, group in cards.items():
        fn, _a, blocks_x, _o = group[0]
        if any(g[2] != blocks_x for g in group):
            raise KernelArgumentError("the shards of one card take one cluster width")
        group = [g for g in group if g[3]["_shard"] != SILENT_SHARD]
        if not group:
            continue
        args = (ScanArgs * len(group))(*(g[1] for g in group))
        with torch.cuda.device(dev):
            rc = fn(ctypes.byref(args[0]), None, len(group), blocks_x, None)
        if rc == RC_NOT_RESIDENT:
            raise KernelArgumentError(
                f"{len(group)} shards of {blocks_x}-block clusters cannot all be resident on "
                f"{torch.cuda.get_device_name(dev)}: their mailbox waits would never end")
        _raise_on(rc, "sharded scan")
        plan.append((dev, fn, args, blocks_x))
    if len(plan) > 1:
        # the mailbox's zeros, made on the first card's stream, before
        # another card's launch reads or publishes there
        torch.cuda.current_stream(dev0).synchronize()
    launched = []
    try:
        for dev, fn, args, blocks_x in plan:
            dev_args = torch.frombuffer(bytearray(bytes(args)), dtype=torch.uint8).to(dev)
            launched.append((dev, dev_args))
            with torch.cuda.device(dev):
                rc = fn(ctypes.byref(args[0]), dev_args.data_ptr(), len(args), blocks_x,
                        torch.cuda.current_stream(dev).cuda_stream)
            _raise_on(rc, "sharded scan")
    except BaseException:
        # the cards already launched write the first card's mailbox and
        # outputs until their waits reach the cap: held until they end, so
        # that no freed block of the first card is written after its reuse
        for dev, _d in launched:
            torch.cuda.current_stream(dev).synchronize()
        raise
    for dev, _d in launched:
        torch.cuda.current_stream(dev).synchronize()
    if int(box["mbox_err"].any().item()):
        dead = box["mbox_err"].view(L, n).any(0).nonzero().flatten().tolist()
        raise KernelLaunchError(f"sharded scan: the mailbox waits on shards {dead} hit their cap (the shards "
                                "never answered)")
    outs = [g[3] for group in cards.values() for g in group]
    outs.sort(key=lambda o: o["_shard"])
    out = dict(shared_out)
    out["final_start"] = final_start if laned else final_start[0]
    # each (lane, shard)'s rank-0 block's ns in the pod loop's exchanges
    out["_exchange_ns"] = box["xwait"].view(L, n)
    packed = out["packed_pod"]
    out.update(selected=packed[..., 0, :], feasible_count=packed[..., 1, :], sample_start=packed[..., 2, :],
               sample_processed=packed[..., 3, :])
    return sharded_out(outs, out, lead=int(laned))


_PEERS: set = set()


def _enable_peer(dev: torch.device, peer: torch.device) -> None:
    """Map ``peer``'s memory into ``dev``'s (cudaDeviceEnablePeerAccess,
    csrc/scan.cu shard_peer), once a pair; ``MeshConfigError`` where the
    cards cannot reach each other's memory."""
    from kube_scheduler_simulator_tpu_torch.ops.mesh import MeshConfigError

    key = (dev.index, peer.index)
    if key not in _PEERS:
        rc = build()["scan_shard_cluster"].kss_scan_shard_cluster_peer(dev.index, peer.index)
        if rc == RC_NO_PEER:
            raise MeshConfigError(f"cuda:{dev.index} cannot map the memory of cuda:{peer.index}: a mesh over "
                                  "cards needs peer access between each card and the first")
        _raise_on(rc, "peer access")
        _PEERS.add(key)


def scan_sharded(
    cfg: BatchConfig, dims: dict, sp, ws0: "int | None" = None, carry0: "list | None" = None, offset: int = 0,
    window: "int | None" = None, weights: "torch.Tensor | None" = None,
) -> dict:
    """Launch the scan's shard mode on a ``ShardedProblem`` whose shards lie
    on cards (csrc/scan_shard_trace.cu with the trace on,
    csrc/scan_shard_cluster.cu without): each shard a cluster of
    ``cluster_width(N / n, 1)`` blocks, each pod's cross-shard reductions
    exchanged inside the launch.  ``scan_plain_sharded``'s arguments and
    outputs (``carry0`` the list of the shards' carries)."""
    if (dims["P"] if window is None else window) <= 0:
        raise KernelArgumentError(f"a scan over no pods (P={dims['P']}, window={window}): nothing to launch")
    out = _launch_sharded(cfg, dims, sp, ws0, carry0, offset, window, weights=weights)
    LAUNCHES["scan_sharded"] += 1
    return out


def scan_lanes_sharded(cfg: BatchConfig, dims: dict, sp, lane_active: list, widest: "int | None" = None) -> dict:
    """K8 over a ``ShardedProblem`` (csrc/scan_shard_masked.cu): one block a
    (shard, lane) over the lane's rows in the shard, each pod's cross-shard
    reductions exchanged per lane inside the launch.  ``lane_active``: one
    bool [G, N / n] mask a shard, on its device; ``widest`` as
    ``scan_lanes``'s (the most rows a lane has in one shard).  Returns
    ``scan_lanes_sharded``'s plain keys, node-axis carries whole."""
    if cfg.trace:
        raise KernelArgumentError("the lane scan runs with the trace off")
    for la in lane_active:
        _check(la, "lane_active", torch.bool)
    if widest is None:
        widest = max(int(la.sum(dim=1).max()) for la in lane_active)
    out = _launch_sharded(cfg, dims, sp, None, None, 0, None, lane_active=lane_active, tile=lane_tile(widest))
    LAUNCHES["scan_lanes_sharded"] += 1
    return out


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s card, as the kernels take it."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


_SCATTER: list = []  # the row-copy entry point, resolved once


def scatter_rows(buf: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``buf[idx[k]] = rows[k]`` in place on a plane resident on the card
    (any dtype, rank >= 1), by the row-copy kernel; returns ``buf``.  Every
    repeated index must carry an identical row (the placer pads with
    repeats of its first index).

    The path is the call's whole cost (the copy is a few hundred bytes):
    the entry point and the stream getter are resolved once, the row width
    comes from the shape and the copy word from the width and the two
    pointers, each read once."""
    if not (buf.is_cuda and idx.is_cuda and rows.is_cuda):
        raise KernelArgumentError("buf, idx and rows must be CUDA tensors (the plain versions serve CPU tensors)")
    if not (buf.is_contiguous() and idx.is_contiguous() and rows.is_contiguous()):
        raise KernelArgumentError("buf, idx and rows must be contiguous")
    if idx.dtype != torch.int32 or rows.dtype != buf.dtype:
        raise KernelArgumentError(f"idx must be torch.int32 and rows {buf.dtype}, got {idx.dtype} and {rows.dtype}")
    bs, rs, js = buf.shape, rows.shape, idx.shape
    if len(js) != 1 or len(rs) != len(bs) or not bs or js[0] != rs[0] or (len(bs) > 1 and rs[1:] != bs[1:]):
        raise KernelArgumentError(f"rows {tuple(rs)} / idx {tuple(js)} do not fit plane {tuple(bs)}")
    nbytes = rows.nbytes
    if nbytes == 0:
        return buf
    k = rs[0]
    row_bytes = nbytes // k
    bp, rp = buf.data_ptr(), rows.data_ptr()
    # the widest word (8, 4, 2 or 1 bytes) dividing the width and both bases
    m = row_bytes | bp | rp
    word = min(8, m & -m)
    if not _SCATTER:
        _SCATTER.append(build()["scatter"].kss_scatter_rows)
    rc = _SCATTER[0](bp, idx.data_ptr(), rp, k, row_bytes, word, _stream(buf))
    if rc:
        _raise_on(rc, "scatter")
    LAUNCHES["scatter"] += 1
    return buf


# the compaction's mapped plane kinds (csrc/compact.cu; 4: a score plane
# the scan compacted in its step) and each manifest dtype's bytes
_MAP_KINDS = {"fail8": 0, "fail": 1, "fail_plug": 2, "fail_code": 3}
_DT_BYTES = {"uint8": 1, "int8": 1, "uint16": 2, "int16": 2, "int32": 4}
# (manifest, N, W, WS, ws0, scores, filters) -> the launch's fixed fields
_COMPACT_PLANS: dict = {}


def _compact_plan(key, cfg: BatchConfig, dims: dict, W: int, WS: int, manifest, ws0) -> tuple:
    """(CompactArgs bytes with every field the manifest fixes, the blob's
    bytes, the score planes' source keys in ``out``, the (field, key,
    dtype) of the other planes the launch reads).  Each mapped plane
    stores words of the widest of 16, 8, 4, 2 and 1 bytes that divides
    both its byte offset and its row's bytes; a full-plane cell, the widest
    that divides its bytes and its plane's offset."""

    def word(m: int) -> int:  # the widest of 16, 8, 4, 2, 1 dividing m
        return min(16, m & -m) if m else 16

    P, N = dims["P"], dims["N"]
    a = CompactArgs()
    a.P, a.N, a.WS, a.filters = P, N, WS, int(bool(cfg.filters))
    offs, dts, total = {}, {}, 0
    for name, dt, shape in manifest:
        offs[name], dts[name] = total, dt
        total += int(torch.Size(shape).numel()) * _DT_BYTES[dt]
    scores = [name for name, _dt, _shape in manifest if name.startswith(("raw:", "norm:"))]
    if len(scores) > MAXSP:
        raise KernelArgumentError(f"{len(scores)} score planes exceed the compaction kernel's capacity")
    src_keys = tuple(f"{name.split(':')[0]}:{cfg.scores[int(name.split(':')[1])][0]}" for name in scores)
    ptrs = [("sample_start", "sample_start", torch.int32), ("sample_processed", "sample_processed", torch.int32)]
    mapped = []  # (kind, score source, cells a row, bytes a cell, offset)
    if cfg.filters:
        ptrs += [("fail_plug", "fail_plug", torch.int8), ("fail_code", "fail_code", torch.int32)]
        mapped += [(k, 0, W, _DT_BYTES[dts[name]], offs[name]) for name, k in _MAP_KINDS.items() if name in offs]
    if ws0 is not None:
        if not cfg.filters:
            raise KernelArgumentError("the in-step compaction needs filters: without them the blob carries feasible ids")
        if WS > ws0:
            raise KernelArgumentError(f"WS {WS} exceeds the in-step planes' width {ws0}")
        a.ws0 = ws0
        ptrs.append(("feasible_count", "feasible_count", torch.int32))
        mapped += [(4, k, WS, _DT_BYTES[dts[name]], offs[name]) for k, name in enumerate(scores)]
    else:
        ptrs.append(("feasible", "feasible", torch.bool))
        if not cfg.filters:
            a.off_sids, a.w_sids = offs["sids"], min(4, word(offs["sids"]))
        a.n_sp = len(scores)
        for k, name in enumerate(scores):
            nb = _DT_BYTES[dts[name]]
            a.sp_off[k], a.sp_nb[k], a.sp_w[k] = offs[name], nb, min(nb, word(offs[name]))
        a.rows = P if scores or not cfg.filters else 0
    first = 0
    for p, (kind, src, width, nb, off) in enumerate(mapped):
        vec = word(off | (width * nb))
        tiles = -(-width // (32 * (vec // nb if vec >= nb else 1)))
        a.mp_kind[p], a.mp_src[p], a.mp_width[p], a.mp_nb[p] = kind, src, width, nb
        a.mp_vec[p], a.mp_off[p], a.mp_tiles[p], a.mp_first[p] = vec, off, tiles, first
        first += P * tiles
    if first >= 1 << 31:
        raise KernelArgumentError(f"{first} warp tiles exceed the compaction kernel's 32-bit tile index")
    a.n_mp, a.map_tiles = len(mapped), first
    plan = (bytes(a), total, src_keys, tuple(ptrs))
    _COMPACT_PLANS[key] = plan
    return plan


def compact(
    cfg: BatchConfig, dims: dict, W: int, WS: int, manifest, out: dict, n_true: int,
    in_step_ws0: "int | None" = None,
) -> torch.Tensor:
    """Launch the compaction kernel on trace planes on the card; returns the
    uint8 blob of ops/batch.compact_plain (``in_step_ws0`` as there).  The
    fields the manifest fixes (offsets, store widths, the grid) are
    computed once per (manifest, N, W, WS, in_step_ws0, profile); a call
    fills in the pointers."""
    # CPU planes are refused before a launch plan is cached for them
    _check(out["sample_start"], "sample_start")
    key = (tuple(manifest), dims["N"], W, WS, in_step_ws0, cfg.scores, bool(cfg.filters))
    sub = _substrate()
    plan = sub.lookup("compact_plan", key)
    if plan is None:
        plan = sub.publish(
            "compact_plan", key,
            _COMPACT_PLANS.get(key) or _compact_plan(key, cfg, dims, W, WS, manifest, in_step_ws0),
        )
    tmpl, nbytes, src_keys, ptrs = plan
    a = CompactArgs.from_buffer_copy(tmpl)
    for field, name, dtype in ptrs:
        setattr(a, field, _check(out[name], name, dtype))
    score_dt = None
    for k, name in enumerate(src_keys):
        t = out[name]
        a.sp_src[k] = _check(t, name, score_dt)
        score_dt = t.dtype
    start = out["sample_start"]
    a.n_true = int(n_true)
    blob = torch.empty(nbytes, dtype=torch.uint8, device=start.device)
    a.blob = blob.data_ptr()
    if a.P == 0 or nbytes == 0:
        return blob
    if a.blob % 16:
        raise KernelArgumentError("the compaction's blob must be 16-byte aligned")
    rc = _entry("compact", score_dt or torch.float32)(ctypes.byref(a), _stream(start))
    _raise_on(rc, "compact")
    LAUNCHES["compact"] += 1
    return blob


def preempt(
    ucand, ureq, uprio, smask, sreq, snode, alloc, base_req, extra_req, base_cnt, extra_cnt, max_pods,
    vreq, vprio, vvalid, vmatch, allowed, out: "torch.Tensor | None" = None,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Launch the victim-search kernel on tensors on the card; returns
    (cand [U,N], victims [U,N,V], viol [U,N,V]) bool, as
    preemption/kernel.preempt_plain (whose docstring gives the shapes):
    views of one uint8 buffer of ``preemption.kernel.mask_layout`` bytes,
    ``out`` when given (so the three fetch in one copy)."""
    from kube_scheduler_simulator_tpu_torch.preemption.kernel import mask_layout, mask_views

    U, N = ucand.shape
    V, R, PDB, S = vprio.shape[1], alloc.shape[1], vmatch.shape[2], snode.shape[0]
    if R > MAXR_PREEMPT:
        raise KernelArgumentError(f"{R} resource columns exceed the victim search's capacity ({MAXR_PREEMPT})")
    dt = alloc.dtype
    want = dict(
        ucand=((U, N), torch.bool), ureq=((U, R), dt), uprio=((U,), torch.int64), smask=((U, S), torch.bool),
        sreq=((S, R), dt), snode=((S,), torch.int32), alloc=((N, R), dt), base_req=((N, R), dt),
        extra_req=((N, R), dt), base_cnt=((N,), dt), extra_cnt=((N,), dt), max_pods=((N,), dt),
        vreq=((N, V, R), dt), vprio=((N, V), torch.int64), vvalid=((N, V), torch.bool),
        vmatch=((N, V, PDB), torch.bool), allowed=((PDB,), torch.int32),
    )
    given = dict(zip(PREEMPT_TENSORS, (
        ucand, ureq, uprio, smask, sreq, snode, alloc, base_req, extra_req, base_cnt, extra_cnt, max_pods,
        vreq, vprio, vvalid, vmatch, allowed,
    )))
    a = PreemptArgs()
    a.U, a.N, a.V, a.R, a.PDB, a.S = U, N, V, R, PDB, S
    for name, (shape, tdt) in want.items():
        t = given[name]
        if tuple(t.shape) != shape:
            raise KernelArgumentError(f"{name} has shape {tuple(t.shape)}, the search wants {shape}")
        setattr(a, name, _check(t, name, tdt))
    fn = _entry("preempt", dt)
    dev = alloc.device
    nbytes, _offs = mask_layout(U, N, V)
    if out is None:
        out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if out.dtype != torch.uint8 or out.shape != (nbytes,):
        raise KernelArgumentError(f"out must be uint8 [{nbytes}], got {out.dtype} {tuple(out.shape)}")
    _check(out, "out")
    cand, victims, viol = mask_views(out, U, N, V)
    a.cand, a.victims, a.viol = cand.data_ptr(), victims.data_ptr(), viol.data_ptr()
    if U * N == 0:
        return cand, victims, viol
    # the successes bucketed by node (csrc/preempt.cu), each block its slice
    slist = torch.empty(max(S, 1), dtype=torch.int32, device=dev)
    a.slist = slist.data_ptr()
    rc = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "preempt")
    LAUNCHES["preempt"] += 1
    return cand, victims, viol


def gang_verdict(gid, node, dom, prior_bound, min_member, D: int, out: "torch.Tensor | None" = None):
    """Launch the window verdict (K6) on int32 tensors on the card; returns
    (feasible [G] bool, distinct [G] int32, placed [G] int32), as
    gang/kernel.verdict_plain (whose docstring gives the shapes): views of
    one uint8 buffer of ``gang.kernel.verdict_layout(G)`` bytes, ``out``
    when given (so the three fetch in one copy).  Every member's node must
    be below N and every domain id below ``D``; a group's counters and
    bitmap must fit ``VERDICT_SMEM_BYTES`` (D up to ~390 000)."""
    from kube_scheduler_simulator_tpu_torch.gang.kernel import verdict_layout, verdict_views

    K = gid.shape[0]
    G, N = dom.shape
    want = dict(gid=(gid, (K,)), node=(node, (K,)), dom=(dom, (G, N)), prior_bound=(prior_bound, (G,)),
                min_member=(min_member, (G,)))
    a = GangVerdictArgs()
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise KernelArgumentError(f"{name} has shape {tuple(t.shape)}, the verdict wants {shape}")
        setattr(a, name, _check(t, name, torch.int32))
    D = max(int(D), 1)
    W = (D + 31) // 32
    group_bytes = (2 + W) * 4
    if group_bytes > VERDICT_SMEM_BYTES:
        raise KernelArgumentError(f"{D} domains exceed a verdict block's shared memory ({VERDICT_SMEM_BYTES} bytes)")
    nbytes = verdict_layout(G)
    if out is None:
        out = torch.empty(nbytes, dtype=torch.uint8, device=dom.device)
    if out.dtype != torch.uint8 or out.shape != (nbytes,):
        raise KernelArgumentError(f"out must be uint8 [{nbytes}], got {out.dtype} {tuple(out.shape)}")
    _check(out, "out")
    feasible, distinct, placed = verdict_views(out, G)
    a.K, a.G, a.N, a.D, a.W, a.gb = K, G, N, D, W, VERDICT_SMEM_BYTES // group_bytes
    a.feasible, a.distinct, a.placed = feasible.data_ptr(), distinct.data_ptr(), placed.data_ptr()
    if G == 0:
        return feasible, distinct, placed
    rc = build()["gang"].kss_gang_verdict(ctypes.byref(a), _stream(dom))
    _raise_on(rc, "gang verdict")
    LAUNCHES["gang_verdict"] += 1
    return feasible, distinct, placed


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def feas_variant(N: int, R: int, dt: torch.dtype) -> int:
    """The feasibility scan's kernel shape for N nodes and R resource
    columns in ``dt``: an index of FEAS_VARIANTS, from FEAS_TABLE."""
    if R <= FEAS_RC:
        for n_max, v in FEAS_TABLE[dt, 2 if R <= 2 else FEAS_RC]:
            if N <= n_max:
                return v
    return FEAS_MEM


def feas_memory(G: int, M: int, N: int, R: int, dt: torch.dtype, variant: int) -> "tuple[int, int, int]":
    """(slots staged at a time, dynamic shared memory of a block, bytes of
    global scratch) of the feasibility scan's ``variant`` at these shapes:
    the staged request rows and valid flags (a register variant's rows
    padded to 2 or 4 columns, FEAS_GPB groups a block in a one-warp
    variant), then in a memory variant the nodes' state ([R + 1, N] values,
    [N] domain ids) where it fits GANG_SMEM_BYTES, else in G slices of
    scratch."""
    size = 4 if dt == torch.float32 else 8
    mc = max(1, min(M, FEAS_SLOTS))
    tg, npt = FEAS_VARIANTS[variant]
    if npt:
        gb = FEAS_GPB if tg == 32 else 1
        return mc, gb * mc * ((2 if R <= 2 else 4) * size + 1), 0
    stage = _up16(mc * R * size + mc)
    state = _up16((R + 1) * N * size) + _up16(4 * N)
    if stage + state <= GANG_SMEM_BYTES:
        return mc, stage + state, 0
    return mc, stage, G * state


def gang_feasibility(req, valid, free, cnt_free, dom, D: int, out: "torch.Tensor | None" = None,
                     variant: "int | None" = None):
    """Launch the all-or-nothing feasibility scan (K7) on tensors on the
    card; returns (feasible [G] bool, distinct [G] int32, assignment [G,M]
    int32), as gang/kernel.feasibility_plain (whose docstring gives the
    shapes): views of one uint8 buffer of ``gang.kernel.feasibility_layout(G,
    M)`` bytes, ``out`` when given (so the three fetch in one copy).  Every
    domain id must be in [0, ``D``).  ``variant`` forces a kernel shape
    (an index of FEAS_VARIANTS; ``feas_variant`` picks it otherwise)."""
    from kube_scheduler_simulator_tpu_torch.gang.kernel import feasibility_layout, feasibility_views

    G, M, R = req.shape
    N = free.shape[0]
    dt = free.dtype
    if dt not in (torch.float32, torch.float64):
        raise KernelArgumentError(f"the feasibility scan takes float32 or float64 capacities, got {dt}")
    want = dict(
        req=(req, (G, M, R), dt), valid=(valid, (G, M), torch.bool), free=(free, (N, R), dt),
        cnt_free=(cnt_free, (N,), dt), dom=(dom, (G, N), torch.int32),
    )
    a = GangFeasArgs()
    for name, (t, shape, tdt) in want.items():
        if tuple(t.shape) != shape:
            raise KernelArgumentError(f"{name} has shape {tuple(t.shape)}, the scan wants {shape}")
        setattr(a, name, _check(t, name, tdt))
    if N >= 1 << 30:
        raise KernelArgumentError(f"{N} nodes exceed the feasibility scan's 30-bit node index")
    v = feas_variant(N, R, dt) if variant is None else variant
    tg, npt = FEAS_VARIANTS[v]
    if npt and (R > FEAS_RC or N > tg * npt):
        raise KernelArgumentError(f"variant {v} ({tg} threads x {npt} nodes, {FEAS_RC} columns) cannot hold N {N}, R {R}")
    nbytes = feasibility_layout(G, M)
    dev = free.device
    if out is None:
        out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if out.dtype != torch.uint8 or out.shape != (nbytes,):
        raise KernelArgumentError(f"out must be uint8 [{nbytes}], got {out.dtype} {tuple(out.shape)}")
    _check(out, "out")
    feasible, distinct, assignment = feasibility_views(out, G, M)
    mc, smem, scratch_bytes = feas_memory(G, M, N, R, dt, v)
    a.G, a.M, a.N, a.R, a.variant, a.mc, a.smem = G, M, N, R, v, mc, smem
    a.feasible, a.distinct, a.assignment = feasible.data_ptr(), distinct.data_ptr(), assignment.data_ptr()
    if G == 0:
        return feasible, distinct, assignment
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev) if scratch_bytes else None
    a.scratch = scratch.data_ptr() if scratch is not None else None
    fn = getattr(build()["gang"], f"kss_gang_feasibility_{'f32' if dt == torch.float32 else 'f64'}")
    rc = fn(ctypes.byref(a), _stream(free))
    _raise_on(rc, "gang feasibility")
    LAUNCHES["gang_feasibility"] += 1
    return feasible, distinct, assignment
