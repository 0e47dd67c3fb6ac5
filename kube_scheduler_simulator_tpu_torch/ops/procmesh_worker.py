"""A worker process of the scan ensemble (``KSS_MESH_PROCESSES``).

Port of the JAX package's ``ops/procmesh_worker.py``.  ``ops.procmesh``'s
``ProcMeshPool`` starts N of these and drives them over pipes; the parent
stays outside the ensemble.  A worker runs on the parent engine's device
(``--device``: ``cuda:<i>`` or ``cpu``) and never on another: a worker
asked for a card that it cannot see fails its handshake.

Workers **load, never compile**: on the card ``load_scan`` takes every
kernel library through ``kernels.build(compile=False)``, so the libraries
come from the kernel-library cache (``KSS_AOT_CACHE_DIR``, ops/aot.py; in a
worker without ``nvcc`` its entries load with the toolchain unverified) or
from the build directory, and never from the compiler.  A missing or
rejected entry is a counted pool fallback (``artifact_missing:<reasons>``,
the cache's fallback reasons), never a build.  On the CPU the scan is the
plain version and there is nothing to load.

Protocol (length-prefixed pickle frames; commands on stdin, replies on
the ``--out-fd`` pipe, so a stray write to stdout never corrupts the
channel):

- ``init`` handshake (automatic): rank, generation, processes and device;
- ``probe``: N=1, a computation on the worker's device; N>=2,
  ``torch.distributed`` over gloo, initialized from ``--coordinator``,
  and an ``all_gather`` round trip;
- ``load_scan``: resolve the scan for a shape (memoized); N>=2 replies
  ``sharded_scan_unported`` (the node axis sharded over the ranks is not
  ported yet);
- ``run``: place the shipped host planes on the device, run the scan
  (``ops/batch.build_batch_fn``: ``kernels.scan``, csrc/scan.cu, on the
  card) and reply its outputs as numpy, with this process's
  ``kernels.LAUNCHES`` and ``kernels.DEGRADES`` deltas and its seconds;
- ``ping``; ``quit`` / EOF: exit.

Every reply is ``{"ok": bool, ...}``; a failure carries a short
``reason`` and the exception's type (``error``), which the pool counts,
and ``kernel_error`` where a kernel library or a kernel's own launch failed
(``KernelBuildError``, ``KernelLaunchError``, ``KernelArgumentError``),
which the pool raises in the parent as the in-process scan raises it.

The worker starts as ``python -c <MAIN> kss-torch-shard-worker <flags>``
(``command``): its command line names the port's marker and not the bytes
``ops.procmesh_worker``, which the JAX package's no-leak scan looks for,
so neither package's leak scan (``fuzz.chaos.leaked_worker_pids``) counts
the other's workers.
"""

from __future__ import annotations

import argparse
import os
import pickle
import struct
import sys
import time
from typing import Any

# the argv word that marks a port worker's command line (fuzz/chaos.py's
# leak scan matches it)
MARKER = "kss-torch-shard-worker"
_MAIN = (
    "import sys; from kube_scheduler_simulator_tpu_torch.ops import procmesh_worker as w; "
    "sys.exit(w.main(sys.argv[2:]))"
)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def command(rank: int, nprocs: int, coordinator: str, out_fd: int, generation: int, device: str) -> list[str]:
    """The worker's command line; ``--owner`` names the process that started
    it (the leak scan's default looks for this process's workers only)."""
    return [
        sys.executable, "-c", _MAIN, MARKER,
        "--rank", str(rank), "--nprocs", str(nprocs), "--coordinator", coordinator,
        "--out-fd", str(out_fd), "--generation", str(generation), "--device", device, "--owner", str(os.getpid()),
    ]


def environment(base: "dict[str, str]") -> "dict[str, str]":
    """The worker's environment: the parent's, with this package's root on
    ``PYTHONPATH`` (the worker imports it from any working directory)."""
    env = dict(base)
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([_ROOT] + [p for p in paths if p != _ROOT])
    return env


def read_frame(f) -> "Any | None":
    """One length-prefixed pickle frame; None on EOF."""
    hdr = f.read(8)
    if len(hdr) < 8:
        return None
    (n,) = struct.unpack("<Q", hdr)
    buf = f.read(n)
    if len(buf) < n:
        return None
    return pickle.loads(buf)


def write_frame(f, obj: Any) -> int:
    """Write one frame; returns its payload bytes."""
    b = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(struct.pack("<Q", len(b)))
    f.write(b)
    f.flush()
    return len(b)


def _err(stage: str, e: BaseException) -> dict:
    reply = {"ok": False, "stage": stage, "reason": f"{type(e).__name__}: {e}", "error": type(e).__name__}
    K = sys.modules.get("kube_scheduler_simulator_tpu_torch.ops.kernels")
    if K is not None:
        for cls in (K.KernelArgumentError, K.KernelLaunchError, K.KernelBuildError):
            if isinstance(e, cls):
                reply["kernel_error"] = cls.__name__
                break
    return reply


def _probe(dev, rank: int, nprocs: int, coordinator: str, timeout_s: float) -> dict:
    """N=1: a computation on the device; N>=2: a gloo ``all_gather`` of
    every rank's number across the ensemble."""
    import datetime

    import torch

    if nprocs == 1:
        v = float(torch.sum(torch.arange(8, dtype=torch.float32, device=dev) * 2, dtype=torch.float32))
        return {"ok": v == 56.0, "reason": None if v == 56.0 else "bad local compute"}
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}", world_size=nprocs, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    cpu = torch.device("cpu")  # gloo gathers host tensors
    got = [torch.zeros(1, dtype=torch.float32, device=cpu) for _ in range(nprocs)]
    dist.all_gather(got, torch.tensor([float(rank)], dtype=torch.float32, device=cpu))
    ok = [float(t) for t in got] == [float(r) for r in range(nprocs)]
    return {"ok": ok, "reason": None if ok else "all_gather value mismatch"}


def _load_scan(msg: dict, state: dict, dev, nprocs: int) -> dict:
    """Resolve the scan for a shape, loading never compiling."""
    from kube_scheduler_simulator_tpu_torch.ops import aot
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    key = msg["key"]
    if key in state["scans"]:
        return {"ok": True, "cached": True}
    if nprocs > 1:
        return {"ok": False, "reason": "sharded_scan_unported"}
    rec: dict = {"ok": True, "cached": False}
    if dev.type == "cuda":
        os.environ["KSS_AOT_CACHE_DIR"] = msg["cache_dir"]
        builds0 = dict(K.BUILDS)
        t0 = time.perf_counter()
        try:
            K.build(compile=False)
        except K.KernelBuildError:
            reasons = aot.stats()["aot_cache_fallbacks_by_reason"]
            return {"ok": False, "reason": f"artifact_missing:{';'.join(sorted(reasons)) or 'absent'}"}
        rec.update(load_s=time.perf_counter() - t0, builds={k: K.BUILDS[k] - builds0[k] for k in K.BUILDS},
                   cache=aot.stats())
    state["scans"][key] = msg["meta"]
    return rec


def _run(msg: dict, state: dict, dev) -> dict:
    """Place the shipped host planes, run the scan, reply numpy."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import batch as B
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    meta = state["scans"].get(msg["key"])
    if meta is None:
        return {"ok": False, "reason": "scan not loaded"}
    launches0, degrades0 = dict(K.LAUNCHES), dict(K.DEGRADES)
    t0 = time.perf_counter()
    dp = B.place(msg["host"], dev)
    weights = B.weight_row(msg["weights"], getattr(torch, meta["dtype"]), dev)
    t1 = time.perf_counter()
    out = B.build_batch_fn(meta["cfg"], meta["dims"], ws0=meta["ws0"], weights=weights)(dp)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    host = {k: v.cpu().numpy() for k, v in out.items() if torch.is_tensor(v)}
    t3 = time.perf_counter()
    return {
        "ok": True, "out": host,
        "launches": {k: n - launches0[k] for k, n in K.LAUNCHES.items() if n != launches0[k]},
        "degrades": {k: n - degrades0.get(k, 0) for k, n in K.DEGRADES.items() if n != degrades0.get(k, 0)},
        "seconds": {"place_s": t1 - t0, "scan_s": t2 - t1, "fetch_s": t3 - t2},
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog=MARKER)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out-fd", type=int, required=True)
    # ensemble generation: 0 at bring-up, bumped a supervised respawn;
    # echoed in the handshake and every ping
    ap.add_argument("--generation", type=int, default=0)
    # the parent engine's device, always named: a worker never picks one
    ap.add_argument("--device", required=True)
    ap.add_argument("--owner", type=int, default=0)  # read by the leak scan only
    args = ap.parse_args(argv)
    out = os.fdopen(args.out_fd, "wb")
    inp = sys.stdin.buffer
    try:
        import torch

        dev = torch.device(args.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"asked for {dev}, but torch.cuda.is_available() is False")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
    except Exception as e:  # noqa: BLE001 - the handshake carries the reason
        write_frame(out, _err("init", e))
        return 1
    timeout_s = float(os.environ.get("KSS_PROCMESH_TIMEOUT_S", "30"))
    write_frame(out, {
        "ok": True, "stage": "init", "rank": args.rank, "generation": args.generation,
        "processes": args.nprocs, "device": str(dev), "pid": os.getpid(),
    })
    state: dict = {"scans": {}}
    while True:
        msg = read_frame(inp)
        if msg is None or msg.get("cmd") == "quit":
            break
        try:
            cmd = msg["cmd"]
            if cmd == "ping":
                reply = {"ok": True, "rank": args.rank, "generation": args.generation}
            elif cmd == "probe":
                reply = _probe(dev, args.rank, args.nprocs, args.coordinator, timeout_s)
            elif cmd == "load_scan":
                reply = _load_scan(msg, state, dev, args.nprocs)
            elif cmd == "run":
                reply = _run(msg, state, dev)
            else:
                reply = {"ok": False, "reason": f"unknown command {cmd!r}"}
        except Exception as e:  # noqa: BLE001 - degrade, never crash the channel
            reply = _err(msg.get("cmd", "?"), e)
        write_frame(out, reply)
    return 0
