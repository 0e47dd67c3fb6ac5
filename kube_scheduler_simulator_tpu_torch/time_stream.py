"""Time cfg9-stream through the port's service on one card: the JAX
package's bench ``run_stream_report`` at its full sizing.

    python3 -m kube_scheduler_simulator_tpu_torch.time_stream [--parent DIR] [--rehearse]

cfg9-stream (``workloads.stream_cluster`` / ``steady_feed``): 600 bench
nodes, 6 000 bound bench pods (spread constraints on every 3rd), then a
stream of ticks, each creating 100 pods and deleting 100 settled ones,
through ``SchedulerService(store, tie_break="first", use_batch="force")``
in float32.  Each run builds a fresh cluster, primes one tick through its
mode's own path (the kernels' first launches, the cold encode), then times
320 ticks.  Three modes, the minimum wall of 2 runs each, in turns
(sequential, stream_off, streamed, streamed, stream_off, sequential):

- ``sequential``: feed a tick, drain it with ``schedule_pending``, repeat;
- ``stream_off``: ``schedule_stream(streaming=False)``, the admission loop
  with the overlap off;
- ``streamed``: ``schedule_stream(streaming=True)``, wave k+1's encode,
  upload and launch overlapping wave k's kernel and commit.

Printed, per mode (the min-wall run's): wall, pods/s, the stream counters
(``stream_overlap_s``, ``stream_stall_s``, overlap efficiency =
overlap / (overlap + stall), drains by reason), the wave profiler's stages
(totals, and the streamed waves' mean and max ``upload``), the encoder's
delta counters, the placer's decisions, and a sha256 of ``pod_parity_state``
of the final store: the three must be equal, or the script exits 1.

The card's name and power limit go on the first line, one JSON line at the
end.  ``--parent DIR`` also times another checkout's ``sequential`` mode (a
checkout from before the stream path has only that), in a child process
with DIR first on ``PYTHONPATH``, before and after this checkout's modes;
the feed and the digest come from this checkout's ``workloads.py`` and
``utils/parity.py`` (plain Python, loaded by path), so both trees see the
same stream.  ``--rehearse`` runs on the CPU in float64 at a small size (40
nodes, 300 bound pods, 20 a tick, 6 ticks, one run a mode).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
MODES = ("sequential", "stream_off", "streamed")
STAGES = ("admit", "encode", "upload", "dispatch", "device_blocked", "trace_fetch", "annotate", "commit",
          "store_mutate", "queue_maint", "host_other")


def _own(rel: str):
    """A plain-Python module of THIS checkout, loaded by path (a parent
    checkout first on sys.path would shadow it under the package's name)."""
    spec = importlib.util.spec_from_file_location(f"_time_stream_{Path(rel).stem}", HERE / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _own("workloads.py")
PARITY = _own("utils/parity.py")
FULL = dict(W.STREAM, runs=2)
CUT = dict(n_nodes=40, seed_bound=300, per_tick=20, ticks=6, runs=1)


def _stages(svc) -> dict:
    st = svc.profiler.snapshot()["stages"]
    return {s: (st[s]["count"], st[s]["total_s"], st[s]["max_s"]) for s in STAGES if s in st}


def run_mode(mode: str, size: dict, device: str, dt) -> dict:
    """One run of ``mode`` on a fresh cfg9-stream cluster: a priming tick,
    then ``size["ticks"]`` timed ticks."""
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    store = ClusterStore(clock=lambda: 1_700_000_000.0)
    settled = W.stream_cluster(store, size["n_nodes"], size["seed_bound"])
    svc = SchedulerService(store, tie_break="first", use_batch="force", device=device, dtype=dt)
    svc.start_scheduler(None)

    def feed(n_ticks: int, start: int):
        return W.steady_feed(store, settled, n_ticks, start, size["per_tick"], size["seed_bound"])

    def drive(f) -> dict:
        if mode == "sequential":
            tick, alive, results = 0, True, {}
            while alive:
                alive = f(tick)
                tick += 1
                results.update(svc.schedule_pending())
            return results
        return svc.schedule_stream(feed=f, streaming=mode == "streamed")

    drive(feed(1, 0))
    eng = svc._batch_engine
    enc0 = eng.encode_stats()
    st0 = _stages(svc)
    # a checkout from before the stream path has no stream counters
    keys = ("stream_waves", "stream_pods", "stream_overlap_s", "stream_stall_s")
    s0 = {k: svc.stats.get(k, 0) for k in keys}
    d0 = dict(svc.stats.get("stream_drains", {}))
    pl = eng._placer
    pl0 = (pl.plane_reuses, pl.scatter_updates, pl.full_uploads, pl.bytes_uploaded)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = drive(feed(size["ticks"], size["per_tick"]))
    wall = time.perf_counter() - t0
    st1 = _stages(svc)
    stages = {s: {"count": c - st0.get(s, (0, 0.0, 0.0))[0], "total_s": tot - st0.get(s, (0, 0.0, 0.0))[1],
                  "max_s": mx} for s, (c, tot, mx) in st1.items()}
    stream = {k: svc.stats.get(k, 0) - s0[k] for k in s0}
    boundary = stream["stream_overlap_s"] + stream["stream_stall_s"]
    drains = {r: n - d0.get(r, 0) for r, n in svc.stats.get("stream_drains", {}).items() if n - d0.get(r, 0)}
    enc1 = eng.encode_stats()
    up = stages.get("upload", {"count": 0, "total_s": 0.0, "max_s": 0.0})
    return {
        "mode": mode,
        "wall_s": wall,
        "scheduled": sum(1 for r in results.values() if r.success),
        "attempted": len(results),
        "pods_per_s": sum(1 for r in results.values() if r.success) / wall,
        **stream,
        "overlap_efficiency": stream["stream_overlap_s"] / boundary if boundary > 0 else 0.0,
        "stream_drains": drains,
        "batch_fallbacks": dict(svc.stats["batch_fallbacks"]),
        "sequential_pods": svc.stats["sequential_pods"],
        "f64_promotions": dict(svc.stats["f64_promotions"]),
        "stages": stages,
        "upload_mean_ms": 1e3 * up["total_s"] / up["count"] if up["count"] else 0.0,
        "upload_max_ms": 1e3 * up["max_s"],
        "encode_counters": {k: enc1[k] - enc0.get(k, 0) for k in enc1 if k.startswith("encode_")
                            and isinstance(enc1[k], (int, float))},
        "placer": {"reuses": pl.plane_reuses - pl0[0], "scatters": pl.scatter_updates - pl0[1],
                   "full_uploads": pl.full_uploads - pl0[2], "bytes_uploaded": pl.bytes_uploaded - pl0[3],
                   "last_decisions": {f"{k[0]}" + (f"[{k[1]}]" if k[1] is not None else ""): v[0]
                                      for k, v in pl.decisions.items()}},
        "pods": len(store.list("pods", copy_objects=False)),
        "digest": PARITY.parity_digest(store),
    }


def run_modes(modes, size: dict, device: str, dt) -> dict:
    """The minimum-wall run of each mode (its counters and digest are that
    run's), every run's wall beside it.  The modes run in turns, forward
    then backward (a, b, c, c, b, a), each run after a full collection, so
    neither the process's warm-up nor an earlier run's garbage lands on one
    mode."""
    by_mode: dict = {m: [] for m in modes}
    for r in range(size["runs"]):
        for mode in modes if r % 2 == 0 else modes[::-1]:
            gc.collect()
            by_mode[mode].append(run_mode(mode, size, device, dt))
    out = {}
    for mode in modes:
        runs = by_mode[mode]
        best = min(runs, key=lambda r: r["wall_s"])
        best["walls_s"] = [r["wall_s"] for r in runs]
        best["digests_agree"] = len({r["digest"] for r in runs}) == 1
        out[mode] = best
        print(f"{mode}: walls {best['walls_s']} pods/s {best['pods_per_s']:.1f} overlap "
              f"{best['stream_overlap_s']:.3f} s stall {best['stream_stall_s']:.3f} s efficiency "
              f"{best['overlap_efficiency']:.3f} drains {best['stream_drains']} upload mean "
              f"{best['upload_mean_ms']:.3f} ms max {best['upload_max_ms']:.3f} ms digest {best['digest'][:16]}",
              flush=True)
    return out


def parent_sequential(parent: str, rehearse: bool) -> dict:
    """The parent checkout's sequential mode, in a child process with the
    parent's root first on PYTHONPATH."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(Path(parent).resolve()), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--modes", "sequential"] + (["--rehearse"] if rehearse else [])
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=3000)
    if proc.returncode != 0:
        raise RuntimeError(f"the parent's run failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["modes"]["sequential"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true", help="on the CPU in float64, at a small size")
    ap.add_argument("--parent", help="another checkout's root: time its sequential mode too")
    ap.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    args = ap.parse_args()
    if args.rehearse:
        device, dt, size = "cpu", torch.float64, CUT
        card = "cpu (rehearsal)"
    else:
        if not torch.cuda.is_available():
            print("time_stream: no CUDA device", file=sys.stderr)
            return 2
        device, dt, size = "cuda", torch.float32, FULL
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip()
        from kube_scheduler_simulator_tpu_torch.ops import kernels as K

        K.build()
    print(card, flush=True)
    import kube_scheduler_simulator_tpu_torch as pkg

    out = {"card": card, "device": device, "dtype": str(dt).split(".")[-1], "size": size,
           "package": str(Path(pkg.__file__).resolve().parent)}
    if args.parent:
        out["parent_before"] = parent_sequential(args.parent, args.rehearse)
    out["modes"] = run_modes(args.modes, size, device, dt)
    if args.parent:
        out["parent_after"] = parent_sequential(args.parent, args.rehearse)
    digests = {m: r["digest"] for m, r in out["modes"].items()}
    digests.update({k: out[k]["digest"] for k in ("parent_before", "parent_after") if k in out})
    out["digests_equal"] = len(set(digests.values())) == 1 and all(r["digests_agree"] for r in out["modes"].values())
    print(json.dumps(out), flush=True)
    if not out["digests_equal"]:
        print(f"time_stream: the final stores differ: {digests}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
