"""Time the commit of the churn and gang waves through the service on one
card: each wave's wall and ``commit_s``, the wave profiler's stages
(``annotate``: the bulk commit's render of the annotation documents;
``store_mutate``: the store's writes, the result history among them), and
two stages this script times itself on every path, the gang members' too:
``render_s`` (inside ``BatchResult.materialize_wave`` and the per-pod pair
functions) and ``history_s`` (inside the reflector's ``_updated_history``),
with a digest of every pod's node and annotations after each wave.

    python3 -m kube_scheduler_simulator_tpu_torch.time_commit [--rehearse]

cfg5-churn: ``workloads.churn`` at BASELINE cfg5's size (5 000 nodes, 10 000
pods in 5 waves, 10 % of the bound pods deleted after each wave, a rolling
cordon of 50 nodes) through ``SchedulerService(store, tie_break="first",
use_batch="auto")`` in float32, one ``schedule_pending(max_rounds=1)`` a
wave; cfg8-gang: ``workloads.gang_churn`` at its defaults (200 jobs of 8-64
one-CPU members, 220 nodes, 5 waves) under ``gang_scheduler_config()``,
``batch_min_work=0``, one ``schedule_pending(max_rounds=3)`` a wave.  Both
stores run on a frozen clock, so two checkouts that render the same bytes
print the same digests.

The card's name and power limit go on the first line, one JSON line after
it, with the C renderer's status where the checkout has one (``renderer``:
None before it was ported).  The script reads nothing but the package's
``workloads``, ``gang``, ``ops.kernels`` and ``scheduler``, so run as a file
with another checkout's root on ``PYTHONPATH`` it times that checkout
(order parent, change, change, parent in one call).  ``--rehearse`` runs
it on the CPU in float64 at a small size (1 200 pods on 400 nodes in 3
churn waves; 24 jobs of 2-8 members on 40 nodes in 3 gang waves).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys
import time

import torch

from kube_scheduler_simulator_tpu_torch import workloads
from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config
from kube_scheduler_simulator_tpu_torch.ops import kernels as K
from kube_scheduler_simulator_tpu_torch.plugins import storereflector as SR
from kube_scheduler_simulator_tpu_torch.scheduler import batch_engine as BE
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

# (pods, nodes, waves, cordoned nodes) and gang_churn's arguments, at full
# size and cut for a CPU rehearsal
CHURN = (10000, 5000, 5, 50)
GANG = dict(jobs=200, min_members=8, max_members=64, nodes=220, waves=5, seed=24)
CHURN_CUT = (1200, 400, 3, 10)
GANG_CUT = dict(jobs=24, min_members=2, max_members=8, nodes=40, waves=3, seed=23)
STAGES = ("annotate", "store_mutate", "commit", "encode", "device_blocked", "trace_fetch")


def renderer() -> "dict | None":
    """The C renderer's status, or None where the checkout has none."""
    try:
        from kube_scheduler_simulator_tpu_torch import native
    except ImportError:
        return None
    st = native.status()
    return {k: st.get(k) for k in ("loaded", "path", "reason", "build_s", "built", "include", "python_h")}


# seconds inside the renderer's and the history writer's entry points,
# while ``timed_entry_points`` is open
SPENT = {"render_s": 0.0, "history_s": 0.0}
TIMED = [(BE.BatchResult, name, "render_s")
         for name in ("materialize_wave", "filter_annotation_pair", "score_annotations_pairs")]
TIMED.append((SR, "_updated_history", "history_s"))


@contextlib.contextmanager
def timed_entry_points():
    """Wrap the entry points of ``TIMED`` to add their seconds to
    ``SPENT``, and restore them on exit."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _key in TIMED]
    for (owner, name, fn), (_o, _n, key) in zip(saved, TIMED):

        def timed(*args, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                SPENT[_key] += time.perf_counter() - t0

        setattr(owner, name, timed)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def pods_digest(store) -> str:
    rows = sorted(
        (p["metadata"]["name"], (p.get("spec") or {}).get("nodeName"), p["metadata"].get("annotations") or {})
        for p in store.list("pods", copy_objects=False)
    )
    return hashlib.sha256(json.dumps(rows, sort_keys=True).encode()).hexdigest()


def _stage_totals(svc) -> dict:
    st = svc.profiler.snapshot()["stages"]
    return {s: st[s]["total_s"] for s in STAGES if s in st}


def drive(svc_of, gen, max_rounds: int, waves: int) -> list:
    """Schedule each of the ``waves`` waves ``gen`` yields: its wall,
    commit_s, the stages' seconds and the pods' digest."""
    svc, rows = None, []
    for w in gen:
        if svc is None:
            svc = svc_of()
        c0, s0, p0 = svc.stats["commit_s"], _stage_totals(svc), dict(SPENT)
        t0 = time.perf_counter()
        svc.schedule_pending(max_rounds=max_rounds)
        wall = time.perf_counter() - t0
        s1 = _stage_totals(svc)
        rows.append({"wave": w, "wall_s": wall, "commit_s": svc.stats["commit_s"] - c0,
                     **{k: SPENT[k] - p0[k] for k in SPENT}, "stages": {s: s1[s] - s0.get(s, 0.0) for s in s1},
                     "pods_digest": pods_digest(svc.cluster_store), "fallbacks": dict(svc.stats["batch_fallbacks"])})
        if len(rows) >= waves:
            break
    gen.close()
    return rows


def churn(spec, device: str, dt) -> list:
    pods, n_nodes, n_waves, cordon = spec
    store = ClusterStore(clock=lambda: 0.0)

    def svc_of():
        svc = SchedulerService(store, tie_break="first", use_batch="auto", device=device, dtype=dt)
        svc.start_scheduler(None)
        return svc

    return drive(svc_of, workloads.churn(store, pods, n_nodes, n_waves, cordon=cordon), 1, n_waves)


def gang(spec, device: str, dt) -> list:
    store = ClusterStore(clock=lambda: 0.0)

    def svc_of():
        svc = SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0, device=device, dtype=dt)
        svc.start_scheduler(gang_scheduler_config())
        return svc

    return drive(svc_of, workloads.gang_churn(store, **spec), 3, spec["waves"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true", help="on the CPU in float64, at a small size")
    args = ap.parse_args()
    if args.rehearse:
        device, dt = "cpu", torch.float64
        print("cpu", flush=True)
    else:
        if not torch.cuda.is_available():
            print("time_commit: no CUDA device", file=sys.stderr)
            return 2
        device, dt = "cuda", torch.float32
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        print(smi.stdout.strip(), flush=True)
        K.build()
    out = {"renderer": renderer(), "device": device, "dtype": str(dt).split(".")[-1]}
    with timed_entry_points():
        out["churn"] = churn(CHURN_CUT if args.rehearse else CHURN, device, dt)
        out["gang"] = gang(GANG_CUT if args.rehearse else GANG, device, dt)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
