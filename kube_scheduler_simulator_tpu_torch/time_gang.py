"""Time the gang kernels on one card: the window verdict K6 at cfg8-gang's
first dispatch (the kernel, and the whole dispatch: inputs in, kernel,
fetch), and the feasibility scan K7 at the preview's shape, at the JAX
bench's standalone dispatch and at a seeded G 256 x M 64 x N 5 000, with
the preview's whole dispatch (``run_feasibility``).

    python3 -m kube_scheduler_simulator_tpu_torch.time_gang --save FILE [--reps 200]
    python3 -m kube_scheduler_simulator_tpu_torch.time_gang --load FILE [--reps 200]
    python3 -m kube_scheduler_simulator_tpu_torch.time_gang --service [--waves 3]
    python3 -m kube_scheduler_simulator_tpu_torch.time_gang --variants [--reps 20]

``--save`` runs cfg8-gang (``workloads.gang_churn`` at its defaults: 200
jobs of 8-64 one-CPU members, plan seed 24, 220 bench nodes, 5 waves)
through a float32 ``SchedulerService`` on the card under
``gang_scheduler_config()`` for its first wave, keeps the first
``run_window_verdict`` call's arguments, then adds a PodGroup of 32
one-CPU members and keeps the arguments of the K7 launch that
``group_preview`` makes for it and the problem it dispatches, then encodes
the JAX bench's standalone feasibility dispatch on that store
(``bench.py:737-746``: 64 groups of 8-64 one-CPU members drawn from
``random.Random(25)``, the zone key) (numpy, in FILE), and times them;
``--load`` times FILE's.  The script reads nothing but the package's
``workloads``, ``ops.kernels``, ``gang`` and ``scheduler``, so run as a
file with another checkout's root on ``PYTHONPATH`` it times that
checkout's kernels on the same inputs (order parent, change, change,
parent in one call).

The card's name and power limit go on the first line, one JSON line after
it: each kernel's ms a launch (``timing.device_ms``: ``--reps`` launches
enqueued while the card sleeps, so they run back to back) and host ms a
call, the dispatches' host ms (``run_window_verdict`` on the saved host
arrays with ``dom`` resident, as the gang round calls it, and
``run_feasibility`` on the preview's problem: the mean of ``--reps``, each
ending in its fetch, with their host stages where the checkout's
functions take ``split``, and the copies between host and card that one
dispatch makes, counted by ``torch.profiler``), and a digest of each
kernel's outputs: two checkouts whose digests agree computed the same
bits.  ``--service`` times the service instead: cfg8-gang's first
``--waves`` waves, each wave's wall, ``gang_kernel_s`` and dispatches,
and their ratio (the dispatch's host ms as the service sees it), with
each dispatch's host stages (``run_window_verdict(split=)``) where the
checkout has them.  ``--variants`` times K7 at every kernel shape of
``kernels.FEAS_VARIANTS`` that holds the problem (``variant=``), on
seeded problems of M 64, R 2 and 3 at G 1, 64 and 256 and N 32 to 12 000
in both dtypes, and names the fastest at each (``kernels.FEAS_TABLE`` is
read off it); the whole table goes to chiprun_out/k7_variants.json.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import itertools
import json
import pickle
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from kube_scheduler_simulator_tpu_torch.gang import kernel as GK
from kube_scheduler_simulator_tpu_torch.ops import kernels as K

try:
    from kube_scheduler_simulator_tpu_torch.timing import device_ms
except ImportError:  # a checkout on PYTHONPATH from before timing.py
    from kube_scheduler_simulator_tpu_torch.time_preempt import device_ms  # type: ignore[no-redef]

# K7's seeded shape beside the preview's: (G, M, N, R, D, seed)
K7_WIDE = (256, 64, 5000, 2, 8, 301)
# the JAX bench's standalone feasibility dispatch (bench.py:737-746): its
# groups' seed (run_gang's seed 23, plus 2), count and member range
BENCH_FEAS = (25, 64, 8, 64)
# --variants: node counts, group counts and resource columns swept (M 64, D 8)
SWEEP_N = (32, 64, 128, 220, 256, 512, 1024, 2048, 4096, 5000, 8192, 12000)
SWEEP_G = (1, 64, 256)
SWEEP_R = (2, 3)


def seeded_feasibility(G, M, N, R, D, dt, device, seed):
    """Seeded feasibility-scan arguments: per group a prefix of valid member
    slots with a few holes, small integer requests (ties everywhere), free
    capacities from -1 to 11 (so some nodes are overcommitted), pod budgets
    0-5, group 0 asking more than any node has (infeasible); dom a hostname
    key when D == N, else n mod D."""
    rng = np.random.default_rng(seed)
    valid = (np.arange(M)[None, :] < rng.integers(1, M + 1, G)[:, None]) & (rng.random((G, M)) < 0.95)
    req = rng.integers(0, 3, (G, M, R))
    req[0] = 1000
    free = rng.integers(-1, 12, (N, R))
    cnt = rng.integers(0, 6, N)
    dom = np.tile(np.arange(N) % D, (G, 1))
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)  # noqa: E731
    return (f(req), torch.from_numpy(valid).to(device), f(free), f(cnt),
            torch.from_numpy(np.ascontiguousarray(dom, dtype=np.int32)).to(device), D)


def _service(store):
    from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService

    svc = SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0, device="cuda",
                           dtype=torch.float32)
    svc.start_scheduler(gang_scheduler_config())
    return svc


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def bench_problem(store):
    """The JAX bench's standalone feasibility dispatch on ``store``
    (``bench.py:737-746``): BENCH_FEAS' groups of one-CPU members under
    the zone key, over the store's nodes and bound pods."""
    from kube_scheduler_simulator_tpu_torch.gang.encode import encode_feasibility
    from kube_scheduler_simulator_tpu_torch.gang.scenario import make_member
    from kube_scheduler_simulator_tpu_torch.models.nodeinfo import build_node_infos

    seed, n_groups, lo, hi = BENCH_FEAS
    rng = random.Random(seed)
    groups = [[make_member(f"f{g}-m{m}", f"f{g}") for m in range(rng.randint(lo, hi))] for g in range(n_groups)]
    nis = build_node_infos(store.list("nodes", copy_objects=False), store.list("pods", copy_objects=False))
    return encode_feasibility(groups, ["topology.kubernetes.io/zone"] * n_groups, nis)


def capture(path: str) -> None:
    """cfg8-gang's first verdict dispatch and a 32-member preview's K7
    launch, kept in ``path``."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.gang import engine as GE
    from kube_scheduler_simulator_tpu_torch.gang.scenario import make_member
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    kept: dict = {}
    verdict, feas, run_feas = GK.run_window_verdict, GK.feasibility, GK.run_feasibility

    def keep_v(*args, **kw):
        kept.setdefault("verdict", tuple(_host(a) if not isinstance(a, int) else a for a in args))
        return verdict(*args, **kw)

    def keep_f(*args, **kw):
        kept.setdefault("feasibility", tuple(_host(a) if not isinstance(a, int) else a for a in args))
        return feas(*args, **kw)

    def keep_p(pr, *args, **kw):
        kept.setdefault("preview_problem", _problem(pr))
        return run_feas(pr, *args, **kw)

    store = ClusterStore(clock=lambda: 0.0)
    gen = workloads.gang_churn(store)
    next(gen)
    svc = _service(store)
    GK.run_window_verdict, GK.feasibility, GK.run_feasibility = keep_v, keep_f, keep_p
    try:
        svc.schedule_pending(max_rounds=3)
        store.create("podgroups", {"metadata": {"name": "preview-ok"}, "spec": {"minMember": 32}})
        for m in range(32):
            store.create("pods", make_member(f"preview-ok-m{m}", "preview-ok"))
        GE.group_preview(store, store.get("podgroups", "preview-ok"), device="cuda")
    finally:
        GK.run_window_verdict, GK.feasibility, GK.run_feasibility = verdict, feas, run_feas
    kept["bench_problem"] = _problem(bench_problem(store))
    gen.close()
    with open(path, "wb") as f:
        pickle.dump(kept, f)


def _problem(pr) -> SimpleNamespace:
    """The fields of a GangFeasibilityProblem that run_feasibility reads."""
    return SimpleNamespace(**{f: getattr(pr, f) for f in ("req", "valid", "free", "cnt_free", "dom", "D")})


def _tensors(pr, dt) -> tuple:
    """A problem's K7 arguments on the card in ``dt``."""
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device="cuda", dtype=dt)  # noqa: E731
    return (f(pr.req), torch.from_numpy(np.asarray(pr.valid, dtype=bool)).to("cuda"), f(pr.free), f(pr.cnt_free),
            torch.from_numpy(np.ascontiguousarray(pr.dom, dtype=np.int32)).to("cuda"), max(int(pr.D), 1))


def copies(fn) -> "dict | None":
    """The copies between host and card, and the kernels, that one call of
    ``fn`` makes, from torch.profiler's device events (None when it
    records none, the error when it fails)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    except Exception as e:  # the profiler is a measurement aid here, not the measurement
        return {"error": repr(e)[:200]}
    if not names:
        return None
    h2d = sum("HtoD" in n for n in names)
    d2h = sum("DtoH" in n for n in names)
    return {"h2d": h2d, "d2h": d2h, "other": len(names) - h2d - d2h}


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(np.ascontiguousarray(_host(t)).tobytes())
    return h.hexdigest()[:16]


def time_saved(path: str, reps: int) -> dict:
    """K6, its dispatch and K7 on ``path``'s inputs; K7 at K7_WIDE."""
    with open(path, "rb") as f:
        kept = pickle.load(f)
    gid, node, dom, prior, minm, D = kept["verdict"]
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to("cuda")  # noqa: E731
    vargs = (i32(gid), i32(node), i32(dom), i32(prior), i32(minm), D)
    k6_ms, k6_host_ms, out6 = device_ms(lambda: K.gang_verdict(*vargs), reps)
    dom_t = vargs[2]
    for _ in range(5):
        GK.run_window_verdict(gid, node, dom_t, prior, minm, D, device="cuda")
    t0 = time.perf_counter()
    for _ in range(reps):
        res = GK.run_window_verdict(gid, node, dom_t, prior, minm, D, device="cuda")
    dispatch_ms = 1e3 * (time.perf_counter() - t0) / reps
    k6_copies = copies(lambda: GK.run_window_verdict(gid, node, dom_t, prior, minm, D, device="cuda"))
    req, valid, free, cnt, fdom, fD = kept["feasibility"]
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device="cuda", dtype=torch.float32)  # noqa: E731
    fargs = (f32(req), torch.from_numpy(np.ascontiguousarray(valid)).to("cuda"), f32(free), f32(cnt), i32(fdom), fD)
    k7_ms, k7_host_ms, out7 = device_ms(lambda: K.gang_feasibility(*fargs), reps)
    G, M, N, R, WD, seed = K7_WIDE
    wargs = seeded_feasibility(G, M, N, R, WD, torch.float32, "cuda", seed)
    k7w_ms, k7w_host_ms, out7w = device_ms(lambda: K.gang_feasibility(*wargs), max(reps // 4, 5))
    bench = kept["bench_problem"]
    bargs = _tensors(bench, torch.float32)
    k7b_ms, k7b_host_ms, out7b = device_ms(lambda: K.gang_feasibility(*bargs), max(reps // 4, 5))
    # the preview's whole dispatch, as group_preview makes it
    pr = kept["preview_problem"]
    for _ in range(5):
        GK.run_feasibility(pr, device="cuda")
    t0 = time.perf_counter()
    for _ in range(reps):
        fres = GK.run_feasibility(pr, device="cuda")
    feas_dispatch_ms = 1e3 * (time.perf_counter() - t0) / reps
    stages = None
    if "split" in inspect.signature(GK.run_feasibility).parameters:
        splits = [{} for _ in range(reps)]
        for sp in splits:
            GK.run_feasibility(pr, device="cuda", split=sp)
        stages = {k: float(np.median([1e6 * sp[k] for sp in splits])) for k in splits[0]}
    return {
        "K6": {"shape": f"K={len(gid)} G={dom.shape[0]} N={dom.shape[1]} D={D}", "ms": k6_ms, "host_ms": k6_host_ms,
               "dispatch_ms": dispatch_ms, "copies": k6_copies, "digest": _digest(out6),
               "dispatch_digest": _digest((res["feasible"], res["distinct_domains"], res["placed"]))},
        "K7_preview": {"shape": f"G={req.shape[0]} M={req.shape[1]} N={free.shape[0]} R={free.shape[1]} D={fD}",
                       "ms": k7_ms, "host_ms": k7_host_ms, "digest": _digest(out7),
                       "dispatch_ms": feas_dispatch_ms, "dispatch_stages_us": stages,
                       "copies": copies(lambda: GK.run_feasibility(pr, device="cuda")),
                       "dispatch_digest": _digest((fres["feasible"], fres["distinct_domains"], fres["assignment"]))},
        "K7_bench": {"shape": "G={} M={} N={} R={} D={}".format(*bench.req.shape[:2], *bench.free.shape, bench.D),
                     "ms": k7b_ms, "host_ms": k7b_host_ms, "digest": _digest(out7b)},
        "K7_wide": {"shape": f"G={G} M={M} N={N} R={R} D={WD}", "ms": k7w_ms, "host_ms": k7w_host_ms,
                    "digest": _digest(out7w)},
        "reps": reps,
    }


def variants(reps: int) -> dict:
    """K7 at every kernel shape that holds each swept problem: ms a launch
    by variant, the fastest, and the variant ``feas_variant`` picks."""
    import os

    from kube_scheduler_simulator_tpu_torch.gang.kernel import feasibility_plain

    rows = []
    for dt, r in itertools.product((torch.float32, torch.float64), SWEEP_R):
        for n in SWEEP_N:
            for g in SWEEP_G:
                # group 0 of a seeded problem fits nowhere: drop it
                req, valid, free, cnt, dom, D = seeded_feasibility(g + 1, 64, n, r, 8, dt, "cuda", seed=n + g)
                args = (req[1:], valid[1:], free, cnt, dom[1:], D)
                want = _digest(feasibility_plain(*args))
                ms = {}
                for v, (tg, npt) in enumerate(K.FEAS_VARIANTS):
                    if npt and n > tg * npt:
                        continue
                    t, _h, out = device_ms(lambda: K.gang_feasibility(*args, variant=v), reps)
                    if _digest(out) != want:
                        raise AssertionError(f"K7 variant {v} differs from the plain version at G {g} N {n} R {r} {dt}")
                    ms[v] = t
                best = min(ms, key=ms.get)
                rows.append({"dtype": str(dt).split(".")[-1], "R": r, "N": n, "G": g, "ms": ms, "fastest": best,
                             "picked": K.feas_variant(n, r, dt)})
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/k7_variants.json", "w") as f:
        json.dump({"variants": K.FEAS_VARIANTS, "rows": rows}, f)
    return {"fastest": [(r["dtype"], r["R"], r["N"], r["G"], r["fastest"], round(r["ms"][r["fastest"]], 5),
                         r["picked"], round(r["ms"][r["picked"]], 5)) for r in rows]}


def service(waves: int) -> dict:
    """cfg8-gang's first ``waves`` waves through a float32 service on the
    card: per wave the wall, gang_kernel_s and dispatches; with a checkout
    whose ``run_window_verdict`` takes ``split``, each dispatch's host
    stages (their medians in µs over the dispatches after the first)."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    splits: list = []
    dispatch = GK.run_window_verdict
    if "split" in inspect.signature(dispatch).parameters:
        def timed(*args, **kw):
            splits.append({})
            return dispatch(*args, **kw, split=splits[-1])

        GK.run_window_verdict = timed
    store = ClusterStore(clock=lambda: 0.0)
    svc, rows = None, []
    gen = workloads.gang_churn(store)
    try:
        for w in gen:
            if svc is None:
                svc = _service(store)
            s0, d0 = svc.stats["gang_kernel_s"], svc.stats["gang_kernel_dispatches"]
            t0 = time.perf_counter()
            svc.schedule_pending(max_rounds=3)
            rows.append({"wave": w, "wall_s": time.perf_counter() - t0,
                         "gang_kernel_s": svc.stats["gang_kernel_s"] - s0,
                         "dispatches": svc.stats["gang_kernel_dispatches"] - d0})
            if len(rows) >= waves:
                break
    finally:
        GK.run_window_verdict = dispatch
    gen.close()
    s, d = sum(r["gang_kernel_s"] for r in rows), sum(r["dispatches"] for r in rows)
    timed_splits = [x for x in splits[1:] if x]  # the card's dispatches after the process's first
    stages = {k: float(np.median([1e6 * x[k] for x in timed_splits])) for k in ("stage_s", "launch_s", "wait_s", "views_s")
              } if timed_splits else None
    return {"shape": f"cfg8-gang, first {len(rows)} waves", "waves": rows, "gang_kernel_s": s, "dispatches": d,
            "dispatch_ms": 1e3 * s / d if d else None, "mismatches": svc.stats["gang_verdict_mismatch"],
            "stages_us": stages, "pending": sum(bool(x.get("pending")) for x in splits)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save", help="run cfg8-gang's first wave, keep its first dispatch and a preview here, time them")
    ap.add_argument("--load", help="time the inputs kept here")
    ap.add_argument("--service", action="store_true", help="time cfg8-gang's first waves through the service")
    ap.add_argument("--variants", action="store_true", help="time K7 at every kernel shape on seeded problems")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--waves", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_gang: no CUDA device", file=sys.stderr)
        return 2
    if (bool(args.save) + bool(args.load) + args.service + args.variants) != 1:
        ap.error("give one of --save, --load, --service and --variants")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    K.build()
    if args.service:
        print(json.dumps(service(args.waves)), flush=True)
        return 0
    if args.variants:
        print(json.dumps(variants(args.reps)), flush=True)
        return 0
    if args.save:
        capture(args.save)
    print(json.dumps(time_saved(args.save or args.load, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
