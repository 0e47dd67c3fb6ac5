"""``python -m kube_scheduler_simulator_tpu_torch.fuzz [--device cpu]``: the
bounded fuzz sweep, then the KernelChaos leg (``fuzz/smoke.py``), on the card
unless ``--device cpu``.  The ``KSS_FUZZ_*`` knobs apply: ``KSS_FUZZ_SEED``
(0), ``KSS_FUZZ_SCENARIOS`` (25), ``KSS_FUZZ_SHRINK_STEPS`` (192) and
``KSS_FUZZ_BUDGET`` (seconds; 0 is the bounded sweep).  The report goes into
a service's ``note_fuzz_report`` and must show in its rendered metrics.  The
last line is the report as JSON; the exit code is 0 when every scenario was
at parity and the chaos leg tripped and was counted, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kube_scheduler_simulator_tpu_torch.fuzz")
    ap.add_argument("--device", default=None, help="the services' device (default: the card)")
    args = ap.parse_args(argv)

    from kube_scheduler_simulator_tpu_torch.fuzz import smoke
    from kube_scheduler_simulator_tpu_torch.fuzz.runner import FuzzHarness, fuzz_knobs
    from kube_scheduler_simulator_tpu_torch.ops import kernels
    from kube_scheduler_simulator_tpu_torch.server.metrics import render_metrics

    knobs = fuzz_knobs()
    t0 = time.monotonic()
    harness = FuzzHarness(args.device)
    kernels.reset_counts()
    report = smoke.sweep(harness, knobs, log=lambda m: print(m, file=sys.stderr))
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    chaos = smoke.chaos_leg(harness, knobs["seed"])
    report["scenarios"] += 1
    failed = list(report["failures"])
    if chaos["divergences"] or chaos["trips"] < 2 or not chaos["kernel_errors"]:
        failed.append({"chaos": chaos})

    store, svc = harness.service("default", "batch")
    svc.note_fuzz_report(report)

    class _DI:
        cluster_store = store

        def scheduler_service(self):
            return svc

    text = render_metrics(_DI())
    missing = [n for n in ("simulator_fuzz_scenarios_total", "simulator_fuzz_divergences_total",
                           "simulator_fuzz_shrink_steps_total") if n not in text]
    if missing:
        failed.append({"metrics missing": missing})
    out = {
        "ok": not failed,
        "device": str(harness.device),
        "scenarios": report["scenarios"],
        "divergences": report["divergences"],
        "shrink_steps": report["shrink_steps"],
        "compiles_after_first": report["compiles"],
        "launches": launches,
        "chaos": chaos,
        "failures": failed,
        "coverage": report["coverage"],
        "wall_s": time.monotonic() - t0,
    }
    print(json.dumps(out, sort_keys=True))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
