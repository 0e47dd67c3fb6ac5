"""The kernel-contract checker CLI: AST rules + baseline.

    python -m kube_scheduler_simulator_tpu_torch.analysis [--selftest] [--json]
        [--rules A,B] [--no-baseline]

Modes (the JAX package's ``scripts/check_contracts.py``, over the port):

- default            — run every rule over the live tree (the port package
                       and chip_smoke.py) with analysis/baseline.toml
                       applied; exit 0 iff no unbaselined findings and no
                       unparseable files.
- --selftest         — run the rules over analysis/fixtures/ and check the
                       fixture matrix: every ``# expect-finding`` line of a
                       ``*_bad_*`` fixture is flagged by exactly its rule,
                       the good fixtures are clean, and every rule fires at
                       least twice.
- --json             — machine-readable report (findings, suppressed with
                       justifications, unused suppressions).
- --rules A,B        — restrict to a comma-separated rule subset.
- --no-baseline      — show everything the rules see (triage mode).

Exit codes: 0 clean, 1 findings or matrix failures, 2 internal error (a
malformed baseline, an unknown rule).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from kube_scheduler_simulator_tpu_torch.analysis.framework import (
    PACKAGE,
    BaselineError,
    default_rules,
    render_report,
    repo_root,
    run_analysis,
)


def selftest(as_json: bool) -> int:
    report = run_analysis(fixtures=True, baseline_path=None)
    found: dict[tuple[str, int], str] = {}
    for f in report["findings"]:
        found.setdefault((f.file, f.line), f.rule)
    fdir = os.path.join(repo_root(), PACKAGE, "analysis", "fixtures")
    failures: list[str] = list(report["errors"])
    fired: dict[str, int] = {}
    expect_re = re.compile(r"#\s*expect-finding\b")
    for fn in sorted(os.listdir(fdir)):
        if not fn.endswith(".py"):
            continue
        rel = f"{PACKAGE}/analysis/fixtures/{fn}"
        with open(os.path.join(fdir, fn), "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        expected = {i for i, ln in enumerate(lines, 1) if expect_re.search(ln)}
        got = {line for (file, line) in found if file == rel}
        if "_bad_" in fn:
            if not expected:
                failures.append(f"{fn}: bad fixture carries no # expect-finding markers")
            if expected - got:
                failures.append(f"{fn}: lines {sorted(expected - got)} expected a finding, got none")
            if got - expected:
                failures.append(f"{fn}: unexpected findings on lines {sorted(got - expected)}")
            for line in expected & got:
                fired[found[(rel, line)]] = fired.get(found[(rel, line)], 0) + 1
        elif got:
            failures.append(f"{fn}: good fixture flagged on lines {sorted(got)}")
    for rule in (r.name for r in default_rules()):
        if fired.get(rule, 0) < 2:
            failures.append(f"{rule}: the fixture matrix demonstrates {fired.get(rule, 0)} finding(s); "
                            "the contract needs >= 2 bad cases")
    if as_json:
        print(json.dumps({"ok": not failures, "failures": failures, "fired": fired}, indent=2))
    elif failures:
        for msg in failures:
            print(f"selftest FAIL: {msg}", file=sys.stderr)
    else:
        print("contract selftest OK: " + ", ".join(f"{r}={n}" for r, n in sorted(fired.items())))
    return 1 if failures else 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kube_scheduler_simulator_tpu_torch.analysis",
                                 description="the port's kernel-contract checker")
    ap.add_argument("--json", action="store_true", help="machine-readable report")
    ap.add_argument("--selftest", action="store_true", help="run the fixture matrix")
    ap.add_argument("--no-baseline", action="store_true", help="ignore the baseline")
    ap.add_argument("--rules", default=None, help="comma-separated rule subset")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest(args.json)
    rules = default_rules()
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - {r.name for r in rules}
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in wanted]
    try:
        report = run_analysis(rules=rules, baseline_path=None if args.no_baseline else "")
    except BaselineError as e:
        print(f"baseline error: {e}", file=sys.stderr)
        return 2
    print(render_report(report, as_json=args.json))
    return 1 if (report["findings"] or report["errors"]) else 0


if __name__ == "__main__":
    sys.exit(main())
