"""The port's kernel-contract checker (analysis/: the rules, the baseline,
the fixtures and ``python -m kube_scheduler_simulator_tpu_torch.analysis``),
as tests/test_contracts.py holds the JAX package's.

- The fixture matrix: each bad fixture is flagged at exactly its marked
  lines by its own rule, the good fixtures are silent, every rule fires at
  least twice, and no fixture imports JAX or the JAX package.
- The live port tree is clean under its baseline, the baseline is fully
  used, and without it the justified findings show.
- A baseline entry without a justification is an error.
- The CLI's exit codes: 0 for the selftest and the live run, 1 for
  findings, 2 for an unknown rule.
- The two rules copied from the reference (KSS-LOCK, KSS-HOT-RENDER) report
  the same findings, by rule and line, as the reference's frameworks on the
  same inputs: both packages' fixtures and the port's own modules.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from kube_scheduler_simulator_tpu_torch.analysis import (
    BaselineError,
    apply_baseline,
    default_rules,
    load_baseline,
    run_analysis,
)
from kube_scheduler_simulator_tpu_torch.analysis import framework as TF
from kube_scheduler_simulator_tpu_torch.analysis.framework import PACKAGE, repo_root

ROOT = repo_root()
FIXDIR = os.path.join(ROOT, PACKAGE, "analysis", "fixtures")
RULES = ("KSS-DTYPE", "KSS-HOST-SYNC", "KSS-HOT-RENDER", "KSS-PINNED", "KSS-ENV", "KSS-LOCK")
FIXTURES = sorted(f for f in os.listdir(FIXDIR) if f.endswith(".py"))


def _fixture_report():
    return run_analysis(fixtures=True, baseline_path=None)


def _expected_lines(fname: str) -> "set[int]":
    marker = re.compile(r"#\s*expect-finding\b")
    with open(os.path.join(FIXDIR, fname), "r", encoding="utf-8") as f:
        return {i for i, ln in enumerate(f.read().splitlines(), 1) if marker.search(ln)}


def test_the_rule_set():
    assert tuple(sorted(r.name for r in default_rules())) == tuple(sorted(RULES))
    slugs = {f.split("_bad_")[0].split("_good")[0] for f in FIXTURES}
    assert slugs == {"kss_" + r[4:].lower().replace("-", "_") for r in RULES}


@pytest.mark.parametrize("fname", FIXTURES)
def test_fixture_matrix(fname):
    """Bad fixtures are flagged at exactly their marked lines, by the rule
    the fixture is named after; good fixtures are silent; none imports JAX
    or the JAX package."""
    report = _fixture_report()
    rel = f"{PACKAGE}/analysis/fixtures/{fname}"
    got = {f.line: f.rule for f in report["findings"] if f.file == rel}
    expected = _expected_lines(fname)
    if "_bad_" in fname:
        assert expected, f"{fname}: a bad fixture must carry expect markers"
        assert set(got) == expected, f"{fname}: flagged lines {sorted(got)} != expected {sorted(expected)}"
        slug = fname.split("_bad_")[0].replace("kss_", "kss-").replace("_", "-").upper()
        assert all(r == slug for r in got.values()), got
    else:
        assert not got, f"{fname}: good fixture flagged: {got}"
        assert not expected, f"{fname}: good fixture carries expect markers"
    tree = ast.parse(Path(FIXDIR, fname).read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in imported if m.split(".")[0] in ("jax", "kube_scheduler_simulator_tpu")}, imported


def test_every_rule_demonstrated_twice():
    by_rule: "dict[str, int]" = {}
    for f in _fixture_report()["findings"]:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    for rule in RULES:
        assert by_rule.get(rule, 0) >= 2, (rule, by_rule)


# --------------------------------------------------------------- live tree


def test_live_tree_clean_with_baseline():
    report = run_analysis()
    assert not report["errors"], report["errors"]
    assert not report["findings"], "\n".join(f.render() for f in report["findings"])
    assert not report["unused_suppressions"], [(s.rule, s.file, s.symbol) for s in report["unused_suppressions"]]
    files = {f.file for f, _s in report["suppressed"]}
    assert "kube_scheduler_simulator_tpu_torch/scheduler/batch_engine.py" in files


def test_live_tree_scans_the_port_and_its_scripts():
    ctx_files = [rel for _p, rel in TF._iter_live_files(ROOT)]
    assert "chip_smoke.py" in ctx_files and f"{PACKAGE}/time_scan.py" in ctx_files
    assert f"{PACKAGE}/ops/aot.py" in ctx_files
    assert not [f for f in ctx_files if "/fixtures/" in f or f.startswith("kube_scheduler_simulator_tpu/")]


def test_live_tree_has_baselined_findings():
    report = run_analysis(baseline_path=None)
    assert report["suppressed"] == []
    assert {f.rule for f in report["findings"]} == {"KSS-LOCK", "KSS-HOST-SYNC"}


def test_every_port_knob_is_listed():
    """KSS-ENV reads against the port's own list, which the README links."""
    from kube_scheduler_simulator_tpu_torch.analysis.rules_env import DOC_REL

    assert os.path.exists(os.path.join(ROOT, DOC_REL))
    assert DOC_REL in Path(ROOT, "README.md").read_text()
    report = run_analysis(rules=[r for r in default_rules() if r.name == "KSS-ENV"], baseline_path=None)
    assert report["findings"] == []


# ----------------------------------------------------------------- baseline


def test_baseline_requires_justification(tmp_path):
    p = tmp_path / "baseline.toml"
    p.write_text('[[suppress]]\nrule = "KSS-DTYPE"\n')
    with pytest.raises(BaselineError, match="justification"):
        load_baseline(str(p))
    p.write_text('[[suppress]]\nrule = "KSS-DTYPE"\njustification = "  "\n')
    with pytest.raises(BaselineError, match="justification"):
        load_baseline(str(p))
    p.write_text('[[suppress]]\nrule = "KSS-DTYPE"\nbogus_key = 1\njustification = "x"\n')
    with pytest.raises(BaselineError, match="unknown keys"):
        load_baseline(str(p))
    shipped = load_baseline(os.path.join(ROOT, PACKAGE, "analysis", "baseline.toml"))
    assert shipped and all(len(s.justification) > 40 for s in shipped)


def test_baseline_matching_and_unused(tmp_path):
    p = tmp_path / "baseline.toml"
    p.write_text("\n".join([
        "[[suppress]]", 'rule = "KSS-PINNED"', 'file = "*/fixtures/kss_pinned_bad_1.py"', 'justification = "test"',
        "[[suppress]]", 'rule = "KSS-LOCK"', 'symbol = "NoSuchClass.*"', 'justification = "stale"',
    ]))
    sups = load_baseline(str(p))
    kept, suppressed = apply_baseline(_fixture_report()["findings"], sups)
    assert suppressed and all(f.file.endswith("kss_pinned_bad_1.py") for f, _s in suppressed)
    assert all(not f.file.endswith("kss_pinned_bad_1.py") for f in kept)
    assert [s.rule for s in sups if not s.used] == ["KSS-LOCK"]


# ---------------------------------------------------------------- the CLI


def _cli(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "kube_scheduler_simulator_tpu_torch.analysis", *args],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)


def test_cli_exit_codes():
    r = _cli("--selftest")
    assert r.returncode == 0 and "contract selftest OK" in r.stdout, r.stdout + r.stderr
    r = _cli("--selftest", "--json")
    assert r.returncode == 0 and json.loads(r.stdout)["ok"] is True
    r = _cli()
    assert r.returncode == 0 and "0 finding(s)" in r.stdout, r.stdout + r.stderr
    r = _cli("--json")
    out = json.loads(r.stdout)
    assert r.returncode == 0 and out["ok"] and all(s["justification"] for s in out["suppressed"])
    r = _cli("--no-baseline", "--rules", "KSS-HOST-SYNC,KSS-LOCK")
    assert r.returncode == 1 and "KSS-HOST-SYNC" in r.stdout, r.stdout + r.stderr
    r = _cli("--rules", "KSS-NOPE")
    assert r.returncode == 2 and "unknown rule" in r.stderr


def test_the_checker_imports_neither_jax_nor_the_reference():
    code = ("import sys\nfrom kube_scheduler_simulator_tpu_torch.analysis.__main__ import main\nrc = main(['--selftest'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'kube_scheduler_simulator_tpu')]\n"
            "assert rc == 0 and not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


# ------------------------------------------------- the two copied rules


def _both(rule_module: str, cls: str, rel_files: "list[str]") -> "tuple[list, list]":
    """The findings (file, rule, line) of each package's rule over the same
    files, each package's framework parsing them."""
    import importlib

    out = []
    for pkg in ("kube_scheduler_simulator_tpu", "kube_scheduler_simulator_tpu_torch"):
        fw = importlib.import_module(f"{pkg}.analysis.framework")
        rule = getattr(importlib.import_module(f"{pkg}.analysis.{rule_module}"), cls)()
        ctx = fw.Project(ROOT)
        got = []
        for rel in rel_files:
            src = fw.SourceFile(os.path.join(ROOT, rel), rel)
            got += [(f.file, f.rule, f.line, f.symbol) for f in rule.check_file(src, ctx)]
        out.append(sorted(got))
    return out[0], out[1]


def _fixture_files(slug: str) -> "list[str]":
    out = []
    for pkg in ("kube_scheduler_simulator_tpu", "kube_scheduler_simulator_tpu_torch"):
        d = os.path.join(ROOT, pkg, "analysis", "fixtures")
        out += [f"{pkg}/analysis/fixtures/{f}" for f in sorted(os.listdir(d)) if f.startswith(slug)]
    return out


def test_lock_rule_reports_what_the_references_does():
    files = _fixture_files("kss_lock") + [rel for _p, rel in TF._iter_live_files(ROOT)]
    ref, port = _both("rules_lock", "LockRule", files)
    assert port == ref
    assert {f for f, *_ in port} >= {f"{PACKAGE}/ops/encode.py", f"{PACKAGE}/analysis/fixtures/kss_lock_bad_1.py"}


def test_hot_render_rule_reports_what_the_references_does():
    from kube_scheduler_simulator_tpu_torch.analysis.rules_hot_render import HotRenderRule

    files = _fixture_files("kss_hot_render") + list(HotRenderRule.paths)
    ref, port = _both("rules_hot_render", "HotRenderRule", files)
    assert port == ref
    assert len({f for f, *_ in port}) >= 4
