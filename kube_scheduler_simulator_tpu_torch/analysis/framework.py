"""The kernel-contract rule framework: files, findings, baseline.

The port's copy of the JAX package's ``analysis/framework.py``, over the
port's own tree.  Each rule is an AST visitor over the live tree, findings
are typed records, and every suppression lives in ``analysis/baseline.toml``
carrying a justification string.  Two rules are the reference's, copied
(KSS-LOCK, KSS-HOT-RENDER, over the port's modules); KSS-ENV reads the
port's knobs against the port's own list (``environment-variables.md`` in
the package); KSS-DTYPE, KSS-HOST-SYNC and KSS-PINNED are the reference's
three JAX rules re-targeted to the port's contracts (torch creation and
integer reductions in the kernel modules, host syncs on the launch path,
pinned staging buffers behind ``non_blocking`` copies in place of donated
buffers).

The pieces:

- :class:`SourceFile` — one parsed module: AST, raw lines, the comment
  map (via ``tokenize``, so ``#`` inside strings never miscounts) and
  the enclosing-symbol index rules anchor findings to.
- :class:`Rule` — ``check_file`` per module plus a ``finalize`` hook for
  cross-file rules (KSS-ENV diffs reads against the documentation).
- :func:`run_analysis` — walk the tree (the port package and
  chip_smoke.py, fixtures excluded), run every rule, apply the baseline.
- :func:`load_baseline` — ``[[suppress]]`` tables; an entry without a
  non-empty ``justification`` is itself an error (a suppression must
  say WHY or it is just the folklore this package replaces).

Fixture runs (``fixtures=True``) scan ``analysis/fixtures/`` instead;
there a rule applies exactly to the files named after it
(``kss_dtype_bad_1.py`` → KSS-DTYPE), and ``# expect-finding`` line
markers let the self-test pin the exact lines each rule must flag.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import json
import os
import tokenize
from typing import Any, Iterable

PACKAGE = "kube_scheduler_simulator_tpu_torch"

# directories under the package never scanned as live source (fixtures
# are deliberate violations; webui_assets is JS; csrc is CUDA; the build
# directories hold libraries; __pycache__ is noise — native/ stays IN: its
# __init__.py reads the KSS_NO_NATIVE knob)
_EXCLUDED_PARTS = ("analysis/fixtures", "server/webui_assets", "csrc", "native/build", "__pycache__")
# the scripts beside the package (the time_*.py scripts are in it)
_SCRIPTS = ("chip_smoke.py",)


def repo_root(start: "str | None" = None) -> str:
    """The repository root: the directory holding the package dir."""
    here = start or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return here


# ------------------------------------------------------------------ findings


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    file: str  # repo-relative posix path
    line: int
    col: int
    symbol: str  # innermost enclosing "Class.method", or "<module>"
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: {self.rule} [{self.symbol}] {self.message}"


# --------------------------------------------------------------- source file


class SourceFile:
    """One parsed module plus the lookup tables rules share."""

    def __init__(self, path: str, rel: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.tree = ast.parse(self.text, filename=self.rel)
        self.lines = self.text.splitlines()
        self._comments: "dict[int, str] | None" = None
        self._symbol_spans: "list[tuple[int, int, str]] | None" = None

    # fixture files opt into exactly one rule via their name prefix
    @property
    def fixture_rule(self) -> "str | None":
        if "analysis/fixtures/" not in self.rel:
            return None
        base = os.path.basename(self.rel)
        for slug, rule in (
            ("kss_dtype", "KSS-DTYPE"),
            ("kss_host_sync", "KSS-HOST-SYNC"),
            ("kss_hot_render", "KSS-HOT-RENDER"),
            ("kss_pinned", "KSS-PINNED"),
            ("kss_env", "KSS-ENV"),
            ("kss_lock", "KSS-LOCK"),
        ):
            if base.startswith(slug):
                return rule
        return None

    def comments(self) -> "dict[int, str]":
        """lineno → comment text (without ``#``), tokenize-accurate."""
        if self._comments is None:
            out: dict[int, str] = {}
            try:
                for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
                    if tok.type == tokenize.COMMENT:
                        out[tok.start[0]] = tok.string.lstrip("#").strip()
            except tokenize.TokenizeError:  # pragma: no cover - parsed files tokenize
                pass
            self._comments = out
        return self._comments

    def _spans(self) -> "list[tuple[int, int, str]]":
        if self._symbol_spans is None:
            spans: list[tuple[int, int, str]] = []

            def walk(node: ast.AST, stack: "tuple[str, ...]"):
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                        qual = stack + (child.name,)
                        spans.append((child.lineno, child.end_lineno or child.lineno, ".".join(qual)))
                        walk(child, qual)
                    else:
                        walk(child, stack)

            walk(self.tree, ())
            # innermost match wins: sort by span size descending so later
            # (smaller) spans override during lookup
            spans.sort(key=lambda s: (s[0], -(s[1] - s[0])))
            self._symbol_spans = spans
        return self._symbol_spans

    def symbol_at(self, lineno: int) -> str:
        best = "<module>"
        for lo, hi, name in self._spans():
            if lo <= lineno <= hi:
                best = name  # spans are visited outer-to-inner per line
        return best

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=rule,
            file=self.rel,
            line=line,
            col=getattr(node, "col_offset", 0),
            symbol=self.symbol_at(line),
            message=message,
        )


# --------------------------------------------------------------------- rules


class Project:
    """Shared cross-file state for one analysis run."""

    def __init__(self, root: str, fixtures: bool = False):
        self.root = root
        self.fixtures = fixtures
        self.files: list[SourceFile] = []
        self.shared: dict[str, Any] = {}  # per-rule scratch (KSS-ENV read sites)


class Rule:
    name = "KSS-BASE"
    #: live-tree path globs (repo-relative) this rule scans; None = all
    paths: "tuple[str, ...] | None" = None

    def applies(self, src: SourceFile) -> bool:
        if src.fixture_rule is not None:
            return src.fixture_rule == self.name
        if self.paths is None:
            return True
        return any(fnmatch.fnmatch(src.rel, pat) for pat in self.paths)

    def check_file(self, src: SourceFile, ctx: Project) -> "list[Finding]":
        return []

    def finalize(self, ctx: Project) -> "list[Finding]":
        return []


# ------------------------------------------------------------------ baseline


class BaselineError(ValueError):
    """A malformed baseline is a hard error: suppressions without
    justification would silently re-grow the folklore."""


@dataclasses.dataclass
class Suppression:
    rule: str
    justification: str
    file: "str | None" = None  # glob over the repo-relative path
    symbol: "str | None" = None  # glob over the enclosing symbol
    contains: "str | None" = None  # substring of the message
    used: int = 0

    def matches(self, f: Finding) -> bool:
        if self.rule != f.rule:
            return False
        if self.file is not None and not fnmatch.fnmatch(f.file, self.file):
            return False
        if self.symbol is not None and not fnmatch.fnmatch(f.symbol, self.symbol):
            return False
        if self.contains is not None and self.contains not in f.message:
            return False
        return True


def load_baseline(path: str) -> "list[Suppression]":
    try:
        import tomllib as _toml  # py311+
    except ImportError:  # pragma: no cover - py310 ships tomli in this image
        import tomli as _toml
    with open(path, "rb") as f:
        data = _toml.load(f)
    out: list[Suppression] = []
    for i, entry in enumerate(data.get("suppress", []) or []):
        rule = entry.get("rule")
        just = (entry.get("justification") or "").strip()
        if not rule:
            raise BaselineError(f"baseline entry #{i + 1}: missing 'rule'")
        if not just:
            raise BaselineError(
                f"baseline entry #{i + 1} ({rule}): every suppression must carry a "
                "non-empty 'justification' string"
            )
        unknown = set(entry) - {"rule", "file", "symbol", "contains", "justification"}
        if unknown:
            raise BaselineError(
                f"baseline entry #{i + 1} ({rule}): unknown keys {sorted(unknown)}"
            )
        out.append(
            Suppression(
                rule=rule,
                justification=just,
                file=entry.get("file"),
                symbol=entry.get("symbol"),
                contains=entry.get("contains"),
            )
        )
    return out


def apply_baseline(
    findings: "list[Finding]", sups: "list[Suppression]"
) -> "tuple[list[Finding], list[tuple[Finding, Suppression]]]":
    kept: list[Finding] = []
    suppressed: list[tuple[Finding, Suppression]] = []
    for f in findings:
        for s in sups:
            if s.matches(f):
                s.used += 1
                suppressed.append((f, s))
                break
        else:
            kept.append(f)
    return kept, suppressed


# ----------------------------------------------------------------- the walk


def _iter_live_files(root: str) -> "Iterable[tuple[str, str]]":
    pkg = os.path.join(root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg):
        rel_dir = os.path.relpath(dirpath, root).replace(os.sep, "/")
        if any(part in rel_dir for part in _EXCLUDED_PARTS):
            dirnames[:] = []
            continue
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn), f"{rel_dir}/{fn}"
    for fn in _SCRIPTS:
        path = os.path.join(root, fn)
        if os.path.exists(path):
            yield path, fn


def _iter_fixture_files(root: str) -> "Iterable[tuple[str, str]]":
    fdir = os.path.join(root, PACKAGE, "analysis", "fixtures")
    for fn in sorted(os.listdir(fdir)):
        if fn.endswith(".py"):
            yield os.path.join(fdir, fn), f"{PACKAGE}/analysis/fixtures/{fn}"


def default_rules() -> "list[Rule]":
    from kube_scheduler_simulator_tpu_torch.analysis.rules_dtype import DtypeRule
    from kube_scheduler_simulator_tpu_torch.analysis.rules_env import EnvRule
    from kube_scheduler_simulator_tpu_torch.analysis.rules_host_sync import HostSyncRule
    from kube_scheduler_simulator_tpu_torch.analysis.rules_hot_render import HotRenderRule
    from kube_scheduler_simulator_tpu_torch.analysis.rules_lock import LockRule
    from kube_scheduler_simulator_tpu_torch.analysis.rules_pinned import PinnedRule

    return [DtypeRule(), HostSyncRule(), HotRenderRule(), PinnedRule(), EnvRule(), LockRule()]


def run_analysis(
    root: "str | None" = None,
    rules: "list[Rule] | None" = None,
    baseline_path: "str | None" = "",  # "" = the default analysis/baseline.toml
    fixtures: bool = False,
) -> dict:
    """Run the rule set; returns a report dict.

    Keys: ``findings`` (unbaselined), ``suppressed`` (finding,
    suppression pairs), ``unused_suppressions`` (stale baseline entries —
    surfaced as warnings so the baseline shrinks as code heals),
    ``errors`` (unparseable files)."""
    root = root or repo_root()
    ctx = Project(root, fixtures=fixtures)
    rules = default_rules() if rules is None else rules
    errors: list[str] = []
    files = _iter_fixture_files(root) if fixtures else _iter_live_files(root)
    for path, rel in files:
        try:
            ctx.files.append(SourceFile(path, rel))
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{rel}: unparseable: {e}")
    findings: list[Finding] = []
    for src in ctx.files:
        for rule in rules:
            if rule.applies(src):
                findings.extend(rule.check_file(src, ctx))
    for rule in rules:
        findings.extend(rule.finalize(ctx))
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))

    sups: list[Suppression] = []
    if baseline_path == "":
        baseline_path = os.path.join(root, PACKAGE, "analysis", "baseline.toml")
    if baseline_path and os.path.exists(baseline_path) and not fixtures:
        sups = load_baseline(baseline_path)
    kept, suppressed = apply_baseline(findings, sups)
    active = {r.name for r in rules}
    return {
        "findings": kept,
        "suppressed": suppressed,
        # an entry for a rule that didn't run this invocation isn't
        # stale — only report unused entries the active rules could
        # have matched
        "unused_suppressions": [s for s in sups if not s.used and s.rule in active],
        "errors": errors,
    }


def render_report(report: dict, as_json: bool = False) -> str:
    if as_json:
        return json.dumps(
            {
                "findings": [f.to_dict() for f in report["findings"]],
                "suppressed": [
                    {**f.to_dict(), "justification": s.justification}
                    for f, s in report["suppressed"]
                ],
                "unused_suppressions": [
                    dataclasses.asdict(s) for s in report["unused_suppressions"]
                ],
                "errors": report["errors"],
                "ok": not report["findings"] and not report["errors"],
            },
            indent=2,
        )
    out: list[str] = []
    for f in report["findings"]:
        out.append(f.render())
    for err in report["errors"]:
        out.append(f"ERROR: {err}")
    for s in report["unused_suppressions"]:
        out.append(
            f"WARNING: unused baseline suppression rule={s.rule} file={s.file} "
            f"symbol={s.symbol} ({s.justification!r}) — delete it"
        )
    n_f, n_s = len(report["findings"]), len(report["suppressed"])
    out.append(f"{n_f} finding(s), {n_s} baselined, {len(report['errors'])} error(s)")
    return "\n".join(out)
