"""KSS-ENV: every operator knob is documented; every documented knob is real.

The port's env surface (``KSS_*`` / ``AUTOSCALE_*``) is its operator
API: an undocumented read is a knob nobody can discover, and a
documented name nobody reads is a knob that silently does nothing.  The
contract: the set of env names READ by the port's code equals the set of
names in the port's own list, ``environment-variables.md`` in the package
(the JAX package's ``docs/environment-variables.md`` lists the
reference's knobs, several of which the port does not read).

Read detection (AST): ``os.environ.get(K)`` / ``os.environ[K]`` /
``os.getenv(K)`` / ``environ.get(K)``, plus the repo's typed helpers —
any call whose callee name contains ``env`` (``env_str``, ``_env_pos``,
``env_float``...) with a matching string-literal first argument.
Writes (``os.environ[K] = ...``, ``setdefault``, monkeypatch) are not
reads.  Name literals that merely FLOW into a subprocess environment
dict are reads of nothing and are ignored.

Doc detection: every ``KSS_*``/``AUTOSCALE_*`` token in the doc file.

Findings are two-directional: ``undocumented env read`` anchored at the
read site, and ``documented but never read`` anchored at the doc line.
"""

from __future__ import annotations

import ast
import os
import re

from kube_scheduler_simulator_tpu_torch.analysis.framework import (
    Finding,
    Project,
    Rule,
    SourceFile,
)

_NAME = re.compile(r"^(KSS|AUTOSCALE)_[A-Z0-9_]+$")
_DOC_TOKEN = re.compile(r"\b(?:KSS|AUTOSCALE)_[A-Z0-9_]+\b")
DOC_REL = "kube_scheduler_simulator_tpu_torch/environment-variables.md"


def _env_key(call: ast.Call) -> "str | None":
    """The env-var name a call READS, or None."""
    f = call.func
    first = call.args[0] if call.args else None
    lit = first.value if isinstance(first, ast.Constant) and isinstance(first.value, str) else None
    if lit is None or not _NAME.match(lit):
        return None
    if isinstance(f, ast.Attribute):
        # os.environ.get(K) / environ.get(K)
        if f.attr == "get":
            v = f.value
            if (isinstance(v, ast.Attribute) and v.attr == "environ") or (
                isinstance(v, ast.Name) and v.id == "environ"
            ):
                return lit
        if f.attr == "getenv":
            return lit
        if "env" in f.attr.lower():
            return lit
    elif isinstance(f, ast.Name) and "env" in f.id.lower():
        return lit
    return None


class EnvRule(Rule):
    name = "KSS-ENV"
    paths = None

    def check_file(self, src: SourceFile, ctx: Project) -> "list[Finding]":
        reads = ctx.shared.setdefault("env_reads", {})  # name → first (src, node)
        for node in ast.walk(src.tree):
            key = None
            if isinstance(node, ast.Call):
                key = _env_key(node)
            elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
                v = node.value
                is_environ = (isinstance(v, ast.Attribute) and v.attr == "environ") or (
                    isinstance(v, ast.Name) and v.id == "environ"
                )
                sl = node.slice
                if (
                    is_environ
                    and isinstance(sl, ast.Constant)
                    and isinstance(sl.value, str)
                    and _NAME.match(sl.value)
                ):
                    key = sl.value
            if key is not None and key not in reads:
                reads[key] = (src, node)
        return []

    def finalize(self, ctx: Project) -> "list[Finding]":
        if ctx.fixtures:
            # fixture runs carry their own miniature doc as a docstring:
            # the first fixture module's docstring lines starting with
            # "documents:" list the documented names
            documented: set[str] = set()
            doc_lines: dict[str, tuple[SourceFile, int]] = {}
            for src in ctx.files:
                if src.fixture_rule != self.name:
                    continue
                for i, line in enumerate(src.lines, 1):
                    if "documents:" in line:
                        for tok in _DOC_TOKEN.findall(line):
                            documented.add(tok)
                            doc_lines.setdefault(tok, (src, i))
        else:
            doc_path = os.path.join(ctx.root, DOC_REL)
            documented = set()
            doc_lines = {}
            if os.path.exists(doc_path):
                with open(doc_path, "r", encoding="utf-8") as f:
                    for i, line in enumerate(f, 1):
                        for tok in _DOC_TOKEN.findall(line):
                            documented.add(tok)
                            if tok not in doc_lines:
                                doc_lines[tok] = (None, i)

        reads: dict = ctx.shared.get("env_reads", {})
        out: list[Finding] = []
        for name, (src, node) in sorted(reads.items()):
            if name not in documented:
                out.append(
                    src.finding(
                        self.name,
                        node,
                        f"env var {name} is read here but not documented in "
                        f"{DOC_REL}: an undocumented knob is an operator API "
                        "nobody can discover. Add a row (name, default, "
                        "validation, effect).",
                    )
                )
        for name in sorted(documented - set(reads)):
            src, line = doc_lines[name]
            out.append(
                Finding(
                    rule=self.name,
                    file=src.rel if src is not None else DOC_REL,
                    line=line,
                    col=0,
                    symbol="<doc>",
                    message=(
                        f"env var {name} is documented but never read by the "
                        "code: a knob that silently does nothing. Delete the "
                        "row or implement the read."
                    ),
                )
            )
        return out
