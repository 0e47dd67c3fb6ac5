"""KSS-PINNED: a pinned host buffer handed to a ``non_blocking`` copy is not
written again before an event or a sync orders it.

The port's counterpart of the reference's KSS-DONATE ("a donated buffer is
dead after the dispatch").  The port never donates: its kernels never write
their inputs.  What it hands to the card without waiting is a pinned host
buffer: ``host.to(dev, non_blocking=True)`` or ``dev.copy_(host,
non_blocking=True)`` returns before the DMA engine has read ``host``, and
``host.copy_(dev, non_blocking=True)`` before it has written it.  A write
to ``host`` in that window races the copy: on the card the bytes uploaded
(or fetched) are some mix of the old and the new, while the CPU, where
``non_blocking`` is a plain copy, runs green.  The contract: after the
hand-off, the buffer (or a view or numpy alias of it) is not written until
the host has waited for the copy (``torch.cuda.synchronize``, an event's or
a stream's ``synchronize()``, or a blocking fetch: ``.item()``, ``.cpu()``,
``.tolist()``), or the name is bound to a fresh buffer.

Statically, per function: a pinned buffer is a name or ``self.`` attribute
path assigned from a call with a ``pin_memory=`` keyword (not ``False``) or
from ``.pin_memory()``; its views and numpy aliases (``x = host[...]``,
``host.view(...)``, ``host.numpy()``) are the buffer too.  Events go in
source order, as the reference's rule reads loads after a donating call:
a hand-off, then a write (a subscript store, an in-place method ``*_``, a
``copy_`` into it) with no wait between them is a finding.
"""

from __future__ import annotations

import ast

from kube_scheduler_simulator_tpu_torch.analysis.framework import Finding, Project, Rule, SourceFile

_WAITS = {"synchronize", "item", "cpu", "tolist"}
_ALIASING = {"view", "numpy", "reshape", "view_as", "narrow", "split", "chunk"}


def _dotted(node: ast.AST) -> "str | None":
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _base(node: ast.AST) -> "str | None":
    """The dotted buffer path an expression reads through subscripts and
    aliasing methods: ``host[o:o + n]`` → host, ``self._host.view(t)`` →
    self._host."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr in _ALIASING):
            node = node.func.value
        else:
            return _dotted(node)


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and not (isinstance(kw.value, ast.Constant) and kw.value.value is False)
               for kw in call.keywords)


def _pins(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    if isinstance(value.func, ast.Attribute) and value.func.attr == "pin_memory":
        return True
    return any(kw.arg == "pin_memory" and not (isinstance(kw.value, ast.Constant) and kw.value.value is False)
               for kw in value.keywords)


class PinnedRule(Rule):
    name = "KSS-PINNED"
    paths = None

    def check_file(self, src: SourceFile, ctx: Project) -> "list[Finding]":
        out: list[Finding] = []
        for fn in ast.walk(src.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_function(src, fn))
        seen: set[tuple[int, int]] = set()
        uniq: list[Finding] = []
        for f in sorted(out, key=lambda f: (f.line, f.col)):
            if (f.line, f.col) not in seen:
                seen.add((f.line, f.col))
                uniq.append(f)
        return uniq

    def _check_function(self, src: SourceFile, fn: ast.AST) -> "list[Finding]":
        pinned: set[str] = set()
        aliases: dict[str, str] = {}
        events: list[tuple[int, int, str, "str | None", ast.AST]] = []

        def buf_of(node: ast.AST) -> "str | None":
            b = _base(node)
            if b is None:
                return None
            b = aliases.get(b, b)
            return b if b in pinned else None

        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
                continue
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    path = _dotted(t)
                    if path is None:
                        continue
                    if _pins(node.value):
                        pinned.add(path)
                        events.append((node.lineno, node.col_offset, "bind", path, node))
                    elif buf_of(node.value) is not None and isinstance(t, ast.Name):
                        aliases[path] = buf_of(node.value)
                    elif path in pinned:
                        events.append((node.lineno, node.col_offset, "bind", path, node))
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in tgts:
                    if isinstance(t, ast.Subscript) or isinstance(node, ast.AugAssign):
                        b = buf_of(t)
                        if b is not None:
                            events.append((t.lineno, t.col_offset, "write", b, t))
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            d = _dotted(f)
            if isinstance(f, ast.Attribute) and (f.attr in _WAITS or (d or "").endswith("cuda.synchronize")):
                events.append((node.lineno, node.col_offset, "wait", None, node))
                continue
            if not isinstance(f, ast.Attribute):
                continue
            recv = buf_of(f.value)
            if f.attr == "to" and _non_blocking(node) and recv is not None:
                events.append((node.lineno, node.col_offset, "handoff", recv, node))
            elif f.attr == "copy_" and _non_blocking(node):
                srcs = [buf_of(a) for a in node.args[:1]]
                if recv is not None:
                    events.append((node.lineno, node.col_offset, "write", recv, node))
                    events.append((node.lineno, node.col_offset + 1, "handoff", recv, node))
                for b in srcs:
                    if b is not None:
                        events.append((node.lineno, node.col_offset, "handoff", b, node))
            elif f.attr.endswith("_") and not f.attr.startswith("_") and recv is not None:
                events.append((node.lineno, node.col_offset, "write", recv, node))

        out: list[Finding] = []
        live: dict[str, int] = {}  # buffer → line of its unawaited hand-off
        order = {"bind": 0, "wait": 1, "write": 2, "handoff": 3}
        for line, col, kind, buf, node in sorted(events, key=lambda e: (e[0], e[1], order[e[2]])):
            if kind == "wait":
                live.clear()
            elif kind == "bind":
                live.pop(buf, None)
            elif kind == "handoff":
                live[buf] = line
            elif kind == "write" and buf in live and live[buf] < line:
                out.append(src.finding(
                    self.name, node,
                    f"pinned buffer '{buf}' is written here while its non_blocking copy of line {live[buf]} "
                    "may still be in flight: wait for the copy first (an event's or the stream's "
                    "synchronize(), torch.cuda.synchronize) or stage into another buffer.",
                ))
        return out
