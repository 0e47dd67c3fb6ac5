"""KSS-HOT-RENDER: no per-object serialize/deep-copy inside the
commit/watch hot path.

The motivating measurement (the wave profiler): the ``host_other``
remainder was dominated by the same pod being ``json.dumps``-ed once
per list/watch consumer per mutation and ``_clone``-ed on every event
emit — O(consumers x mutations) renders of identical bytes.  The fix
pair is structural: the render-once wire cache (server/wirecache.py)
and the store's zero-clone event emit.  This rule keeps the structure
from regressing: in the hot-path modules, a call that serializes or
deep-copies an object INSIDE a loop or comprehension (i.e. per item)
is a finding — per-wave work must render once and share bytes, not
rebuild per pod.

Mechanized per module (hot-path files only, see ``paths``):

1. Flagged calls: ``json.dumps``, ``copy.deepcopy`` / ``deepcopy``,
   and the store's ``_clone`` — lexically inside a ``for``/``while``
   body or a comprehension, in any function.
2. Self-recursion is the implementation, not a use: a call to ``X``
   inside ``def X`` never flags (``_clone`` recursing through its own
   dict comprehension IS the clone helper).
3. The escape hatch is a ``# hot-render-ok:`` comment on the call line
   or anywhere in the enclosing function, carrying WHY the per-item
   copy is the contract (compat default with an opt-out, snapshot
   surface off the hot path, patch semantics that must own their
   values).
"""

from __future__ import annotations

import ast

from kube_scheduler_simulator_tpu_torch.analysis.framework import Finding, Project, Rule, SourceFile

_MARKER = "hot-render-ok:"

#: call roots that serialize or deep-copy one object
_COPY_CALLS = {"dumps", "deepcopy", "_clone"}


def _call_name(func: ast.AST) -> "str | None":
    """'dumps' for json.dumps, 'deepcopy' for copy.deepcopy/deepcopy,
    '_clone' for the bare helper."""
    if isinstance(func, ast.Attribute):
        return func.attr if func.attr in _COPY_CALLS else None
    if isinstance(func, ast.Name):
        return func.id if func.id in _COPY_CALLS else None
    return None


class HotRenderRule(Rule):
    name = "KSS-HOT-RENDER"
    #: the commit/watch hot path: store mutations + event emit, the two
    #: HTTP render surfaces, and the wave-commit reflector pair
    paths = (
        "kube_scheduler_simulator_tpu_torch/state/store.py",
        "kube_scheduler_simulator_tpu_torch/server/kubeapi.py",
        "kube_scheduler_simulator_tpu_torch/server/wirecache.py",
        "kube_scheduler_simulator_tpu_torch/plugins/storereflector.py",
        "kube_scheduler_simulator_tpu_torch/plugins/resultstore.py",
    )

    def check_file(self, src: SourceFile, ctx: Project) -> "list[Finding]":
        comments = src.comments()
        out: list[Finding] = []

        def justified(call: ast.Call, fn: "ast.FunctionDef | None") -> bool:
            lines = [call.lineno]
            if fn is not None:
                lines = range(fn.lineno, (fn.end_lineno or fn.lineno) + 1)
            return any(_MARKER in comments.get(i, "") for i in lines)

        _LOOPY = (
            ast.For,
            ast.AsyncFor,
            ast.While,
            ast.ListComp,
            ast.SetComp,
            ast.DictComp,
            ast.GeneratorExp,
            ast.comprehension,
        )

        def visit(node: ast.AST, fn: "ast.FunctionDef | None", loops: int):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def resets the loop context: its body runs
                # when CALLED, not per iteration of the enclosing loop
                fn, loops = node, 0
            elif isinstance(node, _LOOPY):
                loops += 1
            elif isinstance(node, ast.Call) and loops:
                name = _call_name(node.func)
                if (
                    name is not None
                    and not (fn is not None and fn.name == name)  # self-recursion
                    and not justified(node, fn)
                ):
                    out.append(
                        src.finding(
                            self.name,
                            node,
                            f"per-item {name}() inside a loop on the commit/"
                            "watch hot path: serializing or deep-copying one "
                            "object per iteration is the O(consumers x "
                            "mutations) rebuild the wire cache / zero-clone "
                            "emit removed. Render once and share the bytes "
                            "(server/wirecache.py), hoist the copy out of "
                            "the loop, or justify with a '# hot-render-ok:' "
                            "comment.",
                        )
                    )
            for child in ast.iter_child_nodes(node):
                visit(child, fn, loops)

        visit(src.tree, None, 0)
        return out
