"""KSS-HOST-SYNC: no host synchronization on the launch path.

The reference's rule keeps host reads (``.item()``, ``float()`` of a tracer,
python branches on traced values) out of jit-traced code, where they crash
at trace time or bake one value into the program.  The port traces nothing:
its counterpart is the launch path, where a host read of a tensor on the
card waits for every kernel queued before it.  A wrapper, the DevicePlacer
or the round's dispatch that fetches a value on its way serializes the host
with the card and hides the wait inside "launch" time (the ``trace_fetch``
stage of ROADMAP.md's host costs is such a wait).

Scoped to the launch path (``SCOPES``): the kernel wrappers of
``ops/kernels.py``, ``DevicePlacer`` (ops/batch.py), and the round's
dispatch in ``scheduler/batch_engine.py`` (``BatchEngine._prep``,
``_compact_dispatch``, ``schedule_waves``, ``_finish_prepped``,
``schedule_async`` and ``PendingBatch``).  Flagged there:

- ``.item()`` and ``.cpu()`` on anything (numpy has no ``.cpu()``; an
  ``.item()`` on the launch path is a fetch until shown otherwise);
- ``.tolist()`` of a tensor, and ``float()``, ``int()``, ``bool()`` of a
  tensor expression;
- ``torch.cuda.synchronize(...)``.

A tensor is a name assigned from a ``torch.*`` call or from an expression of
another tensor (a method, attribute or subscript of it), or a parameter
annotated ``torch.Tensor``; one forward pass a function, to a fixpoint.  The
deliberate fetches (the decisions' packed copy, the trace blob, a wrapper's
capacity check) are baselined, each with its reason.
"""

from __future__ import annotations

import ast
import fnmatch

from kube_scheduler_simulator_tpu_torch.analysis.framework import Finding, Project, Rule, SourceFile

# repo-relative file → the enclosing symbols (globs) that form the launch path
SCOPES = {
    "kube_scheduler_simulator_tpu_torch/ops/kernels.py": ("*",),
    "kube_scheduler_simulator_tpu_torch/ops/batch.py": ("DevicePlacer.*",),
    "kube_scheduler_simulator_tpu_torch/scheduler/batch_engine.py": (
        "BatchEngine._prep", "BatchEngine._compact_dispatch", "BatchEngine.schedule_waves",
        "BatchEngine._finish_prepped", "BatchEngine.schedule_async", "PendingBatch.*",
    ),
}
_ALWAYS = {"item", "cpu"}
_CASTS = {"float", "int", "bool"}


def _dotted(node: ast.AST) -> "str | None":
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_NOT_TENSORS = ("torch.Size", "torch.dtype", "torch.device", "torch.finfo", "torch.iinfo", "torch.cuda.")


def _is_tensor_expr(node: ast.AST, tainted: "set[str]") -> bool:
    """Does the expression produce (or read) a tensor: a ``torch.*`` call
    (not a size, dtype or device), or a method, attribute or subscript chain
    rooted at a tensor name (an index does not make its subscript one)."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Subscript):
        return _is_tensor_expr(node.value, tainted)
    if isinstance(node, ast.Attribute):
        return _is_tensor_expr(node.value, tainted)
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        if d is not None and d.startswith("torch."):
            return not d.startswith(_NOT_TENSORS)
        return any(_is_tensor_expr(n, tainted) for n in [node.func, *node.args])
    return any(_is_tensor_expr(n, tainted) for n in ast.iter_child_nodes(node) if isinstance(n, ast.expr))


def _annotated_tensor(arg: ast.arg) -> bool:
    ann = arg.annotation
    if ann is None:
        return False
    text = ann.value if isinstance(ann, ast.Constant) and isinstance(ann.value, str) else ast.unparse(ann)
    return "Tensor" in text


def _targets(node: ast.AST) -> "list[str]":
    """The plain names an assignment binds (a store into an attribute or a
    subscript binds no name)."""
    names: list[str] = []
    tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in tgts:
        for sub in [t] + (list(t.elts) if isinstance(t, (ast.Tuple, ast.List)) else []):
            if isinstance(sub, ast.Name):
                names.append(sub.id)
    return names


def _taint(fn: ast.AST) -> "set[str]":
    args = fn.args
    tainted = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs if _annotated_tensor(a)}
    while True:
        n0 = len(tainted)
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)) and node.value is not None:
                if _is_tensor_expr(node.value, tainted):
                    tainted.update(_targets(node))
            elif isinstance(node, (ast.For, ast.comprehension)) and _is_tensor_expr(node.iter, tainted):
                t = node.target
                tainted.update(n.id for n in [t] + list(getattr(t, "elts", ())) if isinstance(n, ast.Name))
        if len(tainted) == n0:
            return tainted


class HostSyncRule(Rule):
    name = "KSS-HOST-SYNC"
    paths = tuple(SCOPES)

    def _in_scope(self, src: SourceFile, qual: str) -> bool:
        if src.fixture_rule is not None:
            return True
        globs = SCOPES.get(src.rel, ())
        return any(fnmatch.fnmatch(qual, g) for g in globs)

    def check_file(self, src: SourceFile, ctx: Project) -> "list[Finding]":
        out: list[Finding] = []
        seen: set[int] = set()

        def walk(node: ast.AST, stack: "tuple[str, ...]"):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = ".".join(stack + (child.name,))
                    if self._in_scope(src, qual):
                        self._check_function(src, child, out, seen)
                    else:
                        walk(child, stack + (child.name,))
                elif isinstance(child, ast.ClassDef):
                    walk(child, stack + (child.name,))

        walk(src.tree, ())
        return out

    def _check_function(self, src: SourceFile, fn: ast.AST, out: "list[Finding]", seen: "set[int]") -> None:
        tainted = _taint(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            what = None
            f = node.func
            d = _dotted(f)
            if d is not None and (d == "torch.cuda.synchronize" or d.endswith(".cuda.synchronize")):
                what = "torch.cuda.synchronize() waits for every kernel queued on the card"
            elif isinstance(f, ast.Attribute) and f.attr in _ALWAYS and not node.args:
                what = f".{f.attr}() copies a value to the host and waits for the kernels before it"
            elif isinstance(f, ast.Attribute) and f.attr == "tolist" and _is_tensor_expr(f.value, tainted):
                what = ".tolist() of a tensor copies it to the host and waits for the kernels before it"
            elif (isinstance(f, ast.Name) and f.id in _CASTS and len(node.args) == 1
                  and _is_tensor_expr(node.args[0], tainted)):
                what = f"{f.id}() of a tensor fetches its value and waits for the kernels before it"
            if what is None:
                continue
            seen.add(id(node))
            out.append(src.finding(
                self.name, node,
                f"host sync on the launch path: {what}. Keep the value on the card, fetch it once where the "
                "round waits anyway, or baseline the deliberate fetch with its reason.",
            ))
