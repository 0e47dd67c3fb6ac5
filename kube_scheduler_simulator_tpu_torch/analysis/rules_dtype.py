"""KSS-DTYPE: tensors made in the kernel modules pin their dtype and device;
integer reductions pin their dtype.

The reference's rule guards ``jnp`` calls whose dtype followed the
``jax_enable_x64`` flag (its motivating crash: an int32 ``jnp.sum`` widened to
int64 under x64 and broke a kernel carry).  The port's counterpart is torch's
promotion and its defaults:

- ``torch.sum`` / ``cumsum`` / ``prod`` of an int32 or bool tensor returns
  int64, while the CUDA wrappers (ops/kernels.py) take fixed argument
  types and the plain versions must hand the same dtypes as the kernels;
- ``torch.arange`` / ``zeros`` / ``ones`` / ``full`` / ``empty`` without
  ``dtype=`` take torch's default dtype (a process-wide setting) or infer
  one from a Python number, and without ``device=`` land on the CPU, so a
  plane made inside a plain version or a launch path silently leaves the
  card (or costs a copy).

In the kernel modules (``ops/``, ``preemption/kernel.py``,
``gang/kernel.py``, ``tuning/relax.py``, ``tuning/objective.py``):

- **creation**: a ``torch.<creation>`` call without a ``dtype=`` or a
  ``device=`` keyword is flagged (``*_like`` calls inherit both and are
  exempt);
- **integer reduction**: ``torch.sum/cumsum/prod(x)`` or ``x.sum/cumsum/
  prod()`` without ``dtype=`` is flagged when ``x`` shows integer evidence
  (a comparison or boolean expression, a cast to an integer or bool dtype
  with ``.to``/``.int()``/``.long()``/``.bool()``, an integer-literal arm
  of ``torch.where``, an integer-hinting name: ``*mask``, ``*count``,
  ``*idx``...).  Float evidence (a float literal, a cast to a float dtype)
  clears it.

As in the reference the evidence walk under-approximates: an operand whose
dtype the AST cannot see is not flagged.
"""

from __future__ import annotations

import ast
import re

from kube_scheduler_simulator_tpu_torch.analysis.framework import Finding, Project, Rule, SourceFile

CREATION = {"arange", "zeros", "ones", "full", "empty"}
REDUCTION = {"sum", "cumsum", "prod"}

_INT_DTYPE = re.compile(r"^(u?int(8|16|32|64)|bool|long|short|uint8)$")
_FLOAT_DTYPE = re.compile(r"^(float(16|32|64)?|double|half|bfloat16)$")
_INT_NAME_HINT = re.compile(r"(^|_)(mask|count|cnt|idx|index|ids|rank|slots)$")
_INT_CASTS = {"int", "long", "bool", "short"}
_FLOAT_CASTS = {"float", "double", "half"}


def _is_torch(func: ast.AST) -> "str | None":
    """``torch.<name>`` → name, else None."""
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name) and func.value.id == "torch":
        return func.attr
    return None


def _dtype_class(node: ast.AST) -> "str | None":
    """'int' / 'float' / None for an expression used as a dtype."""
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    else:
        return None
    if name in ("bool", "int"):
        return "int"
    if name == "float":
        return "float"
    if _INT_DTYPE.match(name):
        return "int"
    if _FLOAT_DTYPE.match(name):
        return "float"
    return None


def _combine(a: "str | None", b: "str | None") -> "str | None":
    if a == "float" or b == "float":
        return "float"
    if a == "int" or b == "int":
        return "int"
    return None


def _evidence(node: ast.AST) -> "str | None":
    """Integer/float evidence of a reduction's operand; float wins."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (bool, int)):
            return "int"
        if isinstance(node.value, float):
            return "float"
        return None
    if isinstance(node, (ast.Compare, ast.BoolOp)):
        return "int"
    if isinstance(node, ast.UnaryOp):
        return "int" if isinstance(node.op, (ast.Not, ast.Invert)) else _evidence(node.operand)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _INT_CASTS and not node.args:
            return "int"
        if attr in _FLOAT_CASTS and not node.args:
            return "float"
        if attr == "to":
            for a in list(node.args) + [kw.value for kw in node.keywords if kw.arg == "dtype"]:
                c = _dtype_class(a)
                if c is not None:
                    return c
            return None
        if _is_torch(node.func) == "where" and len(node.args) >= 3:
            return _combine(_evidence(node.args[1]), _evidence(node.args[2]))
        if _is_torch(node.func) in ("logical_and", "logical_or", "logical_not", "isin", "eq", "ne", "lt", "le",
                                    "gt", "ge"):
            return "int"
        return None
    if isinstance(node, ast.BinOp):
        return _combine(_evidence(node.left), _evidence(node.right))
    if isinstance(node, ast.Subscript):
        return _evidence(node.value)
    if isinstance(node, (ast.Name, ast.Attribute)):
        name = node.id if isinstance(node, ast.Name) else node.attr
        return "int" if _INT_NAME_HINT.search(name) else None
    return None


class DtypeRule(Rule):
    name = "KSS-DTYPE"
    paths = (
        "kube_scheduler_simulator_tpu_torch/ops/*.py",
        "kube_scheduler_simulator_tpu_torch/preemption/kernel.py",
        "kube_scheduler_simulator_tpu_torch/gang/kernel.py",
        "kube_scheduler_simulator_tpu_torch/tuning/relax.py",
        "kube_scheduler_simulator_tpu_torch/tuning/objective.py",
    )

    def check_file(self, src: SourceFile, ctx: Project) -> "list[Finding]":
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            kws = {kw.arg for kw in node.keywords}
            fname = _is_torch(node.func)
            if fname in CREATION:
                missing = [k for k in ("dtype", "device") if k not in kws]
                if missing:
                    out.append(src.finding(
                        self.name, node,
                        f"torch.{fname} without {' and '.join(k + '=' for k in missing)}: the tensor takes "
                        "torch's default dtype (or one inferred from a Python number) and lands on the CPU; "
                        f"pin both: torch.{fname}(..., dtype=..., device=...).",
                    ))
                continue
            if "dtype" in kws or not isinstance(node.func, ast.Attribute) or node.func.attr not in REDUCTION:
                continue
            if fname is not None:
                operand = node.args[0] if node.args else None
            elif isinstance(node.func.value, ast.Name) and node.func.value.id in ("np", "numpy", "math"):
                continue
            else:
                operand = node.func.value
            if operand is not None and _evidence(operand) == "int":
                out.append(src.finding(
                    self.name, node,
                    f"{node.func.attr}() over an integer or bool tensor without dtype=: torch promotes it to "
                    "int64, where the kernels and their wrappers take fixed types. Pin it: "
                    f".{node.func.attr}(..., dtype=torch.int32) (or the dtype the consumer takes).",
                ))
        return out
