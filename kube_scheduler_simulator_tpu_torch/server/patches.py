"""PATCH verb semantics for the kube-API port (server/kubeapi.py).

Two wire formats beyond the default merge-patch:

- ``application/json-patch+json``: RFC 6902 — an ordered list of
  add/remove/replace/move/copy/test operations over JSON pointers
  (with ``~0``/``~1`` escapes and the ``-`` append index).  A malformed
  document (not a list, unknown op, bad pointer syntax) is a 400; a
  well-formed patch that fails to APPLY (missing path, failed ``test``)
  is a 422, matching the apiserver's invalid-patch classification.

- ``application/apply-patch+yaml``: server-side apply, field-manager
  LITE.  Real SSA tracks ownership to the leaf through FieldsV1 sets;
  concurrent tenants need the conflict protocol far more than the leaf
  granularity, so this build tracks last-writer-per-TOP-LEVEL-field
  (``spec``, ``status``, ``data``, …) in ``metadata.managedFields``
  (real wire shape, coarse sets).  Applying a field another manager
  owns is a 409 Conflict naming the owner unless ``force=true``, which
  transfers ownership — the upstream protocol, at field granularity.
  Documented deviations from full SSA: ``metadata.labels`` /
  ``metadata.annotations`` merge per key without ownership, and fields
  a manager stops sending are NOT pruned (last-writer wins, nothing
  reverts).

Both run under the store lock at the call site: read-modify-write is
atomic against concurrent writers, and optimistic concurrency still
applies (a patched doc carries its resourceVersion into ``update``).
"""

from __future__ import annotations

import copy
from typing import Any

Obj = dict[str, Any]


class PatchError(Exception):
    """Malformed patch document — HTTP 400."""


class PatchApplyError(Exception):
    """Well-formed patch that cannot apply (missing path, failed test)
    — HTTP 422."""


class ApplyConflictError(Exception):
    """SSA without force against fields another manager owns — 409."""

    def __init__(self, manager: str, conflicts: "dict[str, str]"):
        self.manager = manager
        self.conflicts = conflicts  # field -> owning manager
        owners = ", ".join(f"{f!r} (owned by {m!r})" for f, m in sorted(conflicts.items()))
        super().__init__(
            f"apply by manager {manager!r} conflicts with: {owners}; "
            "retry with force=true to take ownership"
        )


# ------------------------------------------------------------ RFC 6902


def _pointer(path: Any) -> "list[str]":
    if not isinstance(path, str):
        raise PatchError(f"pointer must be a string, got {type(path).__name__}")
    if path == "":
        return []
    if not path.startswith("/"):
        raise PatchError(f"pointer must start with '/', got {path!r}")
    return [t.replace("~1", "/").replace("~0", "~") for t in path.split("/")[1:]]


def _index(token: str, n: int, append_ok: bool) -> int:
    if token == "-":
        if not append_ok:
            raise PatchApplyError("'-' only addresses the append position in add")
        return n
    if not token.isdigit() and not (token.startswith("-") and token[1:].isdigit()):
        raise PatchError(f"array index must be an integer, got {token!r}")
    i = int(token)
    if i < 0 or i > (n if append_ok else n - 1):
        raise PatchApplyError(f"array index {i} out of range for length {n}")
    return i


def _walk(doc: Any, tokens: "list[str]") -> Any:
    """The container holding the final token's slot (the document itself
    for a root pointer's parent — tokens must be non-empty)."""
    node = doc
    for t in tokens:
        if isinstance(node, dict):
            if t not in node:
                raise PatchApplyError(f"path segment {t!r} not found")
            node = node[t]
        elif isinstance(node, list):
            node = node[_index(t, len(node), append_ok=False)]
        else:
            raise PatchApplyError(f"cannot traverse into {type(node).__name__} at {t!r}")
    return node


def _get(doc: Any, tokens: "list[str]") -> Any:
    return _walk(doc, tokens)


def _add(doc: Any, tokens: "list[str]", value: Any) -> Any:
    if not tokens:
        return value  # whole-document replace
    parent = _walk(doc, tokens[:-1])
    last = tokens[-1]
    if isinstance(parent, dict):
        parent[last] = value
    elif isinstance(parent, list):
        parent.insert(_index(last, len(parent), append_ok=True), value)
    else:
        raise PatchApplyError(f"cannot add into {type(parent).__name__}")
    return doc


def _remove(doc: Any, tokens: "list[str]") -> Any:
    if not tokens:
        raise PatchApplyError("cannot remove the whole document")
    parent = _walk(doc, tokens[:-1])
    last = tokens[-1]
    if isinstance(parent, dict):
        if last not in parent:
            raise PatchApplyError(f"path segment {last!r} not found")
        del parent[last]
    elif isinstance(parent, list):
        del parent[_index(last, len(parent), append_ok=False)]
    else:
        raise PatchApplyError(f"cannot remove from {type(parent).__name__}")
    return doc


def _replace(doc: Any, tokens: "list[str]", value: Any) -> Any:
    if not tokens:
        return value
    _get(doc, tokens)  # must exist (RFC 6902 §4.3)
    parent = _walk(doc, tokens[:-1])
    last = tokens[-1]
    if isinstance(parent, dict):
        parent[last] = value
    else:
        parent[_index(last, len(parent), append_ok=False)] = value
    return doc


def apply_json_patch(doc: Obj, ops: Any) -> Obj:
    """Apply an RFC 6902 operation list to a deep copy of ``doc``."""
    if not isinstance(ops, list):
        raise PatchError("a JSON patch is a LIST of operations")
    out: Any = copy.deepcopy(doc)
    for i, op in enumerate(ops):
        if not isinstance(op, dict) or "op" not in op:
            raise PatchError(f"operation {i} must be an object with an 'op' field")
        verb = op["op"]
        if verb not in ("add", "remove", "replace", "move", "copy", "test"):
            raise PatchError(f"operation {i}: unknown op {verb!r}")
        if "path" not in op:
            raise PatchError(f"operation {i} ({verb}): missing 'path'")
        tokens = _pointer(op["path"])
        if verb in ("add", "replace", "test"):
            if "value" not in op:
                raise PatchError(f"operation {i} ({verb}): missing 'value'")
        if verb in ("move", "copy"):
            if "from" not in op:
                raise PatchError(f"operation {i} ({verb}): missing 'from'")
            src = _pointer(op["from"])
        if verb == "add":
            out = _add(out, tokens, copy.deepcopy(op["value"]))
        elif verb == "remove":
            out = _remove(out, tokens)
        elif verb == "replace":
            out = _replace(out, tokens, copy.deepcopy(op["value"]))
        elif verb == "test":
            if _get(out, tokens) != op["value"]:
                raise PatchApplyError(
                    f"operation {i}: test failed at {op['path']!r}"
                )
        elif verb == "move":
            if src == tokens[: len(src)] and len(src) < len(tokens):
                raise PatchError(f"operation {i}: cannot move into own child")
            value = _get(out, src)
            out = _remove(out, src)
            out = _add(out, tokens, value)
        elif verb == "copy":
            out = _add(out, tokens, copy.deepcopy(_get(out, src)))
    if not isinstance(out, dict):
        raise PatchApplyError("patched document is no longer an object")
    return out


# ------------------------------------------------------- server-side apply

_META_FIELDS = ("apiVersion", "kind", "metadata")


def _owner_map(obj: Obj) -> "dict[str, str]":
    owners: "dict[str, str]" = {}
    for entry in (obj.get("metadata") or {}).get("managedFields") or []:
        mgr = entry.get("manager") or ""
        for f in entry.get("fieldsV1") or {}:
            if f.startswith("f:"):
                owners[f[2:]] = mgr
    return owners


def _managed_fields(owners: "dict[str, str]", api_version: str) -> "list[Obj]":
    by_mgr: "dict[str, list[str]]" = {}
    for f, m in owners.items():
        by_mgr.setdefault(m, []).append(f)
    return [
        {
            "manager": m,
            "operation": "Apply",
            "apiVersion": api_version,
            "fieldsType": "FieldsV1",
            "fieldsV1": {f"f:{f}": {} for f in sorted(fields)},
        }
        for m, fields in sorted(by_mgr.items())
    ]


def server_side_apply(
    existing: "Obj | None",
    patch: Obj,
    manager: str,
    force: bool,
    api_version: str = "v1",
) -> "tuple[Obj, bool]":
    """Apply ``patch`` as ``manager``; returns (new object, created).

    ``existing`` is the live object (None → create).  Raises
    :class:`ApplyConflictError` when a non-forced apply touches fields
    another manager owns.
    """
    if not isinstance(patch, dict):
        raise PatchError("an apply configuration must be an object")
    if not manager:
        raise PatchError("server-side apply requires a fieldManager")
    fields = [k for k in patch if k not in _META_FIELDS]
    meta_patch = patch.get("metadata") or {}
    if not isinstance(meta_patch, dict):
        raise PatchError("metadata must be an object")
    if existing is None:
        new = {k: copy.deepcopy(v) for k, v in patch.items() if k not in ("metadata",)}
        new["metadata"] = {
            k: copy.deepcopy(v)
            for k, v in meta_patch.items()
            if k not in ("managedFields", "resourceVersion", "uid")
        }
        owners = {f: manager for f in fields}
        new["metadata"]["managedFields"] = _managed_fields(owners, api_version)
        return new, True
    new = copy.deepcopy(existing)
    owners = _owner_map(existing)
    conflicts = {
        f: owners[f] for f in fields if owners.get(f) not in (None, manager)
    }
    if conflicts and not force:
        raise ApplyConflictError(manager, conflicts)
    for f in fields:
        new[f] = copy.deepcopy(patch[f])
        owners[f] = manager
    meta = new.setdefault("metadata", {})
    for mk in ("labels", "annotations"):
        if isinstance(meta_patch.get(mk), dict):
            merged = dict(meta.get(mk) or {})
            merged.update(copy.deepcopy(meta_patch[mk]))
            meta[mk] = merged
    meta["managedFields"] = _managed_fields(owners, api_version)
    return new, False
