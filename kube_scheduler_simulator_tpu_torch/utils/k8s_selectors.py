"""kube list/watch selector strings: ``labelSelector`` + ``fieldSelector``.

The reference serves these natively because its port IS a real
kube-apiserver (reference simulator/k8sapiserver/k8sapiserver.go:34-88);
client-go informers and external schedulers rely on them (e.g. a
kube-scheduler lists/watches pods with ``spec.schedulerName=`` and
``spec.nodeName=`` field selectors).  Grammar follows
k8s.io/apimachinery/pkg/labels.Parse and fields.ParseSelector.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

Obj = Mapping[str, Any]

# ``key in (a,b)`` / ``key notin (a,b)`` — apimachinery's lexer treats
# "(" as a delimiter, so the space before the paren is optional
_SET_RE = re.compile(r"^(?P<key>.+?)\s+(?P<op>in|notin)\s*\((?P<vals>[^()]*)\)$")


class SelectorError(ValueError):
    """Malformed selector string or unsupported field (HTTP 400)."""


def _split_requirements(s: str) -> list[str]:
    """Split on commas NOT inside ``in (...)`` value lists."""
    out: list[str] = []
    depth = 0
    cur: list[str] = []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [r.strip() for r in out if r.strip()]


def parse_label_selector(s: str) -> Callable[[Mapping[str, str]], bool]:
    """Compile a labelSelector string to a predicate over a labels map.

    Supports the full apimachinery grammar: ``k=v``, ``k==v``, ``k!=v``,
    ``k in (a,b)``, ``k notin (a,b)``, ``k`` (exists), ``!k`` (not
    exists)."""
    reqs: list[Callable[[Mapping[str, str]], bool]] = []
    for r in _split_requirements(s):
        m = _SET_RE.match(r)
        if m is not None:
            key = m.group("key").strip()
            values = {v.strip() for v in m.group("vals").split(",") if v.strip()}
            if m.group("op") == "notin":
                # apimachinery: notin matches when the key is absent too
                reqs.append(lambda lbl, k=key, vs=values: lbl.get(k) not in vs)
            else:
                reqs.append(lambda lbl, k=key, vs=values: lbl.get(k) in vs)
        elif "!=" in r:
            key, _, val = r.partition("!=")
            reqs.append(lambda lbl, k=key.strip(), v=val.strip(): lbl.get(k) != v)
        elif "==" in r:
            key, _, val = r.partition("==")
            reqs.append(lambda lbl, k=key.strip(), v=val.strip(): lbl.get(k) == v)
        elif "=" in r:
            key, _, val = r.partition("=")
            reqs.append(lambda lbl, k=key.strip(), v=val.strip(): lbl.get(k) == v)
        elif r.startswith("!"):
            key = r[1:].strip()
            _require_label_key(key, r)
            reqs.append(lambda lbl, k=key: k not in lbl)
        else:
            # exists-requirement: the token must be a plausible label key —
            # a malformed set requirement ('env in prod', 'env IN (x)')
            # must 400, not silently match nothing (apimachinery rejects
            # them too)
            _require_label_key(r, r)
            reqs.append(lambda lbl, k=r: k in lbl)
    return lambda labels: all(req(labels) for req in reqs)


_KEY_RE = re.compile(r"[A-Za-z0-9._/-]+\Z")


def _require_label_key(key: str, requirement: str) -> None:
    if not key or not _KEY_RE.match(key):
        raise SelectorError(f"invalid label selector requirement: {requirement!r}")


# The field paths the real apiserver supports for the kinds external
# schedulers watch (pod fields per pkg/registry/core/pod ToSelectableFields,
# plus metadata.* which every kind supports).
def _field_value(obj: Obj, path: str) -> "str | None":
    if path == "metadata.name":
        return obj.get("metadata", {}).get("name", "")
    if path == "metadata.namespace":
        return obj.get("metadata", {}).get("namespace", "default")
    if path == "spec.nodeName":
        return (obj.get("spec") or {}).get("nodeName") or ""
    if path == "spec.schedulerName":
        return (obj.get("spec") or {}).get("schedulerName") or "default-scheduler"
    if path == "spec.restartPolicy":
        return (obj.get("spec") or {}).get("restartPolicy") or "Always"
    if path == "status.phase":
        return (obj.get("status") or {}).get("phase") or ""
    if path == "status.nominatedNodeName":
        return (obj.get("status") or {}).get("nominatedNodeName") or ""
    return None


_FIELD_PATHS = (
    "metadata.name",
    "metadata.namespace",
    "spec.nodeName",
    "spec.schedulerName",
    "spec.restartPolicy",
    "status.phase",
    "status.nominatedNodeName",
)


def parse_field_selector(s: str) -> Callable[[Obj], bool]:
    """Compile a fieldSelector string (``path=value`` / ``==`` / ``!=``,
    comma-separated) to a predicate over an object."""
    reqs: list[Callable[[Obj], bool]] = []
    for r in _split_requirements(s):
        if "!=" in r:
            path, _, val = r.partition("!=")
            neg = True
        elif "==" in r:
            path, _, val = r.partition("==")
            neg = False
        elif "=" in r:
            path, _, val = r.partition("=")
            neg = False
        else:
            raise SelectorError(f"invalid field selector requirement: {r!r}")
        path = path.strip()
        val = val.strip()
        if path not in _FIELD_PATHS:
            raise SelectorError(f'field label not supported: "{path}"')
        if neg:
            reqs.append(lambda o, p=path, v=val: _field_value(o, p) != v)
        else:
            reqs.append(lambda o, p=path, v=val: _field_value(o, p) == v)
    return lambda obj: all(req(obj) for req in reqs)


def compile_selectors(
    label_selector: "str | None", field_selector: "str | None"
) -> "Callable[[Obj], bool] | None":
    """One object predicate for the two query params (None = match all)."""
    preds: list[Callable[[Obj], bool]] = []
    if label_selector:
        lsel = parse_label_selector(label_selector)
        preds.append(lambda o: lsel(o.get("metadata", {}).get("labels") or {}))
    if field_selector:
        preds.append(parse_field_selector(field_selector))
    if not preds:
        return None
    if len(preds) == 1:
        return preds[0]
    return lambda o: all(p(o) for p in preds)
