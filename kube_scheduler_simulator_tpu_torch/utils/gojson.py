"""Go-compatible JSON encoding.

The reference serializes every scheduling result map with Go's
``encoding/json.Marshal`` before writing it into a Pod annotation, and the
golden tests pin those exact bytes.  Go's encoder differs from
``json.dumps`` in three ways we must reproduce to stay byte-identical:

1. map keys are emitted in sorted order,
2. output is compact (no spaces after ``:`` or ``,``),
3. ``<``, ``>`` and ``&`` are HTML-escaped to ``\\u003c``/``\\u003e``/
   ``\\u0026`` by default.

``go_string`` runs through the C renderer (``native/fastjson.c``) when it
loaded, and through the Python escape below otherwise: the same bytes.
"""

from __future__ import annotations

import json
import re
from typing import Any


def _escape_html(s: str) -> str:
    return (
        s.replace("&", "\\u0026")
        .replace("<", "\\u003c")
        .replace(">", "\\u003e")
        # Go also escapes the JS line separators by default.
        .replace(" ", "\\u2028")
        .replace(" ", "\\u2029")
    )


class RawJSON(str):
    """A string that IS already go_marshal output.  Producers that can
    assemble the exact bytes from pre-escaped fragments (the batch
    engine's annotation writer) wrap them in RawJSON so go_marshal
    passes them through instead of re-encoding."""

    __slots__ = ()


def go_marshal(obj: Any) -> str:
    """Serialize ``obj`` the way Go's ``json.Marshal`` would."""
    if isinstance(obj, RawJSON):
        return obj
    raw = json.dumps(obj, sort_keys=True, separators=(",", ":"), ensure_ascii=False)
    # json.dumps never emits raw & < > outside of string literals, so a
    # post-pass escape over the whole document only touches string contents
    # (and is what Go's encoder effectively does too).
    return _escape_html(raw)


def go_string_key(s: str) -> str:
    """``"key":`` fragment exactly as go_marshal would emit it."""
    return _escape_html(json.dumps(s, ensure_ascii=False)) + ":"


# characters the fast path below cannot handle with plain replaces:
# JSON-mandatory \uXXXX control escapes (json.dumps would emit them)
_CTRL_RE = re.compile("[\x00-\x1f\u2028\u2029]")


def _go_string_py(s: str) -> str:
    if _CTRL_RE.search(s):
        return _escape_html(json.dumps(s, ensure_ascii=False))
    return (
        '"'
        + s.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("&", "\\u0026")
        .replace("<", "\\u003c")
        .replace(">", "\\u003e")
        + '"'
    )


def go_string(s: str) -> str:
    """A JSON string literal (quotes included) exactly as go_marshal emits
    it.  The history annotation re-encodes megabyte annotation values as
    JSON strings every attempt: the C escape does it in one pass, the
    Python one in C-level ``str.replace`` passes (tests/test_torch_native.py
    pins them equal).  Strings UTF-8 cannot encode (lone surrogates from
    permissive JSON input) take the Python path, which keeps them as
    ``json.dumps`` does."""
    if _fastjson is not None:
        try:
            return _fastjson.escape_string(s)
        except UnicodeEncodeError:
            pass
    return _go_string_py(s)


# bound once: the native package imports only the standard library, and
# go_string runs millions of times a wave
from kube_scheduler_simulator_tpu_torch.native import fastjson as _fastjson  # noqa: E402
