"""Tree-walking interpreter for the web UI's JavaScript subset.

Executes the AST produced by ``utils.jscheck`` so the test suite can RUN
the served UI code — render paths, event handlers, filters — against a
stub DOM (``utils.jsdom``), with no JS engine in the image.  The
reference gets execution-level coverage from its Nuxt/Vitest toolchain;
this is the from-scratch analog sized to the language subset the UI
actually uses (ES2017 minus classes/generators/modules).

Semantics notes:
- ``async``/``await`` run synchronously: the UI's awaits are all on
  ``fetch``/``text()``, which the host supplies as synchronous stubs.
  ``.then(cb)`` applies ``cb`` immediately.
- Numbers follow Python arithmetic with JS coercions for ``+``,
  comparisons, and truthiness; this matches the UI's usage (no NaN
  propagation subtleties in render paths).
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Callable

from kube_scheduler_simulator_tpu_torch.utils import jscheck
from kube_scheduler_simulator_tpu_torch.utils.jscheck import JSError, decode_template_text


class JSUndefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __bool__(self):
        return False

    def __repr__(self):
        return "undefined"


UNDEF = JSUndefined()


class JSObject(dict):
    """A JS object literal / JSON object (plain property bag)."""


class JSArray(list):
    """A JS array."""


class JSRegExp:
    def __init__(self, pattern: str, flags: str):
        self.source = pattern
        self.flags = flags
        pyflags = re.IGNORECASE if "i" in flags else 0
        self.compiled = re.compile(_js_regex_to_py(pattern), pyflags)
        self.global_ = "g" in flags


def _js_regex_to_py(p: str) -> str:
    # the UI's regexes are already PCRE-compatible
    return p


class JSFunction:
    def __init__(self, interp, name, params, body, scope, is_async):
        self.interp = interp
        self.name = name or "<anonymous>"
        self.params = params
        self.body = body
        self.scope = scope
        self.is_async = is_async

    def __call__(self, *args):  # callable from host code too
        return self.interp.call(self, list(args))


class ThrowSig(Exception):
    def __init__(self, value):
        self.value = value
        super().__init__(str(value))


class PendingAwait(Exception):
    """Raised when the script awaits a promise that will only resolve via
    the (host-controlled) timer queue — the synchronous interpreter treats
    it as "the script went idle".  NOT a ThrowSig, so JS try/catch cannot
    swallow it; the host harness catches it at the top."""


class JSPromise:
    def __init__(self, value=UNDEF, resolved=False):
        self.value = value
        self.resolved = resolved

    def resolve(self, value=UNDEF):
        self.value = value
        self.resolved = True

    # .then/.catch/.finally surface (looked up via member_get host-object path)
    @property
    def then(self):
        def _then(cb=None, *a):
            if not self.resolved:
                raise PendingAwait()
            if cb is not None and cb is not UNDEF:
                out = cb(self.value) if callable(cb) else cb.interp.call(cb, [self.value])
                return out if isinstance(out, JSPromise) else JSPromise(out, resolved=True)
            return self
        return _native(_then)

    @property
    def catch(self):
        return _native(lambda *a: self)


class _ReturnSig(Exception):
    def __init__(self, value):
        self.value = value


class _BreakSig(Exception):
    pass


class _ContinueSig(Exception):
    pass


class Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars: dict[str, Any] = {}
        self.parent = parent

    def declare(self, name, value):
        self.vars[name] = value

    def get(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        raise ThrowSig(_mk_error("ReferenceError", f"{name} is not defined"))

    def set(self, name, value):
        s = self
        while s is not None:
            if name in s.vars:
                s.vars[name] = value
                return
            s = s.parent
        raise ThrowSig(_mk_error("ReferenceError", f"{name} is not defined"))


def _mk_error(kind: str, message: str) -> JSObject:
    o = JSObject()
    o["name"] = kind
    o["message"] = message
    return o


# --------------------------------------------------------------------------
# coercions


def to_bool(v) -> bool:
    if v is UNDEF or v is None or v is False:
        return False
    if v is True:
        return True
    if isinstance(v, (int, float)):
        return v != 0 and v == v  # NaN falsy
    if isinstance(v, str):
        return v != ""
    return True


def to_num(v):
    if isinstance(v, bool):
        return 1 if v else 0
    if isinstance(v, (int, float)):
        return v
    if v is None:
        return 0
    if v is UNDEF:
        return float("nan")
    if isinstance(v, str):
        s = v.strip()
        if not s:
            return 0
        try:
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return float("nan")
    return float("nan")


def to_str(v) -> str:
    if isinstance(v, str):
        return v
    if v is UNDEF:
        return "undefined"
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v == int(v) and abs(v) < 1e21:
            return str(int(v))
        return repr(v)
    if isinstance(v, int):
        return str(v)
    if isinstance(v, JSArray):
        return ",".join("" if x is None or x is UNDEF else to_str(x) for x in v)
    if isinstance(v, JSObject):
        if "name" in v and "message" in v:  # Error-like
            return f"{v['name']}: {v['message']}"
        return "[object Object]"
    if isinstance(v, JSFunction):
        return f"function {v.name}() {{ ... }}"
    return str(v)


def strict_eq(a, b) -> bool:
    if a is UNDEF or b is UNDEF:
        return a is b
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    if type(a) is not type(b) and not (isinstance(a, str) and isinstance(b, str)):
        if isinstance(a, (JSObject, JSArray)) or isinstance(b, (JSObject, JSArray)):
            return a is b
        return False
    if isinstance(a, (JSObject, JSArray)):
        return a is b
    return a == b


def loose_eq(a, b) -> bool:
    if (a is None or a is UNDEF) and (b is None or b is UNDEF):
        return True
    if (a is None or a is UNDEF) or (b is None or b is UNDEF):
        return False
    if isinstance(a, str) and isinstance(b, (int, float)) or (
        isinstance(b, str) and isinstance(a, (int, float))
    ):
        return to_num(a) == to_num(b)
    return strict_eq(a, b)


# --------------------------------------------------------------------------
# member access: strings / arrays / objects / host objects


def _string_member(interp, s: str, name: str):
    simple = {
        "toLowerCase": lambda: s.lower(),
        "toUpperCase": lambda: s.upper(),
        "trim": lambda: s.strip(),
    }
    if name == "length":
        return len(s)
    if name in simple:
        return _native(lambda *a: simple[name]())
    if name == "includes":
        return _native(lambda sub, *a: to_str(sub) in s)
    if name == "endsWith":
        return _native(lambda sub, *a: s.endswith(to_str(sub)))
    if name == "startsWith":
        return _native(lambda sub, *a: s.startswith(to_str(sub)))
    if name == "indexOf":
        return _native(lambda sub, *a: s.find(to_str(sub)))
    if name == "lastIndexOf":
        return _native(lambda sub, *a: s.rfind(to_str(sub)))
    if name == "charAt":
        return _native(lambda i=0, *a: s[int(to_num(i))] if 0 <= int(to_num(i)) < len(s) else "")
    if name == "slice":
        return _native(lambda start=0, end=None, *a: _slice(s, start, end))
    if name == "split":
        def split(sep=UNDEF, *a):
            if sep is UNDEF:
                return JSArray([s])
            if isinstance(sep, JSRegExp):
                return JSArray(sep.compiled.split(s))
            sep = to_str(sep)
            return JSArray(list(s)) if sep == "" else JSArray(s.split(sep))
        return _native(split)
    if name == "repeat":
        return _native(lambda nrep, *a: s * int(to_num(nrep)))
    if name == "padStart":
        return _native(lambda w, fill=" ", *a: s.rjust(int(to_num(w)), to_str(fill) or " "))
    if name == "replace":
        def replace(pat, repl, *a):
            rf = (lambda m: to_str(interp.call_any(repl, [m.group(0)]))) if callable(repl) or isinstance(repl, JSFunction) else None
            if isinstance(pat, JSRegExp):
                count = 0 if pat.global_ else 1
                if rf is not None:
                    return pat.compiled.sub(rf, s, count=count)
                return pat.compiled.sub(to_str(repl).replace("\\", "\\\\"), s, count=count)
            pat = to_str(pat)
            rep = to_str(interp.call_any(repl, [pat])) if rf is not None else to_str(repl)
            return s.replace(pat, rep, 1)
        return _native(replace)
    if name == "match":
        def match(pat, *a):
            rx = pat if isinstance(pat, JSRegExp) else JSRegExp(to_str(pat), "")
            if rx.global_:
                found = rx.compiled.findall(s)
                return JSArray(found) if found else None
            m = rx.compiled.search(s)
            if m is None:
                return None
            return JSArray([m.group(0)] + [g if g is not None else UNDEF for g in m.groups()])
        return _native(match)
    if name.isdigit():
        i = int(name)
        return s[i] if i < len(s) else UNDEF
    return UNDEF


def _array_member(interp, arr: JSArray, name: str):
    if name == "length":
        return len(arr)
    if name == "push":
        return _native(lambda *items: (arr.extend(items), len(arr))[1])
    if name == "pop":
        return _native(lambda *a: arr.pop() if arr else UNDEF)
    if name == "map":
        return _native(lambda fn, *a: JSArray(interp.call_any(fn, [v, i, arr]) for i, v in enumerate(list(arr))))
    if name == "filter":
        return _native(lambda fn, *a: JSArray(v for i, v in enumerate(list(arr)) if to_bool(interp.call_any(fn, [v, i, arr]))))
    if name == "forEach":
        def foreach(fn, *a):
            for i, v in enumerate(list(arr)):
                interp.call_any(fn, [v, i, arr])
            return UNDEF
        return _native(foreach)
    if name == "join":
        return _native(lambda sep=",", *a: to_str(sep).join("" if v is None or v is UNDEF else to_str(v) for v in arr))
    if name == "includes":
        return _native(lambda v, *a: any(strict_eq(v, x) for x in arr))
    if name == "indexOf":
        return _native(lambda v, *a: next((i for i, x in enumerate(arr) if strict_eq(v, x)), -1))
    if name == "find":
        return _native(lambda fn, *a: next((v for i, v in enumerate(arr) if to_bool(interp.call_any(fn, [v, i, arr]))), UNDEF))
    if name == "some":
        return _native(lambda fn, *a: any(to_bool(interp.call_any(fn, [v, i, arr])) for i, v in enumerate(list(arr))))
    if name == "every":
        return _native(lambda fn, *a: all(to_bool(interp.call_any(fn, [v, i, arr])) for i, v in enumerate(list(arr))))
    if name == "slice":
        return _native(lambda start=0, end=None, *a: JSArray(_slice(list(arr), start, end)))
    if name == "concat":
        def concat(*others):
            out = JSArray(arr)
            for o in others:
                out.extend(o) if isinstance(o, list) else out.append(o)
            return out
        return _native(concat)
    if name == "flat":
        def flat(*a):
            out = JSArray()
            for v in arr:
                out.extend(v) if isinstance(v, list) else out.append(v)
            return out
        return _native(flat)
    if name == "sort":
        def sort(cmp=None, *a):
            import functools

            if cmp is None:
                arr.sort(key=to_str)
            else:
                arr.sort(key=functools.cmp_to_key(lambda x, y: (lambda r: -1 if r < 0 else (1 if r > 0 else 0))(to_num(interp.call_any(cmp, [x, y])))))
            return arr
        return _native(sort)
    return UNDEF


def _native(fn: Callable) -> Callable:
    """Mark a host callable as a JS-callable builtin.  Dispatch is by
    ``callable()`` everywhere, so this is documentation-by-name at the
    60+ construction sites, not a runtime tag."""
    return fn


def _slice(seq, start, end):
    n = len(seq)
    s = int(to_num(start)) if start is not None and start is not UNDEF else 0
    e = int(to_num(end)) if end is not None and end is not UNDEF else n
    if s < 0:
        s += n
    if e < 0:
        e += n
    return seq[max(0, s) : max(0, e)]


# --------------------------------------------------------------------------
# JSON bridge


def js_from_py(v):
    """Deep-convert parsed-JSON Python values into interpreter values."""
    if isinstance(v, dict):
        o = JSObject()
        for k, val in v.items():
            o[k] = js_from_py(val)
        return o
    if isinstance(v, list):
        return JSArray(js_from_py(x) for x in v)
    return v


def py_from_js(v):
    if isinstance(v, JSObject):
        return {k: py_from_js(x) for k, x in v.items() if x is not UNDEF}
    if isinstance(v, JSArray):
        return [None if x is UNDEF else py_from_js(x) for x in v]
    if v is UNDEF:
        return None
    return v


# --------------------------------------------------------------------------
# the interpreter


class Interp:
    def __init__(self, host_globals: "dict[str, Any] | None" = None):
        self.root = Scope()
        for name, v in _std_globals(self).items():
            self.root.declare(name, v)
        for name, v in (host_globals or {}).items():
            self.root.declare(name, v)

    # ---- program

    def run(self, src: str) -> Scope:
        ast = jscheck.parse(src)
        self.exec_block(ast[1], self.root)
        return self.root

    def get_global(self, name: str):
        return self.root.get(name)

    # ---- calls

    def call(self, fn: JSFunction, args: list, this=None):
        scope = Scope(fn.scope)
        scope.declare("this", this if this is not None else UNDEF)
        for idx, (pat, default) in enumerate(fn.params):
            v = args[idx] if idx < len(args) else UNDEF
            if v is UNDEF and default is not None:
                v = self.eval(default, scope)
            self.bind_pattern(pat, v, scope)
        ret = UNDEF
        try:
            self.exec_block(fn.body[1], scope)
        except _ReturnSig as r:
            ret = r.value
        if fn.is_async and not isinstance(ret, JSPromise):
            # async functions resolve synchronously in this host
            return JSPromise(ret, resolved=True)
        return ret

    def call_any(self, fn, args: list, this=None):
        if isinstance(fn, JSFunction):
            return self.call(fn, args, this)
        if callable(fn):
            return fn(*args)
        raise ThrowSig(_mk_error("TypeError", f"{to_str(fn)} is not a function"))

    # ---- statements

    def exec_block(self, stmts, scope: Scope) -> None:
        # hoist function declarations (the UI calls forward)
        for st in stmts:
            if st[0] == "funcdecl":
                scope.declare(st[1], JSFunction(self, st[1], st[3], st[4], scope, st[5]))
        for st in stmts:
            self.exec_stmt(st, scope)

    def exec_stmt(self, st, scope: Scope) -> None:
        tag = st[0]
        if tag == "expr":
            self.eval(st[1], scope)
        elif tag == "vardecl":
            for pat, init in st[2]:
                v = self.eval(init, scope) if init is not None else UNDEF
                self.bind_pattern(pat, v, scope)
        elif tag == "funcdecl":
            pass  # hoisted
        elif tag == "block":
            self.exec_block(st[1], Scope(scope))
        elif tag == "if":
            if to_bool(self.eval(st[1], scope)):
                self.exec_stmt(st[2], scope)
            elif st[3] is not None:
                self.exec_stmt(st[3], scope)
        elif tag == "while":
            while to_bool(self.eval(st[1], scope)):
                try:
                    self.exec_stmt(st[2], scope)
                except _BreakSig:
                    break
                except _ContinueSig:
                    continue
        elif tag == "dowhile":
            while True:
                try:
                    self.exec_stmt(st[1], scope)
                except _BreakSig:
                    break
                except _ContinueSig:
                    pass
                if not to_bool(self.eval(st[2], scope)):
                    break
        elif tag == "forof":
            pat, it_expr, body, mode = st[1], st[2], st[3], st[4]
            it = self.eval(it_expr, scope)
            items = self._iterate(it, mode)
            for v in items:
                s = Scope(scope)
                self.bind_pattern(pat, v, s)
                try:
                    self.exec_stmt(body, s)
                except _BreakSig:
                    break
                except _ContinueSig:
                    continue
        elif tag == "for":
            s = Scope(scope)
            if st[1] is not None:
                self.exec_stmt(st[1], s)
            while st[2] is None or to_bool(self.eval(st[2], s)):
                try:
                    self.exec_stmt(st[4], s)
                except _BreakSig:
                    break
                except _ContinueSig:
                    pass
                if st[3] is not None:
                    self.eval(st[3], s)
        elif tag == "return":
            raise _ReturnSig(self.eval(st[1], scope) if st[1] is not None else UNDEF)
        elif tag == "throw":
            raise ThrowSig(self.eval(st[1], scope))
        elif tag == "break":
            raise _BreakSig()
        elif tag == "continue":
            raise _ContinueSig()
        elif tag == "try":
            blk, handler, final = st[1], st[2], st[3]
            try:
                self.exec_stmt(blk, scope)
            except ThrowSig as t:
                if handler is not None:
                    s = Scope(scope)
                    if handler[0] is not None:
                        self.bind_pattern(handler[0], t.value, s)
                    self.exec_block(handler[1][1], s)
                elif final is None:
                    raise
            finally:
                if final is not None:
                    self.exec_stmt(final, scope)
        elif tag == "switch":
            disc = self.eval(st[1], scope)
            s = Scope(scope)
            matched = False
            try:
                for test, body in st[2]:
                    if not matched and test is not None and strict_eq(disc, self.eval(test, s)):
                        matched = True
                    if matched:
                        for b in body:
                            self.exec_stmt(b, s)
                if not matched:
                    run = False
                    for test, body in st[2]:
                        if test is None:
                            run = True
                        if run:
                            for b in body:
                                self.exec_stmt(b, s)
            except _BreakSig:
                pass
        elif tag == "empty":
            pass
        else:  # pragma: no cover - parser emits a closed set
            raise AssertionError(f"unknown stmt {tag}")

    def _iterate(self, it, mode: str):
        if mode == "in":
            if isinstance(it, JSObject):
                return list(it.keys())
            if isinstance(it, JSArray):
                return [str(i) for i in range(len(it))]
            return []
        if isinstance(it, (JSArray, list)):
            return list(it)
        if isinstance(it, str):
            return list(it)
        raise ThrowSig(_mk_error("TypeError", f"{to_str(it)} is not iterable"))

    def bind_pattern(self, pat, value, scope: Scope) -> None:
        tag = pat[0]
        if tag == "pid":
            scope.declare(pat[1], value)
        elif tag == "parr":
            seq = list(value) if isinstance(value, (list, str)) else []
            for i, p in enumerate(pat[1]):
                if p is None:  # elision hole
                    continue
                self.bind_pattern(p, seq[i] if i < len(seq) else UNDEF, scope)
        elif tag == "pobj":
            for key, p, default in pat[1]:
                v = value.get(key, UNDEF) if isinstance(value, dict) else UNDEF
                if v is UNDEF and default is not None:
                    v = self.eval(default, scope)
                self.bind_pattern(p, v, scope)

    # ---- expressions

    def eval(self, e, scope: Scope):
        tag = e[0]
        if tag == "num":
            raw = e[1]
            try:
                return int(raw, 0) if not any(c in raw for c in ".eE") or raw.startswith("0x") else float(raw)
            except ValueError:
                return float(raw)
        if tag == "str":
            return e[1]
        if tag == "lit":
            return {"true": True, "false": False, "null": None, "undefined": UNDEF, "this": scope_get_this(scope)}[e[1]]
        if tag == "id":
            return scope.get(e[1])
        if tag == "regex":
            body, _, flags = e[1].rpartition("/")
            return JSRegExp(body[1:], flags)
        if tag == "template":
            exprs, texts = e[1], e[2]
            out = [decode_template_text(texts[0])]
            for i, sub in enumerate(exprs):
                out.append(to_str(self.eval(sub, scope)))
                out.append(decode_template_text(texts[i + 1]))
            return "".join(out)
        if tag == "array":
            return JSArray(self.eval(x, scope) for x in e[1])
        if tag == "object":
            o = JSObject()
            for p in e[1]:
                if p[0] == "prop":
                    o[str(p[1])] = self.eval(p[2], scope)
                elif p[0] == "shorthand":
                    o[p[1]] = scope.get(p[1])
                elif p[0] == "computed":
                    o[to_str(self.eval(p[1], scope))] = self.eval(p[2], scope)
                elif p[0] == "spread":
                    src = self.eval(p[1], scope)
                    if isinstance(src, dict):
                        o.update(src)
                elif p[0] == "method":
                    o[str(p[1])] = JSFunction(self, p[1], p[2], p[3], scope, False)
            return o
        if tag == "arrow":
            return JSFunction(self, None, e[1], _arrow_block(e[2]), scope, e[3])
        if tag == "funcexpr":
            return JSFunction(self, e[1], e[2], e[3], scope, e[4])
        if tag == "seq":
            self.eval(e[1], scope)
            return self.eval(e[2], scope)
        if tag == "cond":
            return self.eval(e[2] if to_bool(self.eval(e[1], scope)) else e[3], scope)
        if tag == "bin":
            return self.eval_bin(e, scope)
        if tag == "unary":
            return self.eval_unary(e, scope)
        if tag == "update":
            return self.eval_update(e, scope)
        if tag == "assign":
            return self.eval_assign(e, scope)
        if tag == "member":
            return self.member_get(self.eval(e[1], scope), e[2])
        if tag == "index":
            obj = self.eval(e[1], scope)
            idx = self.eval(e[2], scope)
            return self.index_get(obj, idx)
        if tag == "call":
            return self.eval_call(e, scope)
        if tag == "new":
            inner = e[1]
            if inner[0] == "call":
                ctor = self.eval(inner[1], scope)
                args = [self.eval(a, scope) for a in inner[2]]
            else:
                ctor = self.eval(inner, scope)
                args = []
            return self.call_any(ctor, args)
        raise AssertionError(f"unknown expr {tag}")  # pragma: no cover

    def eval_call(self, e, scope: Scope):
        callee = e[1]
        args = [self.eval(a, scope) for a in e[2]]
        if callee[0] == "member":
            obj = self.eval(callee[1], scope)
            fn = self.member_get(obj, callee[2])
            return self.call_any(fn, args, this=obj)
        if callee[0] == "index":
            obj = self.eval(callee[1], scope)
            fn = self.index_get(obj, self.eval(callee[2], scope))
            return self.call_any(fn, args, this=obj)
        fn = self.eval(callee, scope)
        return self.call_any(fn, args)

    def eval_bin(self, e, scope: Scope):
        op = e[1]
        if op == "&&":
            left = self.eval(e[2], scope)
            return self.eval(e[3], scope) if to_bool(left) else left
        if op == "||":
            left = self.eval(e[2], scope)
            return left if to_bool(left) else self.eval(e[3], scope)
        a = self.eval(e[2], scope)
        b = self.eval(e[3], scope)
        return self.bin_values(op, a, b)

    def bin_values(self, op: str, a, b):
        if op == "+":
            if isinstance(a, str) or isinstance(b, str) or isinstance(a, (JSArray, JSObject)) or isinstance(b, (JSArray, JSObject)):
                return to_str(a) + to_str(b)
            return to_num(a) + to_num(b)
        if op == "-":
            return to_num(a) - to_num(b)
        if op == "*":
            return to_num(a) * to_num(b)
        if op == "/":
            bn = to_num(b)
            an = to_num(a)
            if bn == 0:
                return float("nan") if an == 0 else math.copysign(float("inf"), an * (1 if bn >= 0 else -1))
            return an / bn
        if op == "%":
            bn = to_num(b)
            return float("nan") if bn == 0 else math.fmod(to_num(a), bn)
        if op == "**":
            return to_num(a) ** to_num(b)
        if op == "===":
            return strict_eq(a, b)
        if op == "!==":
            return not strict_eq(a, b)
        if op == "==":
            return loose_eq(a, b)
        if op == "!=":
            return not loose_eq(a, b)
        if op in ("<", ">", "<=", ">="):
            if isinstance(a, str) and isinstance(b, str):
                pass
            else:
                a, b = to_num(a), to_num(b)
            return {"<": a < b, ">": a > b, "<=": a <= b, ">=": a >= b}[op]
        if op == "&":
            return int(to_num(a)) & int(to_num(b))
        if op == "|":
            return int(to_num(a)) | int(to_num(b))
        if op == "^":
            return int(to_num(a)) ^ int(to_num(b))
        if op == "<<":
            return int(to_num(a)) << int(to_num(b))
        if op in (">>", ">>>"):
            return int(to_num(a)) >> int(to_num(b))
        if op == "instanceof":
            return isinstance(a, JSObject) and a.get("name") in ("Error", "TypeError") if b else False
        if op == "in":
            return to_str(a) in b if isinstance(b, dict) else False
        raise AssertionError(f"unknown binop {op}")  # pragma: no cover

    def eval_unary(self, e, scope: Scope):
        op = e[1]
        if op == "typeof":
            try:
                v = self.eval(e[2], scope)
            except ThrowSig:
                return "undefined"
            if v is UNDEF:
                return "undefined"
            if v is None:
                return "object"
            if isinstance(v, bool):
                return "boolean"
            if isinstance(v, (int, float)):
                return "number"
            if isinstance(v, str):
                return "string"
            if isinstance(v, JSFunction) or callable(v):
                return "function"
            return "object"
        if op == "delete":
            target = e[2]
            if target[0] == "index":
                obj = self.eval(target[1], scope)
                key = to_str(self.eval(target[2], scope))
                if isinstance(obj, dict):
                    obj.pop(key, None)
                return True
            if target[0] == "member":
                obj = self.eval(target[1], scope)
                if isinstance(obj, dict):
                    obj.pop(target[2], None)
                return True
            return True
        v = self.eval(e[2], scope)
        if op == "!":
            return not to_bool(v)
        if op == "-":
            return -to_num(v)
        if op == "+":
            return to_num(v)
        if op == "~":
            return ~int(to_num(v))
        if op == "await":
            return _resolve_thenable(v)
        if op == "void":
            return UNDEF
        raise AssertionError(f"unknown unary {op}")  # pragma: no cover

    def eval_update(self, e, scope: Scope):
        op, target, when = e[1], e[2], e[3]
        old = to_num(self.eval(target, scope))
        new = old + (1 if op == "++" else -1)
        self._store(target, new, scope)
        return new if when == "pre" else old

    def eval_assign(self, e, scope: Scope):
        op, target, value_expr = e[1], e[2], e[3]
        if op == "=":
            v = self.eval(value_expr, scope)
        else:
            cur = self.eval(target, scope)
            rhs = self.eval(value_expr, scope)
            v = self.bin_values(op[:-1], cur, rhs)
        self._store(target, v, scope)
        return v

    def _store(self, target, v, scope: Scope) -> None:
        tag = target[0]
        if tag == "id":
            scope.set(target[1], v)
        elif tag == "member":
            obj = self.eval(target[1], scope)
            self.member_set(obj, target[2], v)
        elif tag == "index":
            obj = self.eval(target[1], scope)
            idx = self.eval(target[2], scope)
            self.index_set(obj, idx, v)
        else:
            raise ThrowSig(_mk_error("SyntaxError", "invalid assignment target"))

    # ---- member protocol

    def member_get(self, obj, name: str):
        if obj is UNDEF or obj is None:
            raise ThrowSig(_mk_error("TypeError", f"cannot read properties of {to_str(obj)} (reading '{name}')"))
        if isinstance(obj, JSObject):
            if name in obj:
                return obj[name]
            return UNDEF
        if isinstance(obj, str):
            return _string_member(self, obj, name)
        if isinstance(obj, JSArray):
            return _array_member(self, obj, name)
        if isinstance(obj, JSRegExp):
            return {"source": obj.source, "flags": obj.flags, "test": _native(lambda s, *a: obj.compiled.search(to_str(s)) is not None)}.get(name, UNDEF)
        if isinstance(obj, (int, float)):
            if name == "toFixed":
                return _native(lambda d=0, *a: f"{float(obj):.{int(to_num(d))}f}")
            return UNDEF
        # host object: plain attribute access (stub DOM etc.)
        v = getattr(obj, name, UNDEF)
        return v

    def member_set(self, obj, name: str, v) -> None:
        if isinstance(obj, JSObject):
            obj[name] = v
            return
        if isinstance(obj, JSArray):
            if name == "length":
                del obj[int(to_num(v)) :]
            # non-length named sets on arrays: intentionally dropped (the
            # UI never does this; index_set handles numeric elements)
            return
        if obj is UNDEF or obj is None or isinstance(obj, (str, int, float)):
            raise ThrowSig(_mk_error("TypeError", f"cannot set property {name} on {to_str(obj)}"))
        setattr(obj, name, v)

    def index_get(self, obj, idx):
        if isinstance(obj, (JSArray,)) or (isinstance(obj, list) and not isinstance(obj, JSArray)):
            i = idx
            if isinstance(i, (int, float)) and not isinstance(i, bool):
                i = int(i)
                return obj[i] if 0 <= i < len(obj) else UNDEF
            return self.member_get(obj, to_str(idx))
        if isinstance(obj, str):
            if isinstance(idx, (int, float)) and not isinstance(idx, bool):
                i = int(idx)
                return obj[i] if 0 <= i < len(obj) else UNDEF
            return self.member_get(obj, to_str(idx))
        if isinstance(obj, JSObject):
            return obj.get(to_str(idx), UNDEF)
        return self.member_get(obj, to_str(idx))

    def index_set(self, obj, idx, v) -> None:
        if isinstance(obj, JSArray) and isinstance(idx, (int, float)) and not isinstance(idx, bool):
            i = int(idx)
            while len(obj) <= i:
                obj.append(UNDEF)
            obj[i] = v
            return
        if isinstance(obj, JSObject):
            obj[to_str(idx)] = v
            return
        self.member_set(obj, to_str(idx), v)


def scope_get_this(scope: Scope):
    s = scope
    while s is not None:
        if "this" in s.vars:
            return s.vars["this"]
        s = s.parent
    return UNDEF


def _arrow_block(body):
    """Arrow bodies parse as ('block', ...) or ('return', expr); normalize
    to a block so JSFunction.body is uniform."""
    if body[0] == "block":
        return body
    return ("block", [body])


def _resolve_thenable(v):
    if isinstance(v, JSPromise):
        if not v.resolved:
            raise PendingAwait()
        return v.value
    return v  # non-promise awaits pass through


# --------------------------------------------------------------------------
# standard library


def _std_globals(interp: Interp) -> dict:
    def object_ns():
        o = JSObject()
        o["fromEntries"] = _native(lambda pairs, *a: JSObject({to_str(p[0]): p[1] for p in pairs}))
        o["entries"] = _native(lambda obj, *a: JSArray(JSArray([k, v]) for k, v in obj.items()) if isinstance(obj, dict) else JSArray())
        o["values"] = _native(lambda obj, *a: JSArray(obj.values()) if isinstance(obj, dict) else JSArray())
        o["keys"] = _native(lambda obj, *a: JSArray(obj.keys()) if isinstance(obj, dict) else JSArray())
        def assign(target, *sources):
            for s in sources:
                if isinstance(s, dict):
                    target.update(s)
            return target
        o["assign"] = _native(assign)
        return o

    def json_ns():
        o = JSObject()
        def stringify(v, _replacer=None, indent=None, *a):
            py = py_from_js(v)
            if indent is not None and indent is not UNDEF:
                return json.dumps(py, indent=int(to_num(indent)), ensure_ascii=False)
            return json.dumps(py, separators=(",", ":"), ensure_ascii=False)
        o["stringify"] = _native(stringify)
        def parse(s, *a):
            try:
                return js_from_py(json.loads(to_str(s)))
            except (json.JSONDecodeError, TypeError) as exc:
                raise ThrowSig(_mk_error("SyntaxError", f"JSON.parse: {exc}"))
        o["parse"] = _native(parse)
        return o

    def math_ns():
        o = JSObject()
        o["min"] = _native(lambda *a: min(to_num(x) for x in a) if a else float("inf"))
        o["max"] = _native(lambda *a: max(to_num(x) for x in a) if a else float("-inf"))
        o["round"] = _native(lambda x=0, *a: math.floor(to_num(x) + 0.5))
        o["floor"] = _native(lambda x=0, *a: math.floor(to_num(x)))
        o["ceil"] = _native(lambda x=0, *a: math.ceil(to_num(x)))
        o["abs"] = _native(lambda x=0, *a: abs(to_num(x)))
        return o

    def array_ns():
        o = JSObject()
        o["isArray"] = _native(lambda v=UNDEF, *a: isinstance(v, JSArray))
        o["from"] = _native(lambda v=UNDEF, *a: JSArray(v) if isinstance(v, (list, str)) else JSArray())
        return o

    def error_ctor(kind):
        def ctor(message=UNDEF, *a):
            return _mk_error(kind, to_str(message) if message is not UNDEF else "")
        return _native(ctor)

    return {
        "undefined": UNDEF,
        "NaN": float("nan"),
        "Infinity": float("inf"),
        "Object": object_ns(),
        "JSON": json_ns(),
        "Math": math_ns(),
        "Array": array_ns(),
        "String": _native(lambda v="", *a: to_str(v)),
        "Number": _native(lambda v=0, *a: to_num(v)),
        "Boolean": _native(lambda v=False, *a: to_bool(v)),
        "parseFloat": _native(lambda v="", *a: _parse_float(to_str(v))),
        "parseInt": _native(lambda v="", base=10, *a: _parse_int(to_str(v), int(to_num(base)) or 10)),
        "isNaN": _native(lambda v=UNDEF, *a: to_num(v) != to_num(v)),
        "isFinite": _native(lambda v=UNDEF, *a: math.isfinite(to_num(v)) if to_num(v) == to_num(v) else False),
        "Error": error_ctor("Error"),
        "TypeError": error_ctor("TypeError"),
        "Promise": _promise_ctor(interp),
        "encodeURIComponent": _native(lambda v="", *a: __import__("urllib.parse", fromlist=["quote"]).quote(to_str(v), safe="")),
        "decodeURIComponent": _native(lambda v="", *a: __import__("urllib.parse", fromlist=["unquote"]).unquote(to_str(v))),
        "console": JSObject(
            log=_native(lambda *a: UNDEF),
            error=_native(lambda *a: UNDEF),
            warn=_native(lambda *a: UNDEF),
        ),
    }


def _promise_ctor(interp: Interp):
    def ctor(executor=None, *a):
        p = JSPromise()
        if executor is not None and executor is not UNDEF:
            interp.call_any(executor, [_native(lambda v=UNDEF, *aa: p.resolve(v)), _native(lambda *aa: UNDEF)])
        return p
    return _native(ctor)


def _parse_float(s: str):
    m = re.match(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+)", s)
    return float(m.group(0)) if m else float("nan")


def _parse_int(s: str, base: int = 10):
    m = re.match(r"\s*[+-]?\d+", s)
    return int(m.group(0), base) if m else float("nan")
