"""KSS-LOCK: attributes written under a class's lock stay under it.

The motivating bug: EncodeCache's fingerprint tables are
read-modify-write state — the streaming pipeline diffing off the commit
thread interleaved with a sequential encode and double-applied bound
deltas until the aggregates corrupted.  The fix serialized ``encode()``
under an RLock, and a satellite added the copy-on-write
``stats_snapshot`` read so the metrics scrape never queues behind a
cold encode.  Both halves of that fix are a CONTRACT: state written
under the lock is lock-guarded state, and any access outside the lock
is either a bug or a deliberate lock-free pattern that must say so.

Mechanized per class (any class that takes a ``*lock*``-named lock in a
``with`` statement — its own ``self._lock`` or a collaborator's
``self.svc._stats_lock``):

1. **Guarded paths** — dotted attribute paths written (attribute
   assignment, augmented assignment, or subscript store — mutating
   ``self.stats[k]`` guards ``self.stats``) inside a ``with <lock>:``
   block, or inside a method transitively called from one (the
   ``encode() → _encode_locked → _apply_bound_delta`` pattern).  Local
   aliases are canonicalized (``svc = self.svc; svc.stats[...]`` is an
   access of ``self.svc.stats``).
2. **Violations** — loads or stores of a guarded path outside the
   lock's scope, in any method but ``__init__``/``__new__``
   (construction precedes sharing).  A violation is cleared by a
   ``# lock-free:`` justification comment on the access line or
   anywhere in the enclosing method — the comment IS the contract's
   escape hatch, and it must say why (GIL-atomic single-writer bump,
   copy-on-write publish, ...).
"""

from __future__ import annotations

import ast

from kube_scheduler_simulator_tpu_torch.analysis.framework import Finding, Project, Rule, SourceFile

_MARKER = "lock-free:"


def _dotted(node: ast.AST) -> "str | None":
    """Attribute/Name chains → 'self.svc.stats'; anything else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_lockish(path: "str | None") -> bool:
    return path is not None and "lock" in path.rsplit(".", 1)[-1].lower() and "." in path


class _MethodInfo:
    def __init__(self, node: ast.FunctionDef):
        self.node = node
        self.aliases: dict[str, str] = {}  # local name → canonical dotted path
        self.locked_spans: list[tuple[int, int, str]] = []  # (lo, hi, lock path)
        self.locks_taken: set[str] = set()
        # (lock path, self-method name) pairs: the callee is invoked
        # under exactly THAT lock — a flat callee set would cross-product
        # every callee with every lock the method takes anywhere
        self.calls_under_lock: set[tuple[str, str]] = set()
        self.calls_anywhere: set[str] = set()


class LockRule(Rule):
    name = "KSS-LOCK"
    paths = None

    # ---------------------------------------------------------- per class

    def _canon(self, info: _MethodInfo, path: str) -> str:
        head, _, rest = path.partition(".")
        base = info.aliases.get(head)
        if base is not None:
            return base + ("." + rest if rest else "")
        return path

    def _scan_method(self, m: ast.FunctionDef) -> _MethodInfo:
        info = _MethodInfo(m)
        for node in ast.walk(m):
            # alias tracking: name = <dotted path rooted at self/cls>,
            # subscripts stripped — ``d = self.svc.stats["k"]`` makes a
            # mutation of ``d`` a mutation of state under self.svc.stats
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                rhs_node = node.value
                while isinstance(rhs_node, ast.Subscript):
                    rhs_node = rhs_node.value
                rhs = _dotted(rhs_node)
                if rhs is not None and rhs.split(".", 1)[0] in ("self", "cls"):
                    info.aliases[node.targets[0].id] = rhs
            if isinstance(node, ast.With):
                for item in node.items:
                    path = _dotted(item.context_expr)
                    path = self._canon(info, path) if path else None
                    if _is_lockish(path):
                        info.locked_spans.append(
                            (node.lineno, node.end_lineno or node.lineno, path)
                        )
                        info.locks_taken.add(path)
                        for sub in ast.walk(node):
                            if isinstance(sub, ast.Call):
                                cp = _dotted(sub.func)
                                if cp is not None and cp.startswith("self."):
                                    info.calls_under_lock.add((path, cp.split(".", 1)[1]))
            if isinstance(node, ast.Call):
                cp = _dotted(node.func)
                if cp is not None and cp.startswith("self."):
                    info.calls_anywhere.add(cp.split(".", 1)[1])
        return info

    @staticmethod
    def _write_targets(node: ast.AST) -> "list[ast.AST]":
        if isinstance(node, ast.Assign):
            return node.targets
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            return [node.target]
        return []

    def _accessed_paths(self, info: _MethodInfo, node: ast.AST, store: bool):
        """Canonical self-rooted paths this node reads (store=False) or
        writes (store=True).  A subscript store on ``x.stats[k]`` is a
        write of ``x.stats``."""
        out: list[tuple[str, ast.AST]] = []

        def emit(e: ast.AST):
            target = e
            while isinstance(target, ast.Subscript):
                target = target.value
            path = _dotted(target)
            if path is None:
                return
            path = self._canon(info, path)
            if path.split(".", 1)[0] in ("self", "cls") and "." in path:
                out.append((path, e))

        if store:
            for t in self._write_targets(node):
                if isinstance(t, ast.Name):
                    # rebinding a LOCAL name (even an alias of guarded
                    # state) writes the binding, not the object
                    continue
                emit(t)
        else:
            if isinstance(node, (ast.Attribute, ast.Subscript)) and isinstance(
                getattr(node, "ctx", None), ast.Load
            ):
                emit(node)
        return out

    def check_file(self, src: SourceFile, ctx: Project) -> "list[Finding]":
        out: list[Finding] = []
        for cls in ast.walk(src.tree):
            if isinstance(cls, ast.ClassDef):
                out.extend(self._check_class(src, cls))
        return out

    def _check_class(self, src: SourceFile, cls: ast.ClassDef) -> "list[Finding]":
        methods = [
            n for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        infos = {m.name: self._scan_method(m) for m in methods}
        if not any(i.locks_taken for i in infos.values()):
            return []

        # transitive closure: methods called (by self.name) from under a
        # lock run lock-held for that lock.  NOTE: lexically taking a lock
        # in a with-block covers only that span (locked_spans), it does
        # NOT make the whole method lock-held — `held` carries call-chain
        # propagation only.
        held: dict[str, set[str]] = {}
        # seed: direct calls under a with-lock — (lock, callee) pairs, so
        # a helper called under lock B is never marked held under lock A
        work: list[tuple[str, str]] = []
        for name, i in infos.items():
            for lock, callee in i.calls_under_lock:
                if callee in infos:
                    work.append((callee, lock))
        while work:
            callee, lock = work.pop()
            if lock in held.get(callee, set()):
                continue
            held.setdefault(callee, set()).add(lock)
            # everything the callee calls anywhere now also runs under it
            for sub in infos[callee].calls_anywhere:
                if sub in infos:
                    work.append((sub, lock))

        # guarded paths: writes under a lock (lexically in a span, or in a
        # lock-held method), keyed by lock path
        guarded: dict[str, set[str]] = {}

        def record_writes(name: str, i: _MethodInfo):
            for node in ast.walk(i.node):
                for path, _e in self._accessed_paths(i, node, store=True):
                    locks = self._locks_at(i, node.lineno) | held.get(name, set())
                    for lk in locks:
                        if path != lk:
                            guarded.setdefault(lk, set()).add(path)

        for name, i in infos.items():
            if name in ("__init__", "__new__"):
                continue
            record_writes(name, i)
        if not guarded:
            return []

        out: list[Finding] = []
        comments = src.comments()
        for name, i in infos.items():
            if name in ("__init__", "__new__"):
                continue
            method_justified = any(
                _MARKER in c
                for ln, c in comments.items()
                if i.node.lineno <= ln <= (i.node.end_lineno or i.node.lineno)
            )
            if method_justified:
                continue
            for node in ast.walk(i.node):
                accesses = self._accessed_paths(i, node, store=True) + self._accessed_paths(
                    i, node, store=False
                )
                for path, e in accesses:
                    for lock, paths in guarded.items():
                        if path not in paths:
                            continue
                        if lock in self._locks_at(i, e.lineno) or lock in held.get(name, set()):
                            continue
                        out.append(
                            src.finding(
                                self.name,
                                e,
                                f"'{path}' is written under {lock} elsewhere in "
                                f"{cls.name} but accessed here without it: either "
                                "take the lock, or mark the deliberate lock-free "
                                "pattern with a '# lock-free: <why>' comment "
                                "(GIL-atomic single-writer bump, copy-on-write "
                                "publish, ...).",
                            )
                        )
                        break
        # one finding per line: collapse duplicates from nested walks
        seen: set[tuple[int, str]] = set()
        uniq: list[Finding] = []
        for f in sorted(out, key=lambda f: (f.line, f.message)):
            if (f.line, f.message) not in seen:
                seen.add((f.line, f.message))
                uniq.append(f)
        return uniq

    @staticmethod
    def _locks_at(info: _MethodInfo, lineno: int) -> "set[str]":
        return {lock for lo, hi, lock in info.locked_spans if lo <= lineno <= hi}
