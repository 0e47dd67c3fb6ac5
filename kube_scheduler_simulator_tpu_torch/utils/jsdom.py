"""Minimal DOM + browser-host stub for executing the web UI's JS in tests.

Pairs with ``utils.jseval``: the harness supplies ``document``, ``fetch``
(a router over canned responses or a live callable), timers, dialogs, and
the streaming-read surface the UI's watch loop uses.  Element semantics
are sized to what the UI touches: ``innerHTML`` is stored as an opaque
string (setting it clears children), children appended via
``appendChild`` are tracked as objects, and ``collect_text`` flattens
both for assertions.
"""

from __future__ import annotations

import json as _json
import re
from typing import Any, Callable

from kube_scheduler_simulator_tpu_torch.utils.jseval import (
    UNDEF,
    Interp,
    JSArray,
    JSObject,
    PendingAwait,
    _native,
    to_str,
)


class Element:
    def __init__(self, doc: "Document", tag: str, id: str = ""):
        self.tagName = tag.upper()
        self.id = id
        self.className = ""
        self.textContent = ""
        self.value = ""
        self.style = JSObject()
        self.dataset = JSObject()
        self.children = JSArray()
        self.open = False  # <dialog>
        self._innerHTML = ""
        self._listeners: dict[str, list] = {}
        self._doc = doc
        # assignable slots the UI uses (onclick etc. set via member_set)
        self.onclick = None
        self.oninput = None
        self.onchange = None
        self.href = ""
        self.download = ""

    # -- innerHTML: opaque string; setting clears children (enough for the
    # UI's "clear container then appendChild" pattern)
    @property
    def innerHTML(self):
        return self._innerHTML

    @innerHTML.setter
    def innerHTML(self, v):
        self._innerHTML = to_str(v)
        self.children = JSArray()

    @property
    def appendChild(self):
        def _append(child, *a):
            self.children.append(child)
            return child
        return _native(_append)

    @property
    def addEventListener(self):
        def _add(type_, fn, *a):
            self._listeners.setdefault(to_str(type_), []).append(fn)
            return UNDEF
        return _native(_add)

    @property
    def click(self):
        def _click(*a):
            if self.onclick is not None and self.onclick is not UNDEF:
                self.onclick()
            for fn in self._listeners.get("click", []):
                fn()
            return UNDEF
        return _native(_click)

    @property
    def showModal(self):
        def _show(*a):
            self.open = True
            return UNDEF
        return _native(_show)

    @property
    def close(self):
        def _close(*a):
            self.open = False
            return UNDEF
        return _native(_close)


def collect_text(el: Element) -> str:
    """All human-visible text reachable from ``el``: textContent,
    innerHTML markup, and recursively every appended child."""
    parts = [to_str(el.textContent), to_str(el._innerHTML), to_str(el.value)]
    for c in el.children:
        if isinstance(c, Element):
            parts.append(collect_text(c))
    return " ".join(p for p in parts if p)


class Document:
    def __init__(self):
        self._by_id: dict[str, Element] = {}

    def register(self, id: str, tag: str = "div") -> Element:
        el = Element(self, tag, id)
        self._by_id[id] = el
        return el

    @property
    def getElementById(self):
        return _native(lambda id, *a: self._by_id.get(to_str(id)))

    @property
    def createElement(self):
        return _native(lambda tag, *a: Element(self, to_str(tag)))

    @classmethod
    def from_html(cls, html: str) -> "Document":
        """Build the id registry from the real served page (every
        ``id="..."`` becomes a stub element of the right tag)."""
        doc = cls()
        for m in re.finditer(r"<(\w+)[^>]*\bid=\"([\w$-]+)\"", html):
            doc.register(m.group(2), m.group(1))
        return doc


class FakeReader:
    """Streaming-body reader: hands out pre-seeded chunks then done."""

    def __init__(self, chunks: "list[str]"):
        self._chunks = list(chunks)

    @property
    def read(self):
        def _read(*a):
            if self._chunks:
                return JSObject(done=False, value=self._chunks.pop(0))
            return JSObject(done=True, value=UNDEF)
        return _native(_read)


class Harness:
    """Browser host for the UI script.

    - ``routes``: {(method, path): payload} — dict/list payloads are
      JSON responses; str payloads raw text.  A callable payload receives
      (method, path, body) and returns the payload.
    - ``watch_chunks``: newline-delimited event lines served as the
      streaming body of /api/v1/listwatchresources.
    - ``requests``: every fetch the script made, for assertions.
    - ``timers``: queued setTimeout callbacks; ``flush_timers()`` runs
      them (debounce etc.).
    """

    def __init__(self, html: str):
        self.document = Document.from_html(html)
        self.routes: dict[tuple[str, str], Any] = {}
        self.requests: list[tuple[str, str, Any]] = []
        self.watch_chunks: list[str] = []
        self.timers: list[tuple[int, Any]] = []
        self.confirm_response = True
        self._timer_seq = 0

    # ---- host surface

    def fetch(self, path, opts=UNDEF, *a):
        method = "GET"
        body = None
        if isinstance(opts, dict):
            method = to_str(opts.get("method", "GET")) or "GET"
            b = opts.get("body", UNDEF)
            if b is not UNDEF and b is not None:
                body = to_str(b)
        path = to_str(path)
        self.requests.append((method, path, body))
        if path.startswith("/api/v1/listwatchresources"):
            return self._stream_response()
        payload = self.routes.get((method, path))
        if callable(payload):
            payload = payload(method, path, body)
        if payload is None:
            return self._response(404, _json.dumps({"message": f"no route {method} {path}"}), "application/json")
        if isinstance(payload, tuple):  # (status, text) for error-path tests
            status, text = payload
            return self._response(status, text, "text/plain")
        if isinstance(payload, str):
            return self._response(200, payload, "text/plain")
        return self._response(200, _json.dumps(payload), "application/json")

    def _response(self, status: int, text: str, ctype: str):
        return JSObject(
            ok=200 <= status < 300,
            status=status,
            headers=JSObject(get=_native(lambda k, *a: ctype if to_str(k).lower() == "content-type" else None)),
            text=_native(lambda *a: text),
            body=None,
        )

    def _stream_response(self):
        reader = FakeReader(self.watch_chunks)
        return JSObject(
            ok=True,
            status=200,
            headers=JSObject(get=_native(lambda k, *a: "application/json")),
            text=_native(lambda *a: ""),
            body=JSObject(getReader=_native(lambda *a: reader)),
        )

    def set_timeout(self, fn, _ms=0, *a):
        self._timer_seq += 1
        self.timers.append((self._timer_seq, fn))
        return self._timer_seq

    def clear_timeout(self, tid=UNDEF, *a):
        self.timers = [(i, f) for i, f in self.timers if i != tid]
        return UNDEF

    def flush_timers(self) -> int:
        """Run every queued timer callback (new ones queued while running
        are NOT run — matching one macrotask turn)."""
        pending, self.timers = self.timers, []
        for _i, fn in pending:
            try:
                fn() if callable(fn) else fn.interp.call(fn, [])
            except PendingAwait:
                pass
        return len(pending)

    # ---- wiring

    def globals(self) -> dict:
        def text_decoder_ctor(*a):
            return JSObject(decode=_native(lambda v=UNDEF, *aa: "" if v is UNDEF else to_str(v)))

        return {
            "document": self.document,
            "fetch": _native(self.fetch),
            "setTimeout": _native(self.set_timeout),
            "clearTimeout": _native(self.clear_timeout),
            "confirm": _native(lambda *a: self.confirm_response),
            "alert": _native(lambda *a: UNDEF),
            "prompt": _native(lambda *a: None),
            "TextDecoder": _native(text_decoder_ctor),
            "URL": JSObject(createObjectURL=_native(lambda *a: "blob:stub")),
            "Blob": _native(lambda *a: JSObject()),
            "location": JSObject(href="http://localhost:1212/", reload=_native(lambda *a: UNDEF)),
            "window": JSObject(),
            "EventSource": _native(lambda *a: JSObject(close=_native(lambda *aa: UNDEF))),
        }

    def boot(self, js_src: str) -> Interp:
        """Run the UI script top-to-bottom; the bootstrap's idle sleep
        (pending promise) ends execution cleanly."""
        interp = Interp(self.globals())
        try:
            interp.run(js_src)
        except PendingAwait:
            pass
        return interp
