// Session picker (the multi-tenant session plane, docs/multitenancy.md).
// Every API call in the UI — including the listwatch stream in watch.js —
// goes through window.fetch, so one wrapper routes the WHOLE page at a
// named session by injecting the X-KSS-Session header.  The "default"
// session sends no header at all: a vanilla single-tenant server serves
// the UI byte-for-byte unchanged.
let currentSession = "default";
let _watchAbort = null; // aborting forces watchLoop's retry → new session

// The in-repo DOM stub (utils/jsdom.py) exposes fetch as a bare global
// with an empty window, so the wrapper installs only where window.fetch
// exists (every real browser); under the stub _origFetch falls through
// to the global and the page behaves exactly as before this module.
const _rawFetch = window.fetch || null;
function _origFetch(input, init) {
  return _rawFetch ? _rawFetch.call(window, input, init) : fetch(input, init);
}
if (_rawFetch) window.fetch = (input, init) => {
  const url = typeof input === "string" ? input : input.url;
  // Only simulator/kube API paths are session-scoped; assets and the
  // sessions CRUD itself stay global.
  if (url.startsWith("/api/") && !url.startsWith("/api/v1/sessions")) {
    if (currentSession !== "default") {
      init = init || {};
      init.headers = Object.assign({}, init.headers, {"X-KSS-Session": currentSession});
    }
    if (url.startsWith("/api/v1/listwatchresources")) {
      _watchAbort = new AbortController();
      init = Object.assign({}, init, {signal: _watchAbort.signal});
    }
  }
  return _origFetch(input, init);
};

async function refreshSessions() {
  const sel = document.getElementById("sessionsel");
  if (!sel) return;
  let items = [];
  try {
    const r = await _origFetch("/api/v1/sessions");
    if (r.status === 404) { sel.style.display = "none"; return; } // replica / no session plane
    items = (await r.json()).items || [];
  } catch (e) { return; }
  const names = ["default"].concat(items.map(s => s.id));
  if (!names.includes(currentSession)) currentSession = "default";
  sel.innerHTML = names.map(n =>
    `<option value="${esc(n)}"${n === currentSession ? " selected" : ""}>${esc(n)}</option>`
  ).join("") + `<option value="__new__">+ new session…</option>`;
}

async function onSessionPick() {
  const sel = document.getElementById("sessionsel");
  let next = sel.value;
  if (next === "__new__") {
    const id = prompt("session id (lowercase, digits, dashes):", "");
    if (!id) { sel.value = currentSession; return; }
    try {
      const r = await _origFetch("/api/v1/sessions", {
        method: "POST", headers: {"Content-Type": "application/json"},
        body: JSON.stringify({id}),
      });
      if (!r.ok) { alert(await r.text()); sel.value = currentSession; return; }
      next = id;
    } catch (e) { alert(e); sel.value = currentSession; return; }
  }
  currentSession = next;
  await refreshSessions();
  // Re-read everything through the new session's store, and kick the
  // open listwatch stream so its retry reconnects with the new header.
  if (_watchAbort) _watchAbort.abort();
  await refreshAll();
}
