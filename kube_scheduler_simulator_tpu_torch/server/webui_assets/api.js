async function api(method, path, body, ctype) {
  // JSON round-trip by default; string bodies pass through raw (the YAML
  // create/edit paths set ctype="application/yaml"), and non-JSON
  // responses (?format=yaml, templates) come back as text
  const raw = typeof body === "string";
  const r = await fetch(path, {method, headers:{"Content-Type": ctype || "application/json"},
                               body: body===undefined? undefined : (raw? body : JSON.stringify(body))});
  const text = await r.text();
  if (!r.ok) throw new Error(text || r.status);
  if (!text) return null;
  return (r.headers.get("Content-Type")||"").includes("json") ? JSON.parse(text) : text;
}

function esc(s){ return String(s).replace(/&/g,"&amp;").replace(/</g,"&lt;"); }

async function refreshAll() {
  for (const k of KINDS) {
    const lst = await api("GET", `/api/v1/resources/${k}`);
    state[k] = {};
    for (const o of lst.items) state[k][key(o)] = o;
  }
  render();
}
