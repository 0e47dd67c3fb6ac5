// ---- node detail: capacity vs requested, with usage bars ----------------

function parseCpu(v) {
  if (v === undefined || v === null || v === "") return 0;
  v = String(v);
  return v.endsWith("m") ? parseFloat(v) / 1000 : parseFloat(v);
}
function parseMem(v) {
  if (!v) return 0;
  // kube resource.Quantity suffixes: binary Ki..Ei, decimal k/M/G/T/P/E,
  // and milli (m)
  const m = String(v).match(/^([0-9.]+)(Ki|Mi|Gi|Ti|Pi|Ei|k|M|G|T|P|E|m)?$/);
  if (!m) return parseFloat(v) || 0;
  const mult = {Ki: 2**10, Mi: 2**20, Gi: 2**30, Ti: 2**40, Pi: 2**50, Ei: 2**60,
                k: 1e3, M: 1e6, G: 1e9, T: 1e12, P: 1e15, E: 1e18, m: 1e-3}[m[2]] || 1;
  return parseFloat(m[1]) * mult;
}
function bar(frac, label) {
  const pct = Math.min(100, Math.round(frac * 100));
  const color = pct > 90 ? "#d93025" : pct > 70 ? "#f9ab00" : "#1e8e3e";
  return `<div style="margin:4px 0"><span class="muted">${esc(label)} — ${pct}%</span>
    <div style="background:#eee;border-radius:4px;height:10px"><div style="width:${pct}%;background:${color};height:10px;border-radius:4px"></div></div></div>`;
}

function nodeCpuUtil(node, podsOnNode) {
  // requested cpu over allocatable, for the cluster view's badges and
  // the node dialog's bars
  const cap = parseCpu((((node.status||{}).allocatable)||{}).cpu);
  if (!cap) return 0;
  let req = 0;
  for (const p of podsOnNode) {
    for (const c of (p.spec||{}).containers || []) {
      req += parseCpu((((c.resources||{}).requests)||{}).cpu);
    }
  }
  return req / cap;
}
