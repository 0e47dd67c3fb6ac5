// Autoscaler panel: node-group table + recent action feed, fed by
// GET /api/v1/autoscaler (autoscaler/engine.py status()).  Rendered into
// the #autoscaler section of the right-hand panel; polled alongside the
// workload kinds (the watch stream doesn't carry autoscaler state).
let autoscalerStatus = null;

async function refreshAutoscaler() {
  try {
    autoscalerStatus = await api("GET", "/api/v1/autoscaler");
  } catch (e) { autoscalerStatus = null; }
  renderAutoscaler();
}

function renderAutoscaler() {
  const root = document.getElementById("autoscaler");
  if (!root) return;
  const st = autoscalerStatus;
  if (!st || st.mode === "off" || st.mode === undefined) {
    root.innerHTML = '<span class="muted">autoscaler off (AUTOSCALE_MODE=on|scenario enables it)</span>';
    return;
  }
  let html = `<div class="muted">mode ${esc(st.mode)} · expander ${esc(st.expander || "")} · ` +
             `scale-ups ${(st.stats||{}).scale_ups||0} · scale-downs ${(st.stats||{}).scale_downs||0} · ` +
             `est ${(st.estimator||{}).dispatches||0} dispatches</div>`;
  const groups = st.groups || [];
  if (groups.length) {
    html += '<table class="kv"><tr><td><b>group</b></td><td><b>size</b></td><td><b>bounds</b></td><td><b>nodes</b></td></tr>';
    for (const g of groups) {
      html += `<tr><td>${esc(g.name)}</td><td>${g.currentSize}</td>` +
              `<td>[${g.minSize}, ${g.maxSize}]</td>` +
              `<td class="muted">${(g.nodes||[]).map(esc).join(", ")}</td></tr>`;
    }
    html += "</table>";
  } else {
    html += '<div class="muted">no node groups (create one via /api/v1/nodegroups)</div>';
  }
  const events = (st.events || []).slice(-8).reverse();
  if (events.length) {
    html += '<div style="margin-top:6px"><b>recent actions</b></div>';
    for (const ev of events) {
      const what = ev.action === "ScaleUp"
        ? `+${(ev.nodes||[]).length} node(s) → ${esc(ev.nodeGroup)} (${ev.podsFit} pods fit, ${esc(ev.method||"")})`
        : `-${(ev.nodes||[]).length} node(s) ← ${esc(ev.nodeGroup)} (util ${ev.utilization})`;
      html += `<div class="kindrow">${ev.action === "ScaleUp" ? "▲" : "▼"} ${what}</div>`;
    }
  }
  root.innerHTML = html;
}
