// Tuning panel: the learned scoring head (tuning/).  Shows the active
// plugin-weight override, runs the tuner against a scenario family
// (POST /api/v1/tuning), and renders the default-vs-tuned comparison
// table from the last report (GET /api/v1/tuning).  Rendered into the
// #tuning section of the right-hand panel; refreshed with the workload
// poll (tuning state isn't on the watch stream).
let tuningState = null;
let tuningBusy = false;

async function refreshTuning() {
  if (tuningBusy) return; // a run is in flight; keep its spinner
  try {
    tuningState = await api("GET", "/api/v1/tuning");
  } catch (e) { tuningState = null; }
  renderTuning();
}

async function runTuning() {
  const family = document.getElementById("tunefamily").value;
  const tuner = document.getElementById("tunetuner").value;
  tuningBusy = true;
  renderTuning();
  try {
    const rep = await api("POST", "/api/v1/tuning", { families: [family], tuner });
    tuningState = Object.assign(tuningState || {}, { lastReport: rep });
  } catch (e) {
    tuningState = Object.assign(tuningState || {}, { lastError: String(e) });
  }
  tuningBusy = false;
  renderTuning();
}

function tuningRow(r) {
  // one family's default-vs-tuned comparison: per-plugin weights side by
  // side, then the objective values (higher = better for every objective)
  const plugins = r.scorePlugins || [];
  let html = `<div class="muted">${esc(r.family)} · ${esc(r.objective)} · ${esc(r.tuner)} · ` +
             `${r.nodes}n/${r.pods}p · ${r.rollouts} rollouts, ${r.dispatches} dispatches` +
             (r.gradDispatches ? ` (${r.gradDispatches} grad)` : "") + `</div>`;
  html += '<table class="kv"><tr><td><b>plugin</b></td><td><b>default</b></td><td><b>tuned</b></td></tr>';
  for (let i = 0; i < plugins.length; i++) {
    html += `<tr><td>${esc(plugins[i])}</td><td>${(+r.defaultWeights[i]).toFixed(2)}</td>` +
            `<td>${(+r.weights[i]).toFixed(2)}</td></tr>`;
  }
  const better = r.improvement > 0;
  html += `<tr><td><b>objective</b></td><td>${(+r.defaultObjective).toFixed(4)}</td>` +
          `<td><b>${(+r.tunedObjective).toFixed(4)}</b>` +
          ` <span class="muted">(${better ? "+" : ""}${(+r.improvement).toFixed(4)})</span></td></tr>`;
  html += "</table>";
  return html;
}

function renderTuning() {
  const root = document.getElementById("tuning");
  if (!root) return;
  const st = tuningState;
  if (!st) { root.innerHTML = '<span class="muted">…</span>'; return; }
  const families = st.families || [];
  const fam = document.getElementById("tunefamily");
  const keepF = fam && fam.value;
  const keepT = document.getElementById("tunetuner") && document.getElementById("tunetuner").value;
  let html = '<div class="kindrow">' +
    `<select id="tunefamily">${families.map(f => `<option${f === keepF ? " selected" : ""}>${esc(f)}</option>`).join("")}</select> ` +
    `<select id="tunetuner"><option${keepT === "cem" || !keepT ? " selected" : ""}>cem</option><option${keepT === "grad" ? " selected" : ""}>grad</option></select> ` +
    `<button onclick="runTuning()"${tuningBusy ? " disabled" : ""}>${tuningBusy ? "tuning…" : "Tune"}</button></div>`;
  if (st.pluginWeights) {
    const w = Object.entries(st.pluginWeights).map(([k, v]) => `${esc(k)}=${(+v).toFixed(2)}`).join(" · ");
    html += `<div class="kindrow"><b>override active:</b> <span class="muted">${w}</span></div>`;
  } else {
    html += '<div class="muted">profile default weights active</div>';
  }
  if (st.lastError) html += `<div class="errmsg">${esc(st.lastError)}</div>`;
  const rep = st.lastReport;
  if (rep && rep.results) {
    for (const r of rep.results) html += tuningRow(r);
  } else if (rep && rep.family) {
    html += tuningRow(rep);
  }
  root.innerHTML = html;
}
