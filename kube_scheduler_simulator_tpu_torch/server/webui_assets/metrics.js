// ---- metrics panel -------------------------------------------------------

async function openMetrics() {
  let text = "";
  try { text = await api("GET", "/api/v1/metrics"); }
  catch (e) { alert(e.message); return; }
  const rows = [];
  for (const line of text.split("\n")) {
    if (!line || line.startsWith("#")) continue;
    const sp = line.lastIndexOf(" ");
    rows.push([line.slice(0, sp), line.slice(sp + 1)]);
  }
  const body = document.getElementById("dlgbody");
  body.innerHTML = `<h2>Metrics</h2>`;
  const tbl = document.createElement("table");
  tbl.className = "kv";
  for (const [k, v] of rows) {
    const tr = document.createElement("tr");
    const td1 = document.createElement("td"); td1.textContent = k;
    const td2 = document.createElement("td"); td2.textContent = v;
    tr.appendChild(td1); tr.appendChild(td2); tbl.appendChild(tr);
  }
  body.appendChild(tbl);
  dlg.showModal();
}
