function deleteButton(kind, k) {
  // built via DOM (not inline onclick) so stored object names can't inject
  // script through attribute strings
  const b = document.createElement("button");
  b.textContent = "Delete";
  b.addEventListener("click", () => del(kind, k));
  const p = document.createElement("p");
  p.appendChild(b);
  return p;
}
function historyViewer(annos) {
  // result-history is a JSON array of per-attempt maps; render newest
  // last, one expandable block per attempt (the reference appends every
  // scheduling attempt's full result set, storereflector.go:148-167)
  const raw = annos["scheduler-simulator/result-history"];
  if (!raw) return "";
  let hist;
  try { hist = JSON.parse(raw); } catch (e) { return ""; }
  if (!Array.isArray(hist)) return "";
  let out = `<h3 style="margin:10px 0 4px">result history (${hist.length} attempt${hist.length===1?"":"s"})</h3>`;
  hist.forEach((attempt, idx) => {
    let rows = "";
    for (const [k,v] of Object.entries(attempt)) {
      let pretty = v;
      try { pretty = JSON.stringify(JSON.parse(v), null, 1); } catch (e) {}
      rows += `<tr><td>${esc(String(k).replace("scheduler-simulator/",""))}</td><td><pre style="margin:0;white-space:pre-wrap">${esc(pretty)}</pre></td></tr>`;
    }
    out += `<details ${idx===hist.length-1?"open":""}><summary>attempt ${idx+1}</summary><table class="kv">${rows}</table></details>`;
  });
  return out;
}
function showPod(p) {
  const annos = (p.metadata||{}).annotations || {};
  let rows = "";
  for (const [k,v] of Object.entries(annos)) {
    if (!k.startsWith("scheduler-simulator/") || k === "scheduler-simulator/result-history") continue;
    let pretty = v;
    try { pretty = JSON.stringify(JSON.parse(v), null, 1); } catch (e) {}
    rows += `<tr><td>${esc(k.replace("scheduler-simulator/",""))}</td><td><pre style="margin:0;white-space:pre-wrap">${esc(pretty)}</pre></td></tr>`;
  }
  const body = document.getElementById("dlgbody");
  body.innerHTML =
    `<h2>Pod ${esc(key(p))} — scheduling results</h2>
     <p class="muted">node: ${esc((p.spec||{}).nodeName||"(unscheduled)")}</p>
     <table class="kv">${rows || "<tr><td>no scheduler-simulator/* annotations yet</td></tr>"}</table>
     ${historyViewer(annos)}
     <details><summary>manifest</summary><pre>${esc(JSON.stringify(p,null,2))}</pre></details>`;
  body.appendChild(editButton("pods", p));
  body.appendChild(deleteButton("pods", key(p)));
  dlg.showModal();
}

function showObject(kind, o) {
  const body = document.getElementById("dlgbody");
  body.innerHTML =
    `<h2>${esc(kind)} / ${esc(key(o))}</h2>
     <pre>${esc(JSON.stringify(o,null,2))}</pre>`;
  if (kind === "scenarios") {
    // run the KEP-140 scenario synchronously and re-open on the finished
    // object (status.phase, per-step results)
    const rb = document.createElement("button");
    rb.textContent = "Run";
    rb.addEventListener("click", async () => {
      try {
        showObject("scenarios", await api("POST", "/api/v1/scenarios", o));
      } catch (e) { alert(e.message); }
    });
    const rp = document.createElement("p");
    rp.appendChild(rb);
    body.appendChild(rp);
  }
  body.appendChild(editButton(kind, o));
  body.appendChild(deleteButton(kind, key(o)));
  dlg.showModal();
}
function editButton(kind, o) {
  const b = document.createElement("button");
  b.textContent = "Edit";
  b.addEventListener("click", () => editObject(kind, o));
  const p = document.createElement("p");
  p.appendChild(b);
  return p;
}
function showNode(node) {
  const name = node.metadata.name;
  const alloc = (node.status||{}).allocatable || {};
  const pods = Object.values(state.pods).filter(p => (p.spec||{}).nodeName === name);
  let cpuReq = 0, memReq = 0;
  for (const p of pods) {
    for (const c of (p.spec||{}).containers || []) {
      const r = ((c.resources||{}).requests) || {};
      cpuReq += parseCpu(r.cpu); memReq += parseMem(r.memory);
    }
  }
  const cpuCap = parseCpu(alloc.cpu), memCap = parseMem(alloc.memory);
  const body = document.getElementById("dlgbody");
  body.innerHTML = `<h2>Node / ${esc(name)}</h2>` +
    bar(cpuCap ? cpuReq / cpuCap : 0, `cpu ${cpuReq.toFixed(2)} / ${esc(alloc.cpu||"?")}`) +
    bar(memCap ? memReq / memCap : 0, `memory ${(memReq/2**30).toFixed(2)}Gi / ${esc(alloc.memory||"?")}`) +
    bar((parseFloat(alloc.pods)||0) ? pods.length / parseFloat(alloc.pods) : 0,
        `pods ${pods.length} / ${esc(alloc.pods||"?")}`) +
    `<p class="muted">taints: ${esc((((node.spec||{}).taints)||[]).map(t=>`${t.key}=${t.value}:${t.effect}`).join(", ") || "none")}</p>`;
  const list = document.createElement("div");
  for (const p of pods) {
    const sp = document.createElement("span");
    sp.className = "pod"; sp.textContent = key(p); sp.onclick = () => showPod(p);
    list.appendChild(sp);
  }
  body.appendChild(list);
  body.appendChild(editButton("nodes", node));
  const raw = document.createElement("pre");
  raw.textContent = JSON.stringify(node, null, 2);
  body.appendChild(raw);
  dlg.showModal();
}
async function del(kind, k) {
  const [ns, name] = k.includes("/") ? k.split("/") : [null, k];
  await api("DELETE", `/api/v1/resources/${kind}/${name}` + (ns?`?namespace=${ns}`:""));
  dlg.close();
}
