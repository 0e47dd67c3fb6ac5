function render() {
  if (tablesMode) { renderTables(); return; }
  const nodesDiv = document.getElementById("nodes");
  nodesDiv.innerHTML = "";
  const buckets = {"(unscheduled)": []};
  for (const n of Object.values(state.nodes)) buckets[n.metadata.name] = [];
  for (const p of Object.values(state.pods)) {
    if (!matchesFilter(p)) continue;
    const nn = (p.spec||{}).nodeName;
    (buckets[nn] || buckets["(unscheduled)"]).push(p);
  }
  for (const [nodeName, pods] of Object.entries(buckets)) {
    if (nodeName === "(unscheduled)" && !pods.length) continue;
    const div = document.createElement("div");
    div.className = "node";
    const node = state.nodes[nodeName];
    const h = document.createElement("h3");
    h.textContent = nodeName + (node ? `  —  cpu ${((node.status||{}).allocatable||{}).cpu||"?"} / mem ${((node.status||{}).allocatable||{}).memory||"?"}` : "");
    if (node) {
      h.style.cursor = "pointer";
      h.onclick = () => showNode(node);
      // at-a-glance cpu pressure: requested/allocatable badge, colored
      // like the capacity bars in the node dialog
      const util = nodeCpuUtil(node, pods);
      const badge = document.createElement("span");
      badge.className = "util " + (util > 0.9 ? "hot" : util > 0.7 ? "warm" : "cool");
      badge.textContent = `${Math.min(100, Math.round(util * 100))}%`;
      h.appendChild(badge);
    }
    div.appendChild(h);
    for (const p of pods) {
      const s = document.createElement("span");
      s.className = "pod" + (nodeName === "(unscheduled)" ? " unsched" : "");
      s.textContent = key(p);
      s.onclick = () => showPod(p);
      div.appendChild(s);
    }
    nodesDiv.appendChild(div);
  }
  const others = document.getElementById("others");
  others.innerHTML = "";
  for (const k of KINDS) {
    if (k === "pods" || k === "nodes") continue;
    const row = document.createElement("div");
    row.className = "kindrow";
    row.innerHTML = `<b>${k}</b>`;
    for (const o of Object.values(state[k])) {
      if (!matchesFilter(o)) continue;
      const s = document.createElement("span");
      s.className = "item";
      s.textContent = key(o);
      s.onclick = () => showObject(k, o);
      row.appendChild(s);
    }
    others.appendChild(row);
  }
}

let tablesMode = false;
function toggleView() {
  tablesMode = !tablesMode;
  document.getElementById("clusterview").style.display = tablesMode ? "none" : "";
  document.getElementById("tablesview").style.display = tablesMode ? "grid" : "";
  document.getElementById("viewtoggle").textContent = tablesMode ? "Cluster" : "Tables";
  render();
}
