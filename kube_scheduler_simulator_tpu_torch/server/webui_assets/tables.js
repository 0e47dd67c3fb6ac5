// column extractors per kind (the reference's DataTables headers)
const TABLE_COLS = {
  pods: [["namespace", o=>(o.metadata||{}).namespace||""], ["name", o=>o.metadata.name],
         ["node", o=>(o.spec||{}).nodeName||""], ["phase", o=>(o.status||{}).phase||""],
         ["cpu req", o=>{try{return o.spec.containers[0].resources.requests.cpu||""}catch(e){return ""}}],
         ["selectedNode", o=>((o.metadata||{}).annotations||{})["scheduler-simulator/selected-node"]||""]],
  nodes: [["name", o=>o.metadata.name], ["cpu", o=>{try{return o.status.allocatable.cpu}catch(e){return ""}}],
          ["memory", o=>{try{return o.status.allocatable.memory}catch(e){return ""}}],
          ["pods", o=>{try{return o.status.allocatable.pods}catch(e){return ""}}],
          ["taints", o=>(((o.spec||{}).taints)||[]).map(t=>t.key).join(",")]],
  persistentvolumes: [["name", o=>o.metadata.name], ["capacity", o=>{try{return o.spec.capacity.storage}catch(e){return ""}}],
                      ["class", o=>(o.spec||{}).storageClassName||""], ["claim", o=>{try{return o.spec.claimRef.name}catch(e){return ""}}]],
  persistentvolumeclaims: [["namespace", o=>(o.metadata||{}).namespace||""], ["name", o=>o.metadata.name],
                           ["class", o=>(o.spec||{}).storageClassName||""], ["phase", o=>(o.status||{}).phase||""]],
  storageclasses: [["name", o=>o.metadata.name], ["provisioner", o=>o.provisioner||""]],
  priorityclasses: [["name", o=>o.metadata.name], ["value", o=>o.value]],
  namespaces: [["name", o=>o.metadata.name], ["phase", o=>(o.status||{}).phase||""]],
  deployments: [["namespace", o=>(o.metadata||{}).namespace||""], ["name", o=>o.metadata.name],
                ["replicas", o=>(o.spec||{}).replicas]],
  replicasets: [["namespace", o=>(o.metadata||{}).namespace||""], ["name", o=>o.metadata.name],
                ["replicas", o=>(o.spec||{}).replicas]],
  scenarios: [["namespace", o=>(o.metadata||{}).namespace||""], ["name", o=>o.metadata.name],
              ["phase", o=>(o.status||{}).phase||"(queued)"],
              ["operations", o=>(((o.spec||{}).operations)||[]).length]],
  // "current" counts ownership labels on the LIVE watched node state —
  // the generic resources route serves raw stored groups (no status)
  nodegroups: [["name", o=>o.metadata.name], ["min", o=>(o.spec||{}).minSize||0],
               ["max", o=>(o.spec||{}).maxSize||0],
               ["current", o=>Object.values(state.nodes).filter(
                  n=>((n.metadata||{}).labels||{})["scheduler-simulator/nodegroup"]===o.metadata.name).length],
               ["priority", o=>(o.spec||{}).priority||0],
               ["template cpu", o=>{try{return o.spec.template.status.allocatable.cpu}catch(e){return ""}}]],
  // gang PodGroups: member/bound counts from the LIVE watched pod state
  // (the poll serves raw stored groups; /api/v1/podgroups adds status)
  podgroups: [["namespace", o=>(o.metadata||{}).namespace||""], ["name", o=>o.metadata.name],
              ["minMember", o=>(o.spec||{}).minMember||1],
              ["members", o=>Object.values(state.pods).filter(
                 p=>((p.metadata||{}).labels||{})["pod-group.scheduling.sigs.k8s.io"]===o.metadata.name
                    && ((p.metadata||{}).namespace||"default")===((o.metadata||{}).namespace||"default")).length],
              ["bound", o=>Object.values(state.pods).filter(
                 p=>((p.metadata||{}).labels||{})["pod-group.scheduling.sigs.k8s.io"]===o.metadata.name
                    && ((p.metadata||{}).namespace||"default")===((o.metadata||{}).namespace||"default")
                    && (p.spec||{}).nodeName).length],
              ["timeout", o=>(o.spec||{}).scheduleTimeoutSeconds||""],
              ["packKey", o=>(o.spec||{}).topologyPackKey||""]],
};
function renderTables() {
  const root = document.getElementById("tables");
  root.innerHTML = "";
  for (const k of KINDS) {
    const cols = TABLE_COLS[k] || [["name", o=>o.metadata.name]];
    const objs = Object.values(state[k]).filter(matchesFilter);
    const h = document.createElement("h2");
    h.textContent = `${k} (${objs.length})`;
    root.appendChild(h);
    const tbl = document.createElement("table");
    tbl.className = "kv";
    tbl.dataset.kind = k;
    const hr = document.createElement("tr");
    for (const [label] of cols) {
      const th = document.createElement("td");
      th.innerHTML = `<b>${esc(label)}</b>`;
      hr.appendChild(th);
    }
    tbl.appendChild(hr);
    for (const o of objs) {
      const tr = document.createElement("tr");
      tr.style.cursor = "pointer";
      tr.addEventListener("click", () => k === "pods" ? showPod(o) : showObject(k, o));
      for (const [, fn] of cols) {
        const td = document.createElement("td");
        let v = ""; try { v = fn(o); } catch (e) {}
        td.textContent = v === undefined ? "" : v;
        tr.appendChild(td);
      }
      tbl.appendChild(tr);
    }
    root.appendChild(tbl);
  }
}
