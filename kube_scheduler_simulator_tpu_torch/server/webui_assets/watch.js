async function watchLoop() {
  while (true) {
    try {
      const resp = await fetch("/api/v1/listwatchresources");
      const reader = resp.body.getReader();
      const decoder = new TextDecoder();
      let buf = "";
      for (;;) {
        const {done, value} = await reader.read();
        if (done) break;
        buf += decoder.decode(value, {stream: true});
        const lines = buf.split("\n");
        buf = lines.pop();
        let dirty = false;
        for (const line of lines) {
          if (!line.trim()) continue;
          const ev = JSON.parse(line);
          const k = key(ev.Obj);
          if (!(ev.Kind in state)) continue;
          if (ev.EventType === "DELETED") delete state[ev.Kind][k];
          else state[ev.Kind][k] = ev.Obj;
          dirty = true;
        }
        if (dirty) render();
      }
    } catch (e) { /* server restart — retry */ }
    await new Promise(r => setTimeout(r, 1000));
  }
}

// deployments/replicasets/scenarios/nodegroups are kinds the watch stream
// doesn't carry (it mirrors the reference's 7 kinds) — poll them instead,
// along with the autoscaler status panel.
async function pollWorkloads() {
  for (;;) {
    try {
      for (const k of ["deployments", "replicasets", "scenarios", "nodegroups", "podgroups"]) {
        const lst = await api("GET", `/api/v1/resources/${k}`);
        state[k] = {};
        for (const o of lst.items) state[k][key(o)] = o;
      }
      render();
      await refreshAutoscaler();
      await refreshTuning();
    } catch (e) {}
    await new Promise(r => setTimeout(r, 3000));
  }
}
