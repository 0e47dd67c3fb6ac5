async function editObject(kind, o) {
  // YAML round-trip through the backend (?format=yaml GET, YAML PUT),
  // edited in the gutter/highlight pane (editor.js — the reference's
  // monaco role); a failed PUT surfaces the server message and marks
  // the offending line
  const ns = (o.metadata||{}).namespace;
  const path = `/api/v1/resources/${kind}/${o.metadata.name}` + (ns?`?namespace=${ns}`:"");
  let yamlText;
  try {
    yamlText = await api("GET", path + (ns?"&":"?") + "format=yaml");
  } catch (e) { alert(e.message); return; }
  openYamlEditor(`Edit ${esc(kind)} / ${esc(key(o))} (YAML)`, yamlText,
                 v => api("PUT", path, v, "application/yaml"));
}
// Creation templates are YAML served by the backend (the reference ships
// web/components/lib/templates/*.yaml); bodies POST as application/yaml.
const TEMPLATE_KINDS = ["pods","nodes","deployments","persistentvolumes","persistentvolumeclaims","storageclasses","priorityclasses","namespaces","scenarios"];

async function loadTemplate(kind) {
  const text = await api("GET", `/api/v1/templates/${kind}`);
  if (activeEditor) {
    activeEditor.ta.value = text;
    activeEditor.sync();
  }
}

async function newResource() {
  const opts = TEMPLATE_KINDS.map(k=>`<option>${k}</option>`).join("");
  openYamlEditor("Create resource (YAML)", "",
                 createResource,
                 `<p><select id="newkind" onchange="loadTemplate(this.value)">${opts}</select></p>`);
  await loadTemplate("pods");
}

async function createResource(yamlBody) {
  const kindEl = document.getElementById("newkind");
  const kind = kindEl ? kindEl.value || "pods" : "pods";
  await api("POST", `/api/v1/resources/${kind}`, yamlBody, "application/yaml");
}

async function openSchedConfig() {
  const cfg = await api("GET", "/api/v1/schedulerconfiguration");
  openYamlEditor("KubeSchedulerConfiguration", JSON.stringify(cfg, null, 2),
                 applySchedConfig,
                 `<p class="muted">POST honors only .profiles (reference behavior)</p>`);
}

async function applySchedConfig(text) {
  await api("POST", "/api/v1/schedulerconfiguration", JSON.parse(text));
}

async function doExport() {
  const snap = await api("GET", "/api/v1/export");
  const blob = new Blob([JSON.stringify(snap, null, 2)], {type: "application/json"});
  const a = Object.assign(document.createElement("a"), {href: URL.createObjectURL(blob), download: "snapshot.json"});
  a.click();
}

function doImport() {
  const inp = Object.assign(document.createElement("input"), {type: "file", accept: ".json"});
  inp.onchange = async () => {
    const text = await inp.files[0].text();
    await api("POST", "/api/v1/import", JSON.parse(text));
  };
  inp.click();
}

async function doReset() { if (confirm("Reset the simulator?")) await api("PUT", "/api/v1/reset"); }
