"""The web UI, served at GET / by the simulator server.

Functional rebuild of the reference's Nuxt2/Vuetify SPA (reference web/,
SURVEY.md §2.2) as a single static page (no build step, no node_modules):

- per-resource views with pods bucketed under their node (or
  "unscheduled"), mirroring web/store/pod.ts:12-50
- per-kind DATA TABLES for every kind (the reference's
  web/components/ResourceViews/DataTables), toggled with the cluster view
- create resources from editable YAML templates served by the backend
  (web/components/lib/templates/*), POSTed as application/yaml; EDIT any
  object as YAML and apply (?format=yaml GET + YAML PUT — the reference's
  monaco editor role, no client-side YAML lib)
- per-pod scheduling-result dialog rendering every
  scheduler-simulator/* annotation, with the result-history annotation
  expanded into a per-attempt viewer (the reference's result dialog)
- scheduler configuration editor (GET/POST /api/v1/schedulerconfiguration)
- export / import / reset buttons
- live updates over the /api/v1/listwatchresources stream

The port's copy of the JAX package's ``server/webui.py``.  Its assets are
the port's own copy under ``webui_assets/`` beside this file, byte-equal to
the JAX package's, and the page's bytes are the reference's.
"""

HTML = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>kube-scheduler-simulator (TPU)</title>
<style>
  :root { --bg:#fafafa; --panel:#fff; --line:#e0e0e0; --accent:#326ce5; --mono:ui-monospace,Menlo,Consolas,monospace; }
  * { box-sizing:border-box; }
  body { margin:0; font:14px/1.45 system-ui,sans-serif; background:var(--bg); color:#222; }
  header { background:var(--accent); color:#fff; padding:10px 16px; display:flex; gap:12px; align-items:center; }
  header h1 { font-size:16px; margin:0 auto 0 0; font-weight:600; }
  button { background:#fff; color:var(--accent); border:1px solid #fff3; border-radius:4px; padding:5px 10px; cursor:pointer; font-weight:600; }
  main button { border-color:var(--accent); }
  main { display:grid; grid-template-columns: 2fr 1fr; gap:12px; padding:12px; }
  .panel { background:var(--panel); border:1px solid var(--line); border-radius:6px; padding:10px 12px; overflow:auto; }
  .node { border:1px solid var(--line); border-radius:6px; margin:8px 0; }
  .node>h3 { margin:0; padding:6px 10px; background:#f0f4ff; font-size:13px; border-bottom:1px solid var(--line); }
  .pod { display:inline-block; margin:6px; padding:4px 10px; background:#e8f0fe; border:1px solid #c6d7fb; border-radius:12px; cursor:pointer; font-size:12px; }
  .pod.unsched { background:#fdecea; border-color:#f6c8c4; }
  .kindrow { margin:4px 0; } .kindrow b { display:inline-block; width:160px; }
  .item { display:inline-block; margin:2px; padding:2px 8px; border:1px solid var(--line); border-radius:10px; font-size:12px; cursor:pointer; }
  dialog { width:min(900px,90vw); border:1px solid var(--line); border-radius:8px; }
  pre, textarea { font-family:var(--mono); font-size:12px; }
  textarea { width:100%; min-height:220px; }
  table.kv { border-collapse:collapse; width:100%; } .kv td { border-bottom:1px solid var(--line); padding:4px 6px; vertical-align:top; }
  .kv td:first-child { white-space:nowrap; color:#555; }
  .muted { color:#777; font-size:12px; }
  h2 { font-size:14px; margin:4px 0 8px; }
  .yamleditor { display:flex; gap:0; border:1px solid var(--line); border-radius:6px; overflow:hidden; max-height:380px; }
  .yamleditor .gutter { margin:0; padding:6px 8px; background:#f4f6fa; color:#99a; text-align:right; user-select:none; min-width:34px; overflow:hidden; }
  .yamleditor .highlight { margin:0; padding:6px 8px; flex:1; overflow:auto; white-space:pre; }
  .yamleditor textarea { flex:1; border:none; outline:none; resize:vertical; min-height:280px; padding:6px 8px; }
  .y-k { color:#1a56b0; font-weight:600; } .y-s { color:#188038; } .y-c { color:#999; font-style:italic; } .y-n { color:#b3261e; }
  .errline { background:#fdecea; color:#b3261e; font-weight:700; border-radius:3px; padding:0 2px; }
  .errmsg { color:#b3261e; display:inline-block; margin-left:10px; }
  .util { float:right; font-size:11px; border-radius:9px; padding:1px 8px; color:#fff; }
  .util.cool { background:#1e8e3e; } .util.warm { background:#f9ab00; } .util.hot { background:#d93025; }
</style>
</head>
<body>
<header>
  <h1>kube-scheduler-simulator <span class="muted" style="color:#cfe0ff">TPU-native</span></h1>
  <select id="sessionsel" onchange="onSessionPick()" title="session" style="border:none;border-radius:4px;padding:5px 8px"><option value="default">default</option></select>
  <input id="search" type="search" placeholder="filter…" style="border:none;border-radius:4px;padding:5px 8px;min-width:140px" oninput="onSearch()">
  <button id="viewtoggle" onclick="toggleView()">Tables</button>
  <button onclick="openMetrics()">Metrics</button>
  <button onclick="newResource()">+ Create</button>
  <button onclick="openSchedConfig()">Scheduler&nbsp;Config</button>
  <button onclick="doExport()">Export</button>
  <button onclick="doImport()">Import</button>
  <button onclick="doReset()">Reset</button>
</header>
<main id="clusterview">
  <div class="panel">
    <h2>Nodes &amp; Pods</h2>
    <div id="nodes"></div>
  </div>
  <div class="panel">
    <h2>Other resources</h2>
    <div id="others"></div>
    <h2 style="margin-top:14px">Autoscaler</h2>
    <div id="autoscaler" class="muted">…</div>
    <h2 style="margin-top:14px">Tuning</h2>
    <div id="tuning" class="muted">…</div>
  </div>
</main>
<main id="tablesview" style="display:none; grid-template-columns:1fr;">
  <div class="panel"><div id="tables"></div></div>
</main>
<dialog id="dlg"><div id="dlgbody"></div><p style="text-align:right"><button onclick="dlg.close()">Close</button></p></dialog>
<script src="/webui.js"></script>

</body>
</html>
"""

# The UI behavior is componentized into real asset files (the role of the
# reference's web/components/*), served individually at /webui/{name} and
# as the single concatenated /webui.js the page loads (classic scripts
# share one top-level lexical environment, so the concat is equivalent).
import os as _os

_ASSET_DIR = _os.path.join(_os.path.dirname(__file__), "webui_assets")
MODULE_ORDER = [
    "state.js",      # shared store: kinds, objects-by-key, search filter
    "api.js",        # fetch wrapper + HTML escaping + full refresh
    "sessions.js",   # session picker: X-KSS-Session fetch routing

    "quantity.js",   # kube resource.Quantity parsing + usage bars
    "editor.js",     # YAML editor pane: gutter, highlighting, error lines
    "clusterview.js",# nodes-and-pods view with utilization badges
    "tables.js",     # per-kind data tables (reference DataTables role)
    "dialogs.js",    # pod results / node capacity / object dialogs
    "forms.js",      # create/edit YAML, scheduler config, export/import
    "metrics.js",    # Prometheus metrics panel
    "autoscaler.js", # node-group table + autoscaler action feed
    "tuning.js",     # learned-scoring-head panel: run tuner, compare weights
    "watch.js",      # live list-watch stream + workload polling
    "main.js",       # bootstrap
]


def _load_modules() -> "dict[str, str]":
    out = {}
    for name in MODULE_ORDER:
        with open(_os.path.join(_ASSET_DIR, name), encoding="utf-8") as f:
            out[name] = f.read()
    return out


MODULES = _load_modules()
JS = "\n".join(f"// ==== {name} ====\n{src}" for name, src in MODULES.items())



# YAML creation templates per store kind, served at /api/v1/templates/{kind}
# (the role of the reference's web/components/lib/templates/*.yaml files).
# generateName is honored by the store with a deterministic counter suffix.
TEMPLATES_YAML = {
    "pods": """metadata:
  generateName: pod-
  namespace: default
  labels: {}
spec:
  containers:
    - name: main
      image: registry.k8s.io/pause:3.5
      resources:
        requests:
          cpu: 100m
          memory: 128Mi
  restartPolicy: Always
""",
    "nodes": """metadata:
  generateName: node-
  labels:
    topology.kubernetes.io/zone: zone-a
spec: {}
status:
  capacity:
    cpu: "4"
    memory: 32Gi
    pods: "110"
  allocatable:
    cpu: "4"
    memory: 32Gi
    pods: "110"
""",
    "deployments": """metadata:
  generateName: deployment-
  namespace: default
spec:
  replicas: 3
  selector:
    matchLabels:
      app: example
  template:
    metadata:
      labels:
        app: example
    spec:
      containers:
        - name: main
          resources:
            requests:
              cpu: 100m
              memory: 128Mi
""",
    "persistentvolumes": """metadata:
  generateName: pv-
spec:
  capacity:
    storage: 1Gi
  accessModes:
    - ReadWriteOnce
  persistentVolumeReclaimPolicy: Delete
  storageClassName: standard
""",
    "persistentvolumeclaims": """metadata:
  generateName: pvc-
  namespace: default
spec:
  accessModes:
    - ReadWriteOnce
  storageClassName: standard
  resources:
    requests:
      storage: 1Gi
""",
    "storageclasses": """metadata:
  generateName: storageclass-
provisioner: kubernetes.io/no-provisioner
volumeBindingMode: WaitForFirstConsumer
reclaimPolicy: Delete
""",
    "priorityclasses": """metadata:
  generateName: priorityclass-
value: 1000000
globalDefault: false
""",
    "namespaces": """metadata:
  generateName: namespace-
""",
    "nodegroups": """metadata:
  generateName: nodegroup-
spec:
  minSize: 0
  maxSize: 10
  priority: 0
  template:
    metadata:
      labels:
        topology.kubernetes.io/zone: zone-a
    spec: {}
    status:
      allocatable:
        cpu: "8"
        memory: 32Gi
        pods: "110"
""",
    "podgroups": """metadata:
  generateName: podgroup-
  namespace: default
spec:
  minMember: 4
  scheduleTimeoutSeconds: 300
  topologyPackKey: topology.kubernetes.io/zone
""",
    "scenarios": """metadata:
  generateName: scenario-
  namespace: default
spec:
  operations:
    - id: "1"
      step:
        major: 1
      createOperation:
        typeMeta:
          kind: Node
        object:
          metadata:
            generateName: node-
          status:
            allocatable:
              cpu: "4"
              memory: 32Gi
              pods: "110"
    - id: "2"
      step:
        major: 2
      createOperation:
        typeMeta:
          kind: Pod
        object:
          metadata:
            generateName: pod-
            namespace: default
          spec:
            containers:
              - name: main
                resources:
                  requests:
                    cpu: 100m
                    memory: 128Mi
    - id: "3"
      step:
        major: 3
      doneOperation: {}
""",
}
