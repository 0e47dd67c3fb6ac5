const KINDS = ["pods","nodes","persistentvolumes","persistentvolumeclaims","storageclasses","priorityclasses","namespaces","deployments","replicasets","scenarios","nodegroups","podgroups"];
const state = Object.fromEntries(KINDS.map(k=>[k,{}]));
const dlg = document.getElementById("dlg");
const key = o => (o.metadata.namespace? o.metadata.namespace+"/" : "") + o.metadata.name;

let filterText = "";
let searchTimer = null;
function onSearch() {
  // debounced: at benchmark scale a per-keystroke full re-render of
  // thousands of DOM nodes would freeze the tab
  clearTimeout(searchTimer);
  searchTimer = setTimeout(() => {
    filterText = document.getElementById("search").value.toLowerCase();
    render();
  }, 150);
}
function matchesFilter(o) {
  if (!filterText) return true;
  const hay = key(o).toLowerCase() + " " + JSON.stringify(o.metadata.labels || {}).toLowerCase();
  return hay.includes(filterText);
}
