// YAML editor pane: line-number gutter, syntax-highlight preview, and
// server-error line marking — the role monaco plays in the reference UI
// (reference web/package.json:18-28 pulls monaco-editor; this page has no
// build step, so the editor is hand-rolled at the size the workflows
// need).  All create/edit/config dialogs route through openYamlEditor.

let activeEditor = null;

function yamlHighlightLine(line) {
  if (/^\s*#/.test(line)) return `<span class="y-c">${esc(line)}</span>`;
  const m = line.match(/^(\s*(?:- )?)("[^"]*"|'[^']*'|[^\s:#][^:]*)(:)(.*)$/);
  if (!m) return esc(line);
  let out = esc(m[1]) + `<span class="y-k">${esc(m[2])}</span>` + ":";
  const val = m[4];
  if (/^\s*["']/.test(val)) out += `<span class="y-s">${esc(val)}</span>`;
  else if (/^\s*-?[0-9.]+\s*$/.test(val)) out += `<span class="y-n">${esc(val)}</span>`;
  else out += esc(val);
  return out;
}

function yamlHighlight(src) {
  return String(src).split("\n").map(yamlHighlightLine).join("\n");
}

function renderGutter(gutter, count, errLine) {
  const out = [];
  for (let i = 1; i <= count; i++) {
    out.push(i === errLine ? `<span class="errline">${i}</span>` : String(i));
  }
  gutter.dataset.count = count;
  gutter.innerHTML = out.join("\n");
}

function markErrorLine(gutter, n) {
  renderGutter(gutter, Number(gutter.dataset.count) || 1, n);
}

function openYamlEditor(titleHtml, text, onApply, extraHtml) {
  const body = document.getElementById("dlgbody");
  body.innerHTML = `<h2>${titleHtml}</h2>` + (extraHtml || "");
  const wrap = document.createElement("div");
  wrap.className = "yamleditor";
  const gutter = document.createElement("pre");
  gutter.className = "gutter";
  const hl = document.createElement("pre");
  hl.className = "highlight";
  const ta = document.createElement("textarea");
  ta.id = "editbody";
  ta.value = text;
  ta.spellcheck = false;
  const err = document.createElement("p");
  err.className = "muted errmsg";
  const sync = () => {
    renderGutter(gutter, String(ta.value).split("\n").length, 0);
    hl.innerHTML = yamlHighlight(ta.value);
  };
  ta.oninput = sync;
  ta.onscroll = () => { gutter.scrollTop = hl.scrollTop = ta.scrollTop; };
  sync();
  wrap.appendChild(gutter);
  wrap.appendChild(hl);
  wrap.appendChild(ta);
  body.appendChild(wrap);
  const b = document.createElement("button");
  b.textContent = "Apply";
  b.addEventListener("click", async () => {
    err.textContent = "";
    try {
      await onApply(ta.value);
      activeEditor = null;
      dlg.close();
    } catch (e) {
      // surface the server's message and mark "line N" references in
      // the gutter (YAML parse errors carry them)
      err.textContent = e.message;
      const m = String(e.message).match(/line (\d+)/);
      if (m) markErrorLine(gutter, parseInt(m[1], 10));
    }
  });
  const p = document.createElement("p");
  p.appendChild(b);
  p.appendChild(err);
  body.appendChild(p);
  activeEditor = {ta, sync, gutter};
  dlg.showModal();
  return activeEditor;
}
