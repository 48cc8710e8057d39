"""Browser UI for the OCR service.

Feature parity with the reference single-page app (templates/webui.html):
v1/v2 API tabs, model picker, confidence threshold, output format, bbox
and return_image toggles, a results table, a client-side quad overlay
rendered on a canvas over the uploaded image, and the zip download link
for multi-file text runs. The page itself is an original implementation
(no frameworks, one inline script) served by service/routes.py. Own copy of
onnxocr_tpu/service/ui.py: the same page, byte for byte.
"""
from __future__ import annotations

import json
from typing import Sequence

_STYLE = """
  :root { --ink:#1c2430; --line:#d7dce3; --accent:#2458c5; --bg:#f4f6f9; }
  * { box-sizing: border-box; }
  body { font-family: system-ui, -apple-system, sans-serif; margin: 0;
         background: var(--bg); color: var(--ink); }
  header { background: #fff; border-bottom: 1px solid var(--line);
           padding: .9rem 1.4rem; display: flex; align-items: baseline;
           gap: 1rem; }
  header h1 { font-size: 1.15rem; margin: 0; }
  #ready { font-size: .8rem; color: #888; }
  #ready.ok { color: #1a7f37; }
  main { max-width: 1080px; margin: 1.2rem auto; padding: 0 1rem; }
  .tabs { display: flex; gap: .4rem; margin-bottom: .8rem; }
  .tabs button { border: 1px solid var(--line); background: #fff;
                 padding: .45rem 1.4rem; border-radius: 6px 6px 0 0;
                 cursor: pointer; font-size: .95rem; }
  .tabs button.active { border-bottom: 2px solid var(--accent);
                        color: var(--accent); font-weight: 600; }
  .panel { background: #fff; border: 1px solid var(--line);
           border-radius: 0 8px 8px 8px; padding: 1.1rem; }
  .controls { display: flex; flex-wrap: wrap; gap: .9rem 1.4rem;
              align-items: center; margin: .7rem 0 1rem; }
  .controls label { font-size: .88rem; display: inline-flex;
                    gap: .35rem; align-items: center; }
  select, input[type=number] { padding: .25rem .4rem;
      border: 1px solid var(--line); border-radius: 4px; }
  .go { background: var(--accent); color: #fff; border: none;
        padding: .5rem 1.6rem; border-radius: 6px; cursor: pointer; }
  .go:disabled { opacity: .5; }
  #drop { border: 2px dashed var(--line); border-radius: 8px;
          padding: 1.2rem; text-align: center; color: #667; }
  #drop.hover { border-color: var(--accent); }
  .split { display: grid; grid-template-columns: 1fr 1fr; gap: 1rem;
           margin-top: 1rem; }
  @media (max-width: 800px) { .split { grid-template-columns: 1fr; } }
  .box { border: 1px solid var(--line); border-radius: 6px;
         min-height: 200px; padding: .6rem; overflow: auto;
         max-height: 560px; background: #fcfcfd; }
  canvas { max-width: 100%; }
  table { border-collapse: collapse; width: 100%; font-size: .85rem; }
  td, th { border-bottom: 1px solid var(--line); padding: .3rem .5rem;
           text-align: left; }
  pre { margin: 0; white-space: pre-wrap; font-size: .8rem; }
  .dl { display: inline-block; margin-top: .6rem; color: var(--accent); }
  .err { color: #b3261e; }
"""

_SCRIPT = """
const $ = id => document.getElementById(id);
let tab = 'v2';
function setTab(t) {
  tab = t;
  $('tab-v1').classList.toggle('active', t === 'v1');
  $('tab-v2').classList.toggle('active', t === 'v2');
  for (const el of document.querySelectorAll('.v2only'))
    el.style.display = (t === 'v2') ? '' : 'none';
  $('files').multiple = (t === 'v2');
}
async function checkReady() {
  try {
    const r = await fetch('/api/v2/readyz');
    const el = $('ready');
    el.textContent = r.ok ? 'engine ready' : 'warming up…';
    el.className = r.ok ? 'ok' : '';
    if (!r.ok) setTimeout(checkReady, 1500);
  } catch (e) { $('ready').textContent = 'offline'; }
}
function pickedFiles() {
  return $('files').files;
}
function showImage(file, boxes) {
  const canvas = $('view'), ctx = canvas.getContext('2d');
  const img = new Image();
  img.onload = () => {
    canvas.width = img.width; canvas.height = img.height;
    ctx.drawImage(img, 0, 0);
    ctx.strokeStyle = '#e8443a'; ctx.lineWidth = Math.max(2, img.width/400);
    for (const q of boxes || []) {
      ctx.beginPath();
      ctx.moveTo(q[0][0], q[0][1]);
      for (let i = 1; i < q.length; i++) ctx.lineTo(q[i][0], q[i][1]);
      ctx.closePath(); ctx.stroke();
    }
    URL.revokeObjectURL(img.src);
  };
  img.src = URL.createObjectURL(file);
}
function resultTable(results) {
  if (!results || !results.length) return '<em>no text found</em>';
  let h = '<table><tr><th>#</th><th>text</th><th>conf</th></tr>';
  results.forEach((r, i) => {
    h += `<tr><td>${i + 1}</td><td>${escapeHtml(r.text)}</td>` +
         `<td>${(r.confidence ?? 0).toFixed(3)}</td></tr>`;
  });
  return h + '</table>';
}
function escapeHtml(s) {
  return String(s).replace(/[&<>"]/g,
    c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[c]));
}
async function runV1(file) {
  const buf = new Uint8Array(await file.arrayBuffer());
  let bin = '';
  for (let i = 0; i < buf.length; i += 0x8000)
    bin += String.fromCharCode.apply(null, buf.subarray(i, i + 0x8000));
  const resp = await fetch('/ocr', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({image: btoa(bin)})});
  const data = await resp.json();
  if (data.error) throw new Error(data.error);
  $('out').innerHTML = resultTable(data.results) +
    `<div>processing_time: ${data.processing_time?.toFixed(3)}s</div>`;
  showImage(file, (data.results || []).map(r => r.bounding_box));
}
async function runV2(files) {
  const fd = new FormData();
  for (const f of files) fd.append(files.length > 1 ? 'files' : 'file', f);
  fd.append('model_name', $('model').value);
  fd.append('conf_threshold', $('thr').value);
  fd.append('output_format', $('fmt').value);
  fd.append('bbox', $('bbox').checked);
  fd.append('return_image', $('retimg').checked);
  const resp = await fetch('/api/v2/ocr', {method: 'POST', body: fd});
  const data = await resp.json();
  if (!resp.ok) throw new Error(data.error || resp.statusText);
  if (data.items) {            // multi-file session
    let h = '';
    for (const it of data.items) {
      h += `<h4>${escapeHtml(it.filename || '')}</h4>`;
      if (it.error) h += `<div class="err">${escapeHtml(it.error)}</div>`;
      else if (it.text !== undefined)
        h += `<pre>${escapeHtml(it.text)}</pre>`;
      else h += resultTable(it.results);
    }
    if (data.zip_url)
      h += `<a class="dl" href="${data.zip_url}">download zip</a>`;
    $('out').innerHTML = h;
    showImage(files[0], []);
    return;
  }
  if (data.results) {          // single-file json
    $('out').innerHTML = resultTable(data.results) +
      `<div>processing_time: ${data.processing_time?.toFixed(3)}s</div>`;
    if (data.preview_image) {
      const img = new Image();
      img.onload = () => {
        const c = $('view');
        c.width = img.width; c.height = img.height;
        c.getContext('2d').drawImage(img, 0, 0);
      };
      img.src = 'data:image/jpeg;base64,' + data.preview_image;
    } else {
      showImage(files[0],
                (data.results || []).map(r => r.bounding_box)
                                    .filter(Boolean));
    }
    return;
  }
  // text / tsv / hocr single-file shapes
  const body = data.text ?? data.tsv ?? data.hocr ?? '';
  $('out').innerHTML = `<pre>${escapeHtml(body)}</pre>`;
  showImage(files[0], []);
}
async function run() {
  const files = pickedFiles();
  const out = $('out');
  if (!files.length) { out.textContent = 'choose a file first'; return; }
  $('go').disabled = true;
  out.textContent = 'running…';
  try {
    if (tab === 'v1') await runV1(files[0]);
    else await runV2(files);
  } catch (e) { out.innerHTML = `<span class="err">${escapeHtml(e)}</span>`; }
  $('go').disabled = false;
}
const drop = $('drop');
drop.addEventListener('dragover', e => {
  e.preventDefault(); drop.classList.add('hover'); });
drop.addEventListener('dragleave', () => drop.classList.remove('hover'));
drop.addEventListener('drop', e => {
  e.preventDefault(); drop.classList.remove('hover');
  $('files').files = e.dataTransfer.files;
  $('picked').textContent = [...e.dataTransfer.files]
    .map(f => f.name).join(', ');
});
$('files').addEventListener('change', () => {
  $('picked').textContent = [...pickedFiles()].map(f => f.name).join(', ');
});
setTab('v2');
checkReady();
"""

_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>TPU OCR</title>
<style>{style}</style>
</head>
<body>
<header><h1>TPU OCR service</h1><span id="ready">checking…</span></header>
<main>
  <div class="tabs">
    <button id="tab-v2" onclick="setTab('v2')">v2 API</button>
    <button id="tab-v1" onclick="setTab('v1')">v1 API (compat)</button>
  </div>
  <div class="panel">
    <div id="drop">drop images here or
      <input type="file" id="files" multiple accept="image/*">
      <div id="picked"></div>
    </div>
    <div class="controls">
      <label class="v2only">model
        <select id="model">{model_options}</select></label>
      <label class="v2only">threshold
        <input type="number" id="thr" value="0.5" min="0" max="1"
               step="0.05" style="width:4.6rem"></label>
      <label class="v2only">format
        <select id="fmt"><option>json</option><option>text</option>
        <option>tsv</option><option>hocr</option></select></label>
      <label class="v2only"><input type="checkbox" id="bbox" checked>
        bounding boxes</label>
      <label class="v2only"><input type="checkbox" id="retimg">
        server-rendered preview</label>
      <button class="go" id="go" onclick="run()">Run OCR</button>
    </div>
    <div class="split">
      <div class="box"><canvas id="view"></canvas></div>
      <div class="box" id="out">results appear here</div>
    </div>
  </div>
</main>
<script>{script}</script>
</body>
</html>
"""


def render_index(model_names: Sequence[str]) -> str:
    options = "".join(f'<option value="{m}">{m}</option>'
                      for m in model_names)
    return _PAGE.format(style=_STYLE, script=_SCRIPT, model_options=options)
