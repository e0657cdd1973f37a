"""``GET /console`` — the fleet ops console, one self-contained page (a
copy of ``repro.server.console``).

A single static HTML string with inline CSS/JS and zero external
dependencies (no CDN, no fonts, no framework): the page must render
from an air-gapped serving host, and the stdlib frontend has no static
file tree to serve. The JS polls ``/debug/timeline`` and
``/debug/vars`` on an interval and redraws inline-SVG sparklines —
fleet rollup first (tok/s, goodput, rps, busy fractions with the
prefill:N,decode:M sizing signal when pools exist), then one row per
engine, with SLO-breach markers and steal/handoff/compile event ticks
under each lane.

Served with ``Cache-Control: no-cache`` so a console left open across
a redeploy picks up the new page on refresh.
"""

CONSOLE_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>repro fleet console</title>
<style>
  :root { --bg:#11151c; --panel:#1a2029; --ink:#d7dde6; --dim:#7b8494;
          --accent:#5cc8ff; --good:#7fd962; --warn:#ffb454; --bad:#f0616d;
          --grid:#242c38; }
  * { box-sizing: border-box; }
  body { margin:0; background:var(--bg); color:var(--ink);
         font:13px/1.45 ui-monospace,SFMono-Regular,Menlo,Consolas,monospace; }
  header { display:flex; gap:16px; align-items:baseline; padding:10px 16px;
           border-bottom:1px solid var(--grid); position:sticky; top:0;
           background:var(--bg); z-index:2; }
  header h1 { font-size:15px; margin:0; color:var(--accent); }
  header .meta { color:var(--dim); }
  header .err { color:var(--bad); }
  #panels { padding:12px 16px; display:flex; flex-direction:column; gap:12px; }
  .panel { background:var(--panel); border:1px solid var(--grid);
           border-radius:6px; padding:10px 12px; }
  .panel h2 { margin:0 0 6px; font-size:13px; font-weight:600; }
  .panel h2 .sub { color:var(--dim); font-weight:400; margin-left:8px; }
  .lanes { display:grid; grid-template-columns:repeat(auto-fill,minmax(230px,1fr));
           gap:8px 14px; }
  .lane .label { color:var(--dim); display:flex; justify-content:space-between; }
  .lane .label b { color:var(--ink); font-weight:600; }
  svg { display:block; width:100%; height:38px; }
  .spark { stroke:var(--accent); fill:none; stroke-width:1.4; }
  .fill  { fill:var(--accent); opacity:.12; stroke:none; }
  .evt   { stroke-width:2; }
  .breach { fill:var(--bad); opacity:.25; stroke:none; }
  .axis  { stroke:var(--grid); stroke-width:1; }
  .legend { color:var(--dim); margin-top:4px; }
  .legend i { display:inline-block; width:8px; height:8px; border-radius:2px;
              margin:0 4px 0 10px; vertical-align:baseline; }
  .pools td, .pools th { padding:2px 10px 2px 0; text-align:right; }
  .pools th { color:var(--dim); font-weight:400; }
  .pools td:first-child, .pools th:first-child { text-align:left; }
  .hint { color:var(--dim); margin-top:6px; }
</style>
</head>
<body>
<header>
  <h1>repro fleet console</h1>
  <span class="meta" id="status">connecting&hellip;</span>
  <span class="meta">window <select id="win">
    <option value="60">60s</option>
    <option value="120" selected>120s</option>
    <option value="300">300s</option>
    <option value="600">600s</option>
  </select> &middot; step <select id="step">
    <option value="1">1s</option>
    <option value="2">2s</option>
    <option value="5" selected>5s</option>
    <option value="15">15s</option>
  </select></span>
</header>
<div id="panels"></div>
<script>
"use strict";
const SERIES = [
  ["tok_s", "tok/s"], ["goodput_tok_s", "goodput tok/s"], ["rps", "req/s"],
  ["busy_frac", "busy frac"], ["prefill_busy_frac", "prefill busy frac"],
  ["decode_busy_frac", "decode busy frac"], ["cache_hit_tok_s", "cache-hit tok/s"],
  ["steal_s", "steals/s"], ["handoff_s", "handoffs/s"],
];
const GAUGES = [["queue_depth", "queue"], ["live_rows", "live rows"]];
const EVT_COLORS = { steals:"#ffb454", handoffs:"#5cc8ff",
                     compiles:"#c792ea", slo_breaches:"#f0616d" };
const esc = s => String(s).replace(/[&<>"]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const fmt = v => v == null ? "&ndash;"
  : Math.abs(v) >= 100 ? v.toFixed(0)
  : Math.abs(v) >= 1 ? v.toFixed(1) : v.toFixed(3);

function spark(vals, events, breachMask) {
  const W = 230, H = 38, PAD = 2, n = Math.max(vals.length, 2);
  const xs = i => PAD + i * (W - 2 * PAD) / (n - 1);
  const nums = vals.filter(v => v != null);
  const max = nums.length ? Math.max(...nums, 1e-9) : 1;
  const ys = v => H - 8 - (H - 14) * (v / max);
  let segs = [], seg = [];
  vals.forEach((v, i) => {
    if (v == null) { if (seg.length) segs.push(seg); seg = []; }
    else seg.push([xs(i), ys(v)]);
  });
  if (seg.length) segs.push(seg);
  let out = `<svg viewBox="0 0 ${W} ${H}" preserveAspectRatio="none">`;
  out += `<line class="axis" x1="0" y1="${H - 8}" x2="${W}" y2="${H - 8}"/>`;
  (breachMask || []).forEach((b, i) => {
    if (b) out += `<rect class="breach" x="${xs(i) - 2}" y="0" width="4"
      height="${H - 8}"/>`;
  });
  for (const s of segs) {
    if (s.length === 1) {
      out += `<circle cx="${s[0][0]}" cy="${s[0][1]}" r="1.6"
        fill="var(--accent)"/>`;
      continue;
    }
    const pts = s.map(p => p.map(x => x.toFixed(1)).join(",")).join(" ");
    out += `<polygon class="fill" points="${s[0][0].toFixed(1)},${H - 8}
      ${pts} ${s[s.length - 1][0].toFixed(1)},${H - 8}"/>`;
    out += `<polyline class="spark" points="${pts}"/>`;
  }
  for (const [name, counts] of Object.entries(events || {})) {
    const color = EVT_COLORS[name];
    if (!color) continue;
    (counts || []).forEach((c, i) => {
      if (c > 0) out += `<line class="evt" stroke="${color}"
        x1="${xs(i)}" y1="${H - 6}" x2="${xs(i)}" y2="${H - 1}"/>`;
    });
  }
  return out + "</svg>";
}

function last(arr) {
  if (!arr) return null;
  for (let i = arr.length - 1; i >= 0; i--)
    if (arr[i] != null) return arr[i];
  return null;
}

function lanesFor(doc, events, breach) {
  let html = '<div class="lanes">';
  for (const [key, label] of SERIES) {
    const vals = (doc.rates || {})[key];
    if (!vals) continue;
    html += `<div class="lane"><div class="label"><span>${esc(label)}</span>
      <b>${fmt(last(vals))}</b></div>${spark(vals, events, breach)}</div>`;
  }
  for (const [key, label] of GAUGES) {
    const vals = (doc.gauges || {})[key];
    if (!vals) continue;
    html += `<div class="lane"><div class="label"><span>${esc(label)}</span>
      <b>${fmt(last(vals))}</b></div>${spark(vals, null, null)}</div>`;
  }
  return html + "</div>";
}

function poolTable(pools) {
  const roles = Object.keys(pools || {});
  if (!roles.length) return "";
  let html = `<table class="pools"><tr><th>pool</th><th>engines</th>
    <th>busy frac</th><th>prefill frac</th><th>decode frac</th>
    <th>tok/s</th></tr>`;
  for (const r of roles) {
    const p = pools[r];
    html += `<tr><td>${esc(r)}</td><td>${p.engines}</td>
      <td>${fmt(last(p.busy_frac))}</td>
      <td>${fmt(last(p.prefill_busy_frac))}</td>
      <td>${fmt(last(p.decode_busy_frac))}</td>
      <td>${fmt(last(p.tok_s))}</td></tr>`;
  }
  html += "</table>";
  html += `<div class="hint">pool sizing: compare the prefill pool's
    <i>prefill frac</i> against the decode pool's <i>decode frac</i>
    (busy frac counts live decode rows, so a prefill-only pool reads 0
    there by construction) &mdash; prefill pinned near 1.0 while decode
    idles says shift an engine prefill-ward (docs/OBSERVABILITY.md).</div>`;
  return html;
}

function breachMask(doc, slo) {
  // mark buckets whose slo_breaches event count fired
  const ev = (doc.events || {}).slo_breaches || [];
  return ev.map(c => c > 0);
}

async function tick() {
  const win = document.getElementById("win").value;
  const step = document.getElementById("step").value;
  const status = document.getElementById("status");
  let doc;
  try {
    const r = await fetch(`/debug/timeline?window=${win}&step=${step}`,
                          { cache: "no-store" });
    if (!r.ok) throw new Error(`HTTP ${r.status}`);
    doc = await r.json();
  } catch (e) {
    status.textContent = `disconnected: ${e.message}`;
    status.className = "err";
    return;
  }
  status.className = "meta";
  status.textContent = `${doc.engines_reporting}/${doc.engines_total} engines`
    + ` reporting · ${new Date().toLocaleTimeString()}`;
  let html = "";
  if (doc.fleet) {
    const mask = breachMask(doc.fleet, doc.slo);
    html += `<div class="panel"><h2>fleet`
      + `<span class="sub">${doc.fleet.engines} engines</span></h2>`
      + lanesFor(doc.fleet, doc.fleet.events, mask)
      + poolTable(doc.fleet.pools)
      + `<div class="legend">events:`
      + Object.entries(EVT_COLORS).map(([k, c]) =>
          `<i style="background:${c}"></i>${k.replace("_", " ")}`).join("")
      + `</div></div>`;
  }
  for (const eng of doc.engines || []) {
    const mask = breachMask(eng, doc.slo);
    html += `<div class="panel"><h2>engine ${eng.engine}`
      + `<span class="sub">${esc(eng.role)} · ${eng.samples} samples`
      + ` · ${eng.dropped} dropped</span></h2>`
      + lanesFor(eng, eng.events, mask) + `</div>`;
  }
  if (!html) html = `<div class="panel">no recorders reporting yet
    &mdash; samples appear after the first interval.</div>`;
  document.getElementById("panels").innerHTML = html;
}

tick();
setInterval(tick, 2000);
document.getElementById("win").addEventListener("change", tick);
document.getElementById("step").addEventListener("change", tick);
</script>
</body>
</html>
"""
