"""Self-contained HTML/SVG dashboard renderer.

Replaces the reference's Grafana deployment + three custom TS panels
(plugins/grafana-custom-plugins: sankey via Google Charts, chord via
d3, dependency via mermaid) with dependency-free server-side SVG — the
manager serves these pages directly, so the observability UI works in
the zero-egress TPU environment with no Grafana, no JS CDNs.

Panels: sankey (two-column band diagram), line chart (timeseries),
bar list (pie-equivalent), dependency graph (layered left-to-right),
stat tiles, and raw tables. Pages map 1:1 to the reference dashboards
(queries.DASHBOARDS).
"""

from __future__ import annotations

import html
from typing import Dict, List

from . import queries

_PALETTE = ["#4e79a7", "#f28e2b", "#e15759", "#76b7b2", "#59a14f",
            "#edc948", "#b07aa1", "#ff9da7", "#9c755f", "#bab0ac"]


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:,.1f} {unit}"
        n /= 1024
    return f"{n:,.1f} PiB"


def _esc(s: object) -> str:
    return html.escape(str(s))


# -- SVG panels ----------------------------------------------------------

def svg_sankey(links: List[Dict[str, object]], width=640,
               height=360) -> str:
    if not links:
        return "<p class='empty'>no data</p>"
    sources = list(dict.fromkeys(l["source"] for l in links))
    targets = list(dict.fromkeys(l["target"] for l in links))
    total = sum(l["value"] for l in links) or 1
    s_out: Dict[str, float] = {s: 0.0 for s in sources}
    t_in: Dict[str, float] = {t: 0.0 for t in targets}
    for l in links:
        s_out[l["source"]] += l["value"]
        t_in[l["target"]] += l["value"]

    usable = height - 10 * max(len(sources), len(targets))
    usable = max(usable, 100)

    def stack(nodes, totals):
        pos, y = {}, 5.0
        for n in nodes:
            h = usable * totals[n] / total
            pos[n] = [y, y, h]  # top, fill-cursor, height
            y += h + 10
        return pos

    s_pos = stack(sources, s_out)
    t_pos = stack(targets, t_in)
    parts = [f"<svg viewBox='0 0 {width} {height}' "
             f"class='sankey' xmlns='http://www.w3.org/2000/svg'>"]
    x0, x1 = 150, width - 150
    for i, l in enumerate(links):
        h = usable * l["value"] / total
        sy = s_pos[l["source"]][1]
        ty = t_pos[l["target"]][1]
        s_pos[l["source"]][1] += h
        t_pos[l["target"]][1] += h
        c = _PALETTE[i % len(_PALETTE)]
        mid = (x0 + x1) / 2
        parts.append(
            f"<path d='M{x0},{sy + h / 2} C{mid},{sy + h / 2} "
            f"{mid},{ty + h / 2} {x1},{ty + h / 2}' stroke='{c}' "
            f"stroke-width='{max(h, 1):.1f}' fill='none' "
            f"opacity='0.55'><title>{_esc(l['source'])} → "
            f"{_esc(l['target'])}: {_fmt_bytes(l['value'])}</title>"
            f"</path>")
    for n in sources:
        top, _, h = s_pos[n]
        parts.append(f"<rect x='{x0 - 8}' y='{top}' width='8' "
                     f"height='{max(h, 1):.1f}' fill='#555'/>")
        parts.append(f"<text x='{x0 - 12}' y='{top + h / 2 + 4}' "
                     f"text-anchor='end' class='lbl'>{_esc(n)}</text>")
    for n in targets:
        top, _, h = t_pos[n]
        parts.append(f"<rect x='{x1}' y='{top}' width='8' "
                     f"height='{max(h, 1):.1f}' fill='#555'/>")
        parts.append(f"<text x='{x1 + 12}' y='{top + h / 2 + 4}' "
                     f"class='lbl'>{_esc(n)}</text>")
    parts.append("</svg>")
    return "".join(parts)


def svg_chord(links: List[Dict[str, object]], size=520) -> str:
    """Circular chord diagram: every entity is an arc on one circle
    (span ∝ its total in+out traffic), every flow a ribbon between its
    endpoints' arcs — the same layout the reference's d3 chord panel
    draws (plugins/grafana-custom-plugins/grafana-chord-plugin/src/
    ChordPanel.tsx, d3.chord over an N×N flow matrix)."""
    import math

    if not links:
        return "<p class='empty'>no data</p>"
    nodes = list(dict.fromkeys(
        [l["source"] for l in links] + [l["target"] for l in links]))
    totals = {n: 0.0 for n in nodes}
    for l in links:
        v = float(l["value"])
        totals[l["source"]] += v
        totals[l["target"]] += v
    total = sum(totals.values()) or 1.0

    pad = 0.06   # radians between node arcs
    span = 2 * math.pi - pad * len(nodes)
    if span <= 0:
        pad, span = 0.0, 2 * math.pi
    r_out, r_in = size / 2 - 50, size / 2 - 62
    cx = cy = size / 2

    def pt(angle: float, r: float):
        return (cx + r * math.cos(angle - math.pi / 2),
                cy + r * math.sin(angle - math.pi / 2))

    # Node arc spans + a fill cursor for ribbon sub-arcs (a node's arc
    # is consumed by its flows in link order, out and in alike).
    arcs: Dict[str, List[float]] = {}
    theta = 0.0
    for n in nodes:
        width_n = span * totals[n] / total
        arcs[n] = [theta, theta, width_n]   # start, cursor, width
        theta += width_n + pad

    def sub_arc(n: str, value: float):
        a0 = arcs[n][1]
        a1 = a0 + span * value / total
        arcs[n][1] = a1
        return a0, a1

    parts = [f"<svg viewBox='0 0 {size} {size}' class='chord' "
             f"xmlns='http://www.w3.org/2000/svg'>"]
    # Ribbons first (under the node arcs).
    for i, l in enumerate(sorted(links, key=lambda x: -x["value"])):
        v = float(l["value"])
        s0, s1 = sub_arc(l["source"], v)
        t0, t1 = sub_arc(l["target"], v)
        sx0, sy0 = pt(s0, r_in)
        sx1, sy1 = pt(s1, r_in)
        tx0, ty0 = pt(t0, r_in)
        tx1, ty1 = pt(t1, r_in)
        large_s = 1 if (s1 - s0) > math.pi else 0
        large_t = 1 if (t1 - t0) > math.pi else 0
        c = _PALETTE[nodes.index(l["source"]) % len(_PALETTE)]
        parts.append(
            f"<path d='M{sx0:.1f},{sy0:.1f} "
            f"A{r_in:.1f},{r_in:.1f} 0 {large_s} 1 "
            f"{sx1:.1f},{sy1:.1f} "
            f"Q{cx:.1f},{cy:.1f} {tx0:.1f},{ty0:.1f} "
            f"A{r_in:.1f},{r_in:.1f} 0 {large_t} 1 "
            f"{tx1:.1f},{ty1:.1f} "
            f"Q{cx:.1f},{cy:.1f} {sx0:.1f},{sy0:.1f} Z' "
            f"fill='{c}' opacity='0.45'>"
            f"<title>{_esc(l['source'])} → {_esc(l['target'])}: "
            f"{_fmt_bytes(l['value'])}</title></path>")
    # Node arcs + labels.
    for n in nodes:
        a0, _, w = arcs[n]
        a1 = a0 + w
        x0, y0 = pt(a0, r_out)
        x1, y1 = pt(a1, r_out)
        xi1, yi1 = pt(a1, r_in)
        xi0, yi0 = pt(a0, r_in)
        large = 1 if w > math.pi else 0
        c = _PALETTE[nodes.index(n) % len(_PALETTE)]
        parts.append(
            f"<path d='M{x0:.1f},{y0:.1f} "
            f"A{r_out:.1f},{r_out:.1f} 0 {large} 1 {x1:.1f},{y1:.1f} "
            f"L{xi1:.1f},{yi1:.1f} "
            f"A{r_in:.1f},{r_in:.1f} 0 {large} 0 {xi0:.1f},{yi0:.1f} "
            f"Z' fill='{c}'>"
            f"<title>{_esc(n)}: {_fmt_bytes(totals[n])}</title></path>")
        mid = (a0 + a1) / 2
        lx, ly = pt(mid, r_out + 10)
        anchor = "start" if math.cos(mid - math.pi / 2) >= 0 else "end"
        parts.append(f"<text x='{lx:.1f}' y='{ly:.1f}' "
                     f"text-anchor='{anchor}' class='lbl'>"
                     f"{_esc(n)}</text>")
    parts.append("</svg>")
    return "".join(parts)


def svg_lines(ts: Dict[str, object], width=640, height=220) -> str:
    times = ts.get("times", [])
    series = ts.get("series", {})
    if not times or not series:
        return "<p class='empty'>no data</p>"
    t0, t1 = min(times), max(times)
    span = max(t1 - t0, 1)
    vmax = max((max(ys) for ys in series.values()), default=1) or 1
    parts = [f"<svg viewBox='0 0 {width} {height}' class='lines' "
             f"xmlns='http://www.w3.org/2000/svg'>"]
    plot_w, plot_h, pad = width - 60, height - 30, 10
    for i, (name, ys) in enumerate(series.items()):
        pts = " ".join(
            f"{pad + plot_w * (t - t0) / span:.1f},"
            f"{pad + plot_h * (1 - y / vmax):.1f}"
            for t, y in zip(times, ys))
        c = _PALETTE[i % len(_PALETTE)]
        parts.append(f"<polyline points='{pts}' fill='none' "
                     f"stroke='{c}' stroke-width='1.5'>"
                     f"<title>{_esc(name)}</title></polyline>")
    parts.append(f"<text x='{pad}' y='{height - 6}' class='lbl'>"
                 f"{_fmt_bytes(vmax)}/s peak · "
                 f"{len(series)} series · {span}s window</text>")
    parts.append("</svg>")
    return "".join(parts)


def svg_barlist(items: List[Dict[str, object]], width=640) -> str:
    if not items:
        return "<p class='empty'>no data</p>"
    vmax = max(i["value"] for i in items) or 1
    rows = []
    for i, item in enumerate(items):
        w = 380 * item["value"] / vmax
        c = _PALETTE[i % len(_PALETTE)]
        y = 4 + i * 22
        rows.append(
            f"<text x='0' y='{y + 12}' class='lbl'>"
            f"{_esc(item['name'])}</text>"
            f"<rect x='200' y='{y}' width='{w:.0f}' height='16' "
            f"fill='{c}'/>"
            f"<text x='{204 + w:.0f}' y='{y + 12}' class='lbl'>"
            f"{_fmt_bytes(item['value'])}</text>")
    h = 8 + 22 * len(items)
    return (f"<svg viewBox='0 0 {width} {h}' class='bars' "
            f"xmlns='http://www.w3.org/2000/svg'>{''.join(rows)}</svg>")


def svg_dependency(edges: List[Dict[str, object]], width=640,
                   height=320) -> str:
    if not edges:
        return "<p class='empty'>no data</p>"
    left = list(dict.fromkeys(e["source"] for e in edges))
    right = list(dict.fromkeys(e["target"] for e in edges))
    pos_l = {n: 40 + i * (height - 60) / max(len(left) - 1, 1)
             for i, n in enumerate(left)}
    pos_r = {n: 40 + i * (height - 60) / max(len(right) - 1, 1)
             for i, n in enumerate(right)}
    vmax = max(e["value"] for e in edges) or 1
    parts = [f"<svg viewBox='0 0 {width} {height}' class='dep' "
             f"xmlns='http://www.w3.org/2000/svg'>"]
    for e in edges:
        y1, y2 = pos_l[e["source"]], pos_r[e["target"]]
        w = 1 + 5 * e["value"] / vmax
        parts.append(
            f"<line x1='170' y1='{y1}' x2='{width - 170}' y2='{y2}' "
            f"stroke='#4e79a7' stroke-width='{w:.1f}' opacity='0.6'>"
            f"<title>{_esc(e['source'])} → {_esc(e['target'])}: "
            f"{_fmt_bytes(e['value'])}</title></line>")
    for n, y in pos_l.items():
        parts.append(f"<circle cx='170' cy='{y}' r='5' fill='#333'/>"
                     f"<text x='160' y='{y + 4}' text-anchor='end' "
                     f"class='lbl'>{_esc(n)}</text>")
    for n, y in pos_r.items():
        parts.append(
            f"<circle cx='{width - 170}' cy='{y}' r='5' fill='#333'/>"
            f"<text x='{width - 160}' y='{y + 4}' class='lbl'>"
            f"{_esc(n)}</text>")
    parts.append("</svg>")
    return "".join(parts)


def stat_tiles(stats: Dict[str, object]) -> str:
    tiles = []
    for name, value in stats.items():
        shown = (_fmt_bytes(value) if "Bytes" in name
                 else f"{_fmt_bytes(value)}/s" if "Throughput" in name
                 else f"{value:,}" if isinstance(value, int) else value)
        tiles.append(f"<div class='tile'><div class='v'>{_esc(shown)}"
                     f"</div><div class='k'>{_esc(name)}</div></div>")
    return f"<div class='tiles'>{''.join(tiles)}</div>"


def table(rows: List[Dict[str, object]]) -> str:
    if not rows:
        return "<p class='empty'>no data</p>"
    cols = list(rows[0].keys())
    head = "".join(f"<th>{_esc(c)}</th>" for c in cols)
    body = "".join(
        "<tr>" + "".join(f"<td>{_esc(r.get(c, ''))}</td>"
                         for c in cols) + "</tr>"
        for r in rows)
    return (f"<table><thead><tr>{head}</tr></thead>"
            f"<tbody>{body}</tbody></table>")


_STYLE = """
body{font:14px system-ui,sans-serif;margin:24px;color:#222}
h1{font-size:20px} h2{font-size:16px;margin-top:28px}
nav a{margin-right:14px}
.tiles{display:flex;flex-wrap:wrap;gap:12px}
.tile{border:1px solid #ddd;border-radius:6px;padding:10px 16px;
      min-width:130px;text-align:center}
.tile .v{font-size:22px;font-weight:600}
.tile .k{font-size:11px;color:#666}
svg{max-width:100%;border:1px solid #eee;border-radius:6px;
    margin:6px 0}
svg .lbl{font:11px sans-serif;fill:#333}
table{border-collapse:collapse;font-size:12px}
td,th{border:1px solid #ddd;padding:3px 8px;text-align:left}
.empty{color:#999}
"""

_NAV = "".join(
    f"<a href='/dashboards/{name}'>{name.replace('_', ' ')}</a>"
    for name in queries.DASHBOARDS)


def _page(title: str, body: str) -> str:
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>theia-tpu · {_esc(title)}</title>"
            f"<style>{_STYLE}</style></head><body>"
            f"<nav><a href='/dashboards/'>⌂</a>{_NAV}</nav>"
            f"<h1>{_esc(title)}</h1>{body}</body></html>")


def render(name: str, db) -> str:
    """Render one dashboard page by name."""
    if name in ("", "index"):
        name = "homepage"
    if name not in queries.DASHBOARDS:
        raise KeyError(name)
    data = queries.DASHBOARDS[name](db)
    if name == "homepage":
        scalars = {k: v for k, v in data.items()
                   if not isinstance(v, (dict, list))}
        body = stat_tiles(scalars)
        if data.get("topNamespaces"):
            body += (f"<h2>top namespaces by traffic</h2>"
                     f"{svg_barlist(data['topNamespaces'])}")
        if data.get("throughput", {}).get("times"):
            body += (f"<h2>cluster throughput</h2>"
                     f"{svg_lines(data['throughput'])}")
    elif name == "flow_records":
        body = table(data)
    elif name in ("pod_to_pod", "pod_to_service", "pod_to_external"):
        body = (f"<h2>traffic (sankey)</h2>{svg_sankey(data['links'])}"
                f"<h2>throughput</h2>{svg_lines(data['throughput'])}"
                f"<h2>top sources</h2>"
                f"{svg_barlist(data.get('topSources', []))}")
    elif name == "node_to_node":
        body = (f"<h2>traffic (sankey)</h2>{svg_sankey(data['links'])}"
                f"<h2>throughput</h2>{svg_lines(data['throughput'])}")
    elif name == "networkpolicy":
        body = (f"<h2>policy traffic (chord)</h2>"
                f"{svg_chord(data['chord'])}"
                f"<h2>bytes by rule action</h2>"
                f"{svg_barlist(data['byAction'])}")
    else:  # network_topology
        body = (f"<h2>namespace dependencies</h2>"
                f"{svg_dependency(data['edges'])}")
    return _page(name.replace("_", " "), body)
