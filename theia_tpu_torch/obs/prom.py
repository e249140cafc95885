"""Prometheus text exposition (version 0.0.4) + a matching parser.

`render()` turns the process registry into the text format every
Prometheus-compatible scraper ingests — the role the reference's
Grafana/ClickHouse `system.*` pipeline plays, served here by the
manager as `GET /metrics`. `parse()` is the inverse for the two
in-repo consumers: `theia top` (which diffs successive scrapes into a
live rates table) and the exposition golden tests (render → parse
round-trips exactly).

Rendering rules (the subset of the format we emit):

  * one `# HELP` / `# TYPE` pair per metric, metrics sorted by name,
    children sorted by label values — byte-stable output for a given
    registry state;
  * counters are emitted under their declared name (all ours end in
    `_total` by convention, enforced by a test);
  * histograms emit `<name>_bucket{le="..."}` cumulative counts
    (+Inf last), `<name>_sum`, `<name>_count`;
  * label values are escaped per the spec (backslash, quote, newline).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics
from . import trace as _trace

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labelnames: Tuple[str, ...],
                labelvalues: Tuple[str, ...],
                extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{n}="{_escape_label(v)}"'
             for n, v in zip(labelnames, labelvalues)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else _fmt_value(bound)


def render(registry: Optional[_metrics.Registry] = None) -> str:
    reg = registry if registry is not None else _metrics.REGISTRY
    lines: List[str] = []
    for metric in reg.collect():
        lines.append(f"# HELP {metric.name} "
                     f"{_escape_help(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for labelvalues, child in metric.children():
            if metric.kind == "histogram":
                cumulative, total, count = child.snapshot()
                bounds = _metrics.bucket_bounds() + [float("inf")]
                for bound, c in zip(bounds, cumulative):
                    lab = _fmt_labels(metric.labelnames, labelvalues,
                                      extra=("le", _fmt_le(bound)))
                    lines.append(
                        f"{metric.name}_bucket{lab} {int(c)}")
                lab = _fmt_labels(metric.labelnames, labelvalues)
                lines.append(
                    f"{metric.name}_sum{lab} {_fmt_value(total)}")
                lines.append(f"{metric.name}_count{lab} {count}")
            else:
                lab = _fmt_labels(metric.labelnames, labelvalues)
                lines.append(
                    f"{metric.name}{lab} "
                    f"{_fmt_value(child.value())}")
    return "\n".join(lines) + "\n"


def _parse_labels(raw: str) -> Tuple[Tuple[str, str], ...]:
    """`a="x",b="y"` → (("a","x"), ("b","y")) with unescaping."""
    out: List[Tuple[str, str]] = []
    i = 0
    while i < len(raw):
        eq = raw.index("=", i)
        name = raw[i:eq].strip().lstrip(",").strip()
        if raw[eq + 1] != '"':
            raise ValueError(f"malformed label value near {raw[eq:]!r}")
        j = eq + 2
        buf: List[str] = []
        while raw[j] != '"':
            if raw[j] == "\\":
                nxt = raw[j + 1]
                buf.append({"n": "\n", '"': '"', "\\": "\\"}
                           .get(nxt, "\\" + nxt))
                j += 2
            else:
                buf.append(raw[j])
                j += 1
        out.append((name, "".join(buf)))
        i = j + 1
    return tuple(out)


def parse(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                             float]:
    """Exposition text → {(series name, sorted label pairs): value}.
    Histogram series parse like any other (`x_bucket`, `x_sum`,
    `x_count` are distinct names). Comment/HELP/TYPE lines are
    skipped."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_raw, value_raw = rest.rsplit("}", 1)
            labels = tuple(sorted(_parse_labels(labels_raw)))
        else:
            name, value_raw = line.split(None, 1)
            labels = ()
        value_raw = value_raw.strip()
        if value_raw == "+Inf":
            value = float("inf")
        elif value_raw == "-Inf":
            value = float("-inf")
        else:
            value = float(value_raw)
        out[(name.strip(), labels)] = value
    return out


def traces_doc(limit: int = 100) -> Dict[str, object]:
    """The GET /debug/traces payload: recent spans (newest first) and
    the slowest exemplar per operation."""
    return {
        "recent": _trace.recent(limit),
        "slowest": _trace.slowest(),
    }
