"""Declarative alert rules evaluated over the stored metrics history.

The scrape-to-store loop (obs/history.py) makes every process metric a
queryable time series; this module closes the alerting half of the
reference's Grafana-over-ClickHouse promise: rules are declared in a
JSON file (`THEIA_ALERT_RULES`, hot-reloaded on mtime change), and
each scrape tick they are evaluated THROUGH THE QUERY PLANE — the same
`table=__metrics__` plans any dashboard issues, so on a routing-mesh
node a rule sees the whole cluster's series (the PR-10 coordinator
fans the evaluation out), and what a rule computed is exactly what an
operator can reproduce with `theia query --table __metrics__`. The
streaming-evaluation framing is arXiv:1607.02480's: rules are standing
queries over the arriving series, not batch jobs.

Two rule types:

  * **threshold** — fold one metric's samples over a trailing
    `window` with `agg` (max / min / mean / rate) and compare against
    `threshold` with `op`. `rate` is the counter increase over the
    window divided by its span, computed PER SERIES (each labels ×
    node child is its own monotone counter, whose `max(valueMax) -
    min(valueMin)` is its exact window increase — raw or rolled up)
    and summed across the matching series; folding distinct children
    into one min/max would difference unrelated levels.
  * **burn_rate** — the SRE multi-window pattern: the rule names two
    (or more) `windows` (short, long) and fires only when EVERY
    window's rate breaches `threshold` — the short window makes
    detection fast, the long window keeps a brief spike from paging.
    With a `denominator` metric the rate is a ratio of increases
    (error budget burn); without one it is an absolute rate/s.

**Hysteresis.** A rule fires only after `for_ticks` consecutive
breached evaluations and resolves only after `clear_ticks` consecutive
clear ones, so a series oscillating around the threshold cannot flap
an alert per tick. Transitions (and only transitions) are published to
the alert ring — the same `/alerts` surface the ingest detectors feed
— as `kind: "rule"` entries carrying rule name, state, observed value,
and threshold.

`per_node: true` groups the evaluation by the `node` column: each node
key tracks its own hysteresis state, so "one node's ingest is slow"
fires for that node and names it, while the healthy nodes stay quiet.

Rule grammar (JSON file: a list, or `{"rules": [...]}`):

    {"name": "ingest-slow",
     "type": "threshold",            // default
     "metric": "theia_ingest_seconds_sum",
     "labels": "",                   // optional exact labels match
     "per_node": true,               // group + alert per node
     "agg": "rate",                  // max | min | mean | rate
     "window": 300,                  // seconds
     "op": ">=",                     // >= > <= < (default >=)
     "threshold": 1.5,
     "for_ticks": 2, "clear_ticks": 2}

    {"name": "error-burn",
     "type": "burn_rate",
     "metric": "theia_ingest_errors_total",
     "denominator": "theia_ingest_batches_total",
     "denominator_labels": "",    // denominator's OWN selector;
                                  // omit to inherit `labels` (the
                                  // mean-latency _sum/_count shape)
     "windows": [300, 3600],
     "threshold": 0.01}

A malformed file never takes working rules down: the previous rule set
keeps evaluating and the parse error is surfaced in the status doc
(`GET /alerts` → `rules.loadError`, `theia alerts --rules`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ..schema import METRICS_VALUE_SCALE
from ..utils.logging import get_logger
from . import metrics as _metrics
from ..analysis.lockdep import named_lock

logger = get_logger("obs.rules")

DEFAULT_WINDOW = 300
DEFAULT_FOR_TICKS = 2
DEFAULT_CLEAR_TICKS = 2

_AGGS = ("max", "min", "mean", "rate")
_OPS = {">=": lambda v, t: v >= t, ">": lambda v, t: v > t,
        "<=": lambda v, t: v <= t, "<": lambda v, t: v < t}

_M_EVALS = _metrics.counter(
    "theia_alert_rule_evaluations_total",
    "Alert-rule evaluations, by rule and outcome (ok / error)",
    labelnames=("rule", "result"))
_M_FIRING = _metrics.counter(
    "theia_alert_rule_firing_total",
    "Alert-rule firing transitions (pending->firing), by rule",
    labelnames=("rule",))


class RuleError(ValueError):
    """A rule document is malformed (unknown type/agg/op, missing
    fields) — a config error reported in the status doc, never an
    engine crash."""


class Rule:
    """One validated rule."""

    def __init__(self, doc: Dict[str, object]) -> None:
        if not isinstance(doc, dict):
            raise RuleError(f"rule must be an object, got {doc!r}")
        self.name = str(doc.get("name") or "").strip()
        if not self.name:
            raise RuleError("rule needs a non-empty `name`")
        self.type = str(doc.get("type") or "threshold")
        if self.type not in ("threshold", "burn_rate"):
            raise RuleError(
                f"rule {self.name}: unknown type {self.type!r}")
        self.metric = str(doc.get("metric") or "").strip()
        if not self.metric:
            raise RuleError(f"rule {self.name}: needs a `metric`")
        self.labels = str(doc.get("labels") or "")
        self.per_node = bool(doc.get("per_node"))
        self.op = str(doc.get("op") or ">=")
        if self.op not in _OPS:
            raise RuleError(
                f"rule {self.name}: unknown op {self.op!r} "
                f"(expected one of {sorted(_OPS)})")
        try:
            self.threshold = float(doc["threshold"])
        except (KeyError, TypeError, ValueError):
            raise RuleError(
                f"rule {self.name}: needs a numeric `threshold`")
        self.for_ticks = max(1, int(doc.get("for_ticks",
                                            DEFAULT_FOR_TICKS)))
        self.clear_ticks = max(1, int(doc.get("clear_ticks",
                                              DEFAULT_CLEAR_TICKS)))
        if self.type == "threshold":
            self.agg = str(doc.get("agg") or "max")
            if self.agg not in _AGGS:
                raise RuleError(
                    f"rule {self.name}: unknown agg {self.agg!r} "
                    f"(expected one of {_AGGS})")
            self.windows = (int(doc.get("window", DEFAULT_WINDOW)),)
            self.denominator = None
        else:
            self.agg = "rate"
            wins = doc.get("windows") or (DEFAULT_WINDOW,
                                          DEFAULT_WINDOW * 12)
            if not isinstance(wins, (list, tuple)) or not wins:
                raise RuleError(
                    f"rule {self.name}: `windows` must be a "
                    f"non-empty list of seconds")
            self.windows = tuple(int(w) for w in wins)
            self.denominator = (str(doc["denominator"])
                                if doc.get("denominator") else None)
            # denominator label selector: absent → inherit the
            # numerator's `labels` (the mean-latency _sum/_count
            # pattern); explicit "" → unfiltered (the error-vs-total
            # ratio, where inheriting the error selector would make
            # the ratio identically 1)
            dl = doc.get("denominator_labels")
            self.denominator_labels = (None if dl is None
                                       else str(dl))
        if any(w <= 0 for w in self.windows):
            raise RuleError(
                f"rule {self.name}: windows must be positive")

    def to_doc(self) -> Dict[str, object]:
        doc: Dict[str, object] = {
            "name": self.name, "type": self.type,
            "metric": self.metric, "op": self.op,
            "threshold": self.threshold, "agg": self.agg,
            "windows": list(self.windows),
            "forTicks": self.for_ticks,
            "clearTicks": self.clear_ticks,
        }
        if self.labels:
            doc["labels"] = self.labels
        if self.per_node:
            doc["perNode"] = True
        if self.denominator:
            doc["denominator"] = self.denominator
            if self.denominator_labels is not None:
                doc["denominatorLabels"] = self.denominator_labels
        return doc


class _SeriesState:
    """Hysteresis state for one (rule, node) key."""

    __slots__ = ("firing", "breach_streak", "clear_streak",
                 "since", "value")

    def __init__(self) -> None:
        self.firing = False
        self.breach_streak = 0
        self.clear_streak = 0
        self.since: Optional[float] = None
        self.value: Optional[float] = None


def parse_rules(raw: str) -> List[Rule]:
    """Parse a THEIA_ALERT_RULES document (a JSON list, or an object
    with a `rules` list). Raises RuleError on anything malformed —
    the whole file is rejected, so a typo cannot silently drop one
    rule while keeping its neighbors."""
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise RuleError(f"rules file is not valid JSON: {e}")
    if isinstance(doc, dict):
        doc = doc.get("rules")
    if not isinstance(doc, list):
        raise RuleError(
            "rules file must be a JSON list (or {\"rules\": [...]})")
    rules = [Rule(d) for d in doc]
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise RuleError(f"duplicate rule names: {names}")
    return rules


class RulesEngine:
    """Evaluates the loaded rule set each scrape tick over the stored
    `__metrics__` series, tracking hysteresis per (rule, node) and
    publishing firing/resolved transitions to the alert sink.

    `execute` is a callable(plan_doc) -> result doc — the manager
    wires the same engine `/query` serves (the cluster coordinator on
    a routing mesh), so rules see exactly what dashboards see."""

    def __init__(self, execute: Callable[[Dict[str, object]],
                                         Dict[str, object]],
                 alert_sink: Optional[Callable[[Dict[str, object]],
                                               None]] = None,
                 path: Optional[str] = None) -> None:
        self.execute = execute
        self.alert_sink = alert_sink
        self.path = (os.environ.get("THEIA_ALERT_RULES", "")
                     if path is None else path)
        self.rules: List[Rule] = []
        self.load_error: Optional[str] = None
        self.loaded_at: Optional[float] = None
        self._mtime: Optional[float] = None
        self._states: Dict[tuple, _SeriesState] = {}
        self._lock = named_lock("rules.engine")
        self.evaluations = 0
        self.transitions = 0
        self.reload()

    # -- loading -----------------------------------------------------------

    def reload(self, force: bool = False) -> bool:
        """(Re)load the rules file when its mtime moved (or `force`).
        A parse error KEEPS the previous rule set evaluating and
        records the error for the status doc. Returns True when the
        active set changed."""
        if not self.path:
            return False
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError as e:
            # recorded unconditionally: the path was explicitly
            # configured, so "unreadable since the very first load"
            # (a typo'd THEIA_ALERT_RULES) must surface in the status
            # doc too, not only "file vanished after a good load"
            self.load_error = f"rules file unreadable: {e}"
            return False
        if not force and mtime == self._mtime:
            return False
        self._mtime = mtime
        try:
            with open(self.path) as f:
                rules = parse_rules(f.read())
        except (OSError, RuleError) as e:
            self.load_error = str(e)
            logger.error("alert rules reload failed (keeping %d "
                         "previous rules): %s", len(self.rules), e)
            return False
        self.load_error = None
        self.loaded_at = time.time()
        with self._lock:
            self.rules = rules
            live = {r.name for r in rules}
            # drop state for removed rules; surviving rules keep
            # their hysteresis across a reload
            self._states = {k: v for k, v in self._states.items()
                            if k[0] in live}
        logger.info("alert rules loaded: %d from %s",
                    len(rules), self.path)
        return True

    # -- evaluation --------------------------------------------------------

    def _window_values(self, rule: Rule, window: int, now: int,
                       metric: Optional[str] = None,
                       labels: Optional[str] = None
                       ) -> Dict[str, Dict[str, float]]:
        """One metric folded over [now-window, now] → {node_key:
        {agg values in NATURAL units}}. node_key is '' unless the
        rule is per_node. The plan ALWAYS groups by (labels, node) —
        distinct label children and distinct nodes are distinct
        monotone series, so `increase` must be computed PER SERIES
        (max - min of one cumulative series is its exact window
        increase) and then summed; folding all children in one
        aggregate would report e.g. level(ok) - level(error), an
        absolute level, not any window's increase. min/max/mean fold
        across series exactly either way. The plan's end is now+1:
        samples stamped at the current tick are part of the window
        that triggered them."""
        metric = rule.metric if metric is None else metric
        labels = rule.labels if labels is None else labels
        filters = [{"column": "metric", "op": "eq", "value": metric}]
        if labels:
            filters.append({"column": "labels", "op": "eq",
                            "value": labels})
        doc: Dict[str, object] = {
            "table": "__metrics__",
            "groupBy": "labels,node",
            "filters": filters,
            "start": int(now) - int(window), "end": int(now) + 1,
            "aggregates": ["max:valueMax", "min:valueMin",
                           "sum:valueSum", "sum:valueCount"],
            "k": 0,
        }
        result = self.execute(doc)
        if result.get("partial"):
            # a degraded fan-out DROPS the missing peers' series —
            # counting their absence as clear ticks would resolve an
            # alert on exactly the node in trouble. Raising makes
            # evaluate() count an error evaluation and freeze state,
            # the same failed-query contract.
            raise RuntimeError(
                "partial cluster result (missing peers: "
                + ",".join(map(str, result.get("missingPeers") or []))
                + ")")
        s = float(METRICS_VALUE_SCALE)
        acc: Dict[str, Dict[str, float]] = {}
        for row in result.get("rows") or []:
            if int(row.get("sum(valueCount)") or 0) <= 0:
                continue   # the empty-window convention row
            key = str(row.get("node", "")) if rule.per_node else ""
            vmax = row["max(valueMax)"] / s
            vmin = row["min(valueMin)"] / s
            cur = acc.get(key)
            if cur is None:
                acc[key] = {"max": vmax, "min": vmin,
                            "vsum": row["sum(valueSum)"] / s,
                            "vcount": float(row["sum(valueCount)"]),
                            "increase": vmax - vmin}
            else:
                cur["max"] = max(cur["max"], vmax)
                cur["min"] = min(cur["min"], vmin)
                cur["vsum"] += row["sum(valueSum)"] / s
                cur["vcount"] += float(row["sum(valueCount)"])
                cur["increase"] += vmax - vmin
        return {k: {"max": v["max"], "min": v["min"],
                    "mean": v["vsum"] / v["vcount"],
                    "increase": v["increase"]}
                for k, v in acc.items()}

    def _rates(self, rule: Rule, window: int, now: int
               ) -> Dict[str, float]:
        """Burn rate per node key for one window: increase/second, or
        an increase ratio when the rule names a denominator. The
        denominator carries its OWN label selector
        (`denominator_labels`): OMITTED inherits the numerator's
        `labels` — the mean-latency `_sum`/`_count` shape, where both
        series share one selector — while an error-vs-total ratio
        whose numerator selects the error child must set it
        explicitly (`""` for unfiltered) or the ratio collapses to
        error/error = 1.0."""
        num = self._window_values(rule, window, now)
        if rule.denominator is None:
            return {k: v["increase"] / window for k, v in num.items()}
        den = self._window_values(rule, window, now,
                                  metric=rule.denominator,
                                  labels=rule.denominator_labels)
        out: Dict[str, float] = {}
        for k, v in num.items():
            d = den.get(k, {}).get("increase", 0.0)
            out[k] = (v["increase"] / d) if d > 0 else 0.0
        return out

    def _evaluate_rule(self, rule: Rule, now: int
                       ) -> Dict[str, tuple]:
        """{node_key: (observed value, breached)} for one rule.
        Threshold rules fold one window with `agg` and compare;
        burn_rate rules breach only when EVERY window's rate breaches
        (the reported value is the short window's — the one that
        moves first)."""
        breach = _OPS[rule.op]
        if rule.type == "threshold":
            window = rule.windows[0]
            vals = self._window_values(rule, window, now)
            out: Dict[str, tuple] = {}
            for k, v in vals.items():
                value = (v["increase"] / window if rule.agg == "rate"
                         else v[rule.agg])
                out[k] = (value, breach(value, rule.threshold))
            return out
        per_window = [self._rates(rule, w, now) for w in rule.windows]
        keys = set().union(*per_window) if per_window else set()
        return {k: (per_window[0].get(k, 0.0),
                    all(breach(pw.get(k, 0.0), rule.threshold)
                        for pw in per_window))
                for k in keys}

    def _transition(self, rule: Rule, node: str, state: _SeriesState,
                    firing: bool, now: int) -> None:
        state.firing = firing
        state.since = float(now)
        self.transitions += 1
        if firing:
            _M_FIRING.labels(rule=rule.name).inc()
        alert: Dict[str, object] = {
            "kind": "rule",
            "rule": rule.name,
            "state": "firing" if firing else "resolved",
            "metric": rule.metric,
            "value": state.value,
            "threshold": rule.threshold,
            "op": rule.op,
            "windows": list(rule.windows),
            "anomalous": bool(firing),
        }
        if node:
            alert["node"] = node
        logger.warning("alert rule %s %s%s: value=%s threshold=%s %s",
                       rule.name,
                       "FIRING" if firing else "resolved",
                       f" [node {node}]" if node else "",
                       state.value, rule.op, rule.threshold)
        if self.alert_sink is not None:
            self.alert_sink(alert)

    def evaluate(self, now: Optional[int] = None) -> int:
        """One evaluation pass over every loaded rule (hot-reloading
        first). Returns the number of state transitions published. A
        rule whose query fails counts an `error` evaluation and keeps
        its current state — a broken store must not mass-resolve
        every alert."""
        now = int(time.time()) if now is None else int(now)
        self.reload()
        transitions = 0
        for rule in list(self.rules):
            try:
                observed = self._evaluate_rule(rule, now)
            except Exception as e:
                _M_EVALS.labels(rule=rule.name, result="error").inc()
                logger.error("rule %s evaluation failed: %s",
                             rule.name, e)
                continue
            _M_EVALS.labels(rule=rule.name, result="ok").inc()
            self.evaluations += 1
            with self._lock:
                keys = set(observed) | {
                    k[1] for k in self._states if k[0] == rule.name}
                for node in keys:
                    st = self._states.setdefault(
                        (rule.name, node), _SeriesState())
                    value, is_breach = observed.get(node,
                                                    (None, False))
                    st.value = value
                    if is_breach:
                        st.breach_streak += 1
                        st.clear_streak = 0
                        if not st.firing and \
                                st.breach_streak >= rule.for_ticks:
                            self._transition(rule, node, st, True,
                                             now)
                            transitions += 1
                    else:
                        st.clear_streak += 1
                        st.breach_streak = 0
                        if st.firing and \
                                st.clear_streak >= rule.clear_ticks:
                            self._transition(rule, node, st, False,
                                             now)
                            transitions += 1
        return transitions

    # -- operator surface --------------------------------------------------

    def firing(self) -> List[Dict[str, object]]:
        with self._lock:
            return [{"rule": name, "node": node,
                     "value": st.value, "since": st.since}
                    for (name, node), st in sorted(self._states.items())
                    if st.firing]

    def doc(self) -> Dict[str, object]:
        """Status doc for GET /alerts (`rules`) and
        `theia alerts --rules`."""
        with self._lock:
            states = []
            for (name, node), st in sorted(self._states.items()):
                entry: Dict[str, object] = {
                    "rule": name,
                    "state": "firing" if st.firing else "ok",
                    "value": st.value,
                    "breachStreak": st.breach_streak,
                }
                if node:
                    entry["node"] = node
                if st.since is not None:
                    entry["since"] = st.since
                states.append(entry)
            out: Dict[str, object] = {
                "path": self.path,
                "rules": [r.to_doc() for r in self.rules],
                "states": states,
                "evaluations": self.evaluations,
                "transitions": self.transitions,
            }
        if self.load_error:
            out["loadError"] = self.load_error
        if self.loaded_at is not None:
            out["loadedAt"] = self.loaded_at
        return out
