"""Self-observability: metrics + tracing for the theia-tpu process.

The reference platform observes *itself* through ClickHouse `system.*`
tables, klog, and provisioned Grafana dashboards. This package is that
plane for the reproduction:

  * `obs.metrics` — process-wide Counter/Gauge/Histogram registry
    built for the ingest hot path (striped counters, power-of-two
    numpy-backed histograms).
  * `obs.trace`   — lightweight spans with per-thread context, a
    bounded ring of recent spans, and slowest-span exemplars per op.
  * `obs.prom`    — Prometheus text exposition (`GET /metrics` on the
    manager) and the parser `theia top` diffs into live rates.
"""

from . import metrics, prom, trace  # noqa: F401
from .metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    gauge,
    histogram,
)
from .trace import (  # noqa: F401
    child_span,
    current_context,
    ingress_span,
    span,
    traceparent,
)
