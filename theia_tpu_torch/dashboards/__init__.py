"""Flow-visibility dashboards: store-native queries + SVG web UI."""

from .grafana import grafana_dashboard, grafana_dashboards
from .queries import DASHBOARDS
from .web import render

__all__ = ["DASHBOARDS", "grafana_dashboard", "grafana_dashboards",
           "render"]
