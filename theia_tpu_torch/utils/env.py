"""Environment helpers.

Re-provides pkg/util/env/env.go: the operating namespace comes from the
POD_NAMESPACE env var (injected by the deployment manifest) with the
`flow-visibility` default, and service endpoints can be overridden by
env the way CLICKHOUSE_URL/USERNAME/PASSWORD override discovery
(pkg/util/clickhouse/clickhouse.go:35-37,109-133).
"""

from __future__ import annotations

import os

DEFAULT_NAMESPACE = "flow-visibility"


def get_theia_namespace() -> str:
    return os.environ.get("POD_NAMESPACE", DEFAULT_NAMESPACE)


def get_manager_addr(default: str = "http://127.0.0.1:11347") -> str:
    """Manager endpoint, overridable via THEIA_MANAGER_ADDR (the CLI's
    --manager-addr flag wins over this)."""
    return os.environ.get("THEIA_MANAGER_ADDR", default)


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"env {name}={raw!r} is not an integer")


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"env {name}={raw!r} is not a number")
