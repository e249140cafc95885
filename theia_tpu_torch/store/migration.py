"""Versioned schema migration for persisted FlowDatabase files.

Re-provides the reference's schema-management init container
(plugins/clickhouse-schema-management/main.go:62-117): a framework
version maps to a schema version (VERSION_MAP), stored data is migrated
up or down through ordered migrators to the target, and the resulting
version is stamped so future loads know where they stand. The reference
keeps five SQL migrators
(build/charts/theia/provisioning/datasources/migrators/0000{1..5}_*.sql);
here migrators are column transforms over the persisted .npz payload.

Schema history (mirrors the reference's column evolution):
  v1 — flows without `trusted`           (pre policy-feedback)
  v2 — + `trusted` UInt8                 (subsequent-NPR support)
  v3 — + `egressName`, `egressIP`        (egress observability)
  v4 — + `dropdetection` result table    (traffic-drop detection)
  v5 — + `tadetector.refitEvery`         (ARIMA refit-cadence audit)
  v6 — + `flowpatterns`, `spatialnoise`  (pattern mining + spatial
        DBSCAN result tables)
  v7 — + `__metrics__` result table      (self-scraped metrics
        history)
  v8 — + `__rollup__/<view>/*` payloads  (streaming rollup-view
        aggregate state stamped with its view definition; current)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

CURRENT_SCHEMA_VERSION = 8
VERSION_KEY = "__schema_version__"

# framework version → schema version (reference VERSION_MAP,
# clickhouse-schema-management/main.go)
VERSION_MAP = {
    "0.1.0": 1,
    "0.1.1": 2,
    "0.2.0": 3,
    "0.3.0": 4,
    "0.4.0": 5,
    "0.5.0": 6,
    "0.6.0": 7,
    "0.7.0": 8,
}

Payload = Dict[str, np.ndarray]


def _n_rows(payload: Payload, table: str = "flows") -> int:
    for key, arr in payload.items():
        if key.startswith(f"{table}/") and "__dict__" not in key:
            return len(arr)
    return 0


def _add_numeric(payload: Payload, name: str, dtype) -> None:
    payload[f"flows/{name}"] = np.zeros(_n_rows(payload), dtype)


def _add_string(payload: Payload, name: str) -> None:
    # code 0 == '' for every row; dictionary starts with just ''
    payload[f"flows/{name}"] = np.zeros(_n_rows(payload), np.int32)
    payload[f"flows/__dict__/{name}"] = np.asarray([""], dtype=object)


def _drop(payload: Payload, name: str) -> None:
    payload.pop(f"flows/{name}", None)
    payload.pop(f"flows/__dict__/{name}", None)


@dataclasses.dataclass(frozen=True)
class Migration:
    version: int            # version this migration upgrades TO
    name: str
    up: Callable[[Payload], None]
    down: Callable[[Payload], None]   # reverts to version-1


MIGRATIONS: List[Migration] = [
    Migration(
        version=2, name="add_trusted",
        up=lambda p: _add_numeric(p, "trusted", np.int32),
        down=lambda p: _drop(p, "trusted")),
    Migration(
        version=3, name="add_egress_name_ip",
        up=lambda p: (_add_string(p, "egressName"),
                      _add_string(p, "egressIP")) and None,
        down=lambda p: (_drop(p, "egressName"),
                        _drop(p, "egressIP")) and None),
    Migration(
        version=4, name="add_dropdetection_table",
        up=lambda p: _add_dropdetection(p),
        down=lambda p: _drop_table(p, "dropdetection")),
    Migration(
        version=5, name="add_tadetector_refit_every",
        # Pre-v5 rows predate the grouped-refit knob: every ARIMA job
        # ran the then-hardwired auto cadence. The zero-fill means "no
        # cadence recorded" (rows with algoType=ARIMA and refitEvery=0
        # are legacy approximate results, not exact ones).
        up=lambda p: _add_table_schema_column(p, "tadetector",
                                              "refitEvery"),
        down=lambda p: _drop_key(p, "tadetector/refitEvery")),
    Migration(
        version=6, name="add_flowpatterns_spatialnoise_tables",
        up=lambda p: (_add_empty_table(p, "flowpatterns"),
                      _add_empty_table(p, "spatialnoise")) and None,
        down=lambda p: (_drop_table(p, "flowpatterns"),
                        _drop_table(p, "spatialnoise")) and None),
    Migration(
        version=7, name="add_metrics_history_table",
        up=lambda p: _add_empty_table(p, "__metrics__"),
        down=lambda p: _drop_table(p, "__metrics__")),
    Migration(
        version=8, name="add_rollup_view_payloads",
        # Rollup aggregate state is OPTIONAL in a snapshot: a v8 load
        # with no `__rollup__/...` keys simply rebuilds the declared
        # views from the flows rows (query/rollup.py
        # restore_or_rebuild), so upgrading is a no-op. Downgrading
        # drops the payloads a pre-v8 reader would not understand.
        up=lambda p: None,
        down=lambda p: _drop_prefix(p, "__rollup__/")),
]


def _drop_prefix(payload: Payload, prefix: str) -> None:
    for key in [k for k in payload if k.startswith(prefix)]:
        payload.pop(key)


def _drop_key(payload: Payload, key: str) -> None:
    payload.pop(key, None)


def _add_table_schema_column(payload: Payload, table: str,
                             name: str) -> None:
    """Zero-fill a new numeric column with the LIVE schema's host dtype
    so migrated payloads match freshly-saved ones (adopt-time casting in
    flow_store would paper over a mismatch, but the on-disk format
    shouldn't diverge)."""
    from ..schema import TADETECTOR_SCHEMA
    schema = {"tadetector": TADETECTOR_SCHEMA}[table]
    col = next(c for c in schema if c.name == name)
    payload[f"{table}/{name}"] = np.zeros(_n_rows(payload, table),
                                          col.host_dtype)


def _add_dropdetection(payload: Payload) -> None:
    _add_empty_table(payload, "dropdetection")


def _add_empty_table(payload: Payload, table: str) -> None:
    """Empty result table (columns straight from the live schema so
    the migrator can't drift from it; string columns get an ''-seeded
    dict, the same empty-table layout FlowDatabase.save emits)."""
    from .flow_store import RESULT_TABLE_SCHEMAS
    schema = dict(RESULT_TABLE_SCHEMAS)[table]
    for col in schema:
        if col.is_string:
            payload[f"{table}/{col.name}"] = np.zeros(0, np.int32)
            payload[f"{table}/__dict__/{col.name}"] = np.asarray(
                [""], dtype=object)
        else:
            payload[f"{table}/{col.name}"] = np.zeros(0, col.host_dtype)


def _drop_table(payload: Payload, table: str) -> None:
    for key in [k for k in payload if k.startswith(f"{table}/")]:
        payload.pop(key)


def payload_version(payload: Payload) -> int:
    if VERSION_KEY in payload:
        return int(np.asarray(payload[VERSION_KEY]).item())
    # Unstamped files predate the migrator; infer from columns.
    if "flows/egressName" in payload:
        return 3
    if "flows/trusted" in payload:
        return 2
    return 1


def migrate(payload: Payload,
            target: int = CURRENT_SCHEMA_VERSION) -> Payload:
    """Migrate a persisted payload to `target`, stamping the result.
    Runs up- or down-migrators in order (main.go startMigration)."""
    if not 1 <= target <= CURRENT_SCHEMA_VERSION:
        raise ValueError(f"unknown schema version {target}")
    # Migration mutates the payload, so any integrity stamp written by
    # flow_store.write_snapshot no longer matches; drop it rather than
    # let a re-saved migrated payload fail verification. (Verification
    # runs BEFORE migration on load, so nothing is lost here.)
    from .flow_store import INTEGRITY_KEY
    payload.pop(INTEGRITY_KEY, None)
    version = payload_version(payload)
    if version > CURRENT_SCHEMA_VERSION:
        raise ValueError(
            f"data written by a newer schema (v{version}); refusing")
    while version < target:
        step = next(m for m in MIGRATIONS if m.version == version + 1)
        step.up(payload)
        version += 1
    while version > target:
        step = next(m for m in MIGRATIONS if m.version == version)
        step.down(payload)
        version -= 1
    force(payload, version)
    return payload


def force(payload: Payload, version: int) -> None:
    """Stamp a version without running migrators (main.go Force())."""
    payload[VERSION_KEY] = np.asarray(version, np.int64)


def schema_version_for(framework_version: str) -> int:
    """Map a framework version to its schema version; unknown versions
    get the current schema (forward-compatible default)."""
    return VERSION_MAP.get(framework_version, CURRENT_SCHEMA_VERSION)
