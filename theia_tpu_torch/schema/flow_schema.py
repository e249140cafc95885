"""Antrea flow-record schema, as a columnar/tensor-friendly definition.

This is the L1 data contract of the framework: the same logical schema the
reference defines as ClickHouse DDL (reference:
build/charts/theia/provisioning/datasources/create_table.sh:31-84 declares the
`flows_local` table; :363-384 declares `tadetector_local`; :353-360 declares
`recommendations_local`).

Design notes (TPU-first):
  * Every column maps onto a fixed-width numpy/JAX dtype so a batch of flow
    records is a struct-of-arrays that can be `device_put` as-is.
  * DateTime columns are int64 unix seconds (ClickHouse DateTime is a 32-bit
    epoch; we keep 64-bit on host, and cast to int32/float32 on device only
    where safe).
  * String columns are dictionary-encoded: the store owns one
    `StringDictionary` per string column and batches carry int32 codes.
    This is what makes string group-bys (pod labels, namespaces) expressible
    as integer segment reductions on device.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class ColumnKind(enum.Enum):
    DATETIME = "datetime"  # int64 unix seconds
    U8 = "u8"
    U16 = "u16"
    U64 = "u64"
    F64 = "f64"
    STRING = "string"      # dictionary-encoded int32 code


_HOST_DTYPES = {
    ColumnKind.DATETIME: np.int64,
    ColumnKind.U8: np.int32,
    ColumnKind.U16: np.int32,
    ColumnKind.U64: np.int64,
    ColumnKind.F64: np.float64,
    ColumnKind.STRING: np.int32,
}

_CLICKHOUSE_TYPES = {
    ColumnKind.DATETIME: "DateTime",
    ColumnKind.U8: "UInt8",
    ColumnKind.U16: "UInt16",
    ColumnKind.U64: "UInt64",
    ColumnKind.F64: "Float64",
    ColumnKind.STRING: "String",
}


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    kind: ColumnKind

    @property
    def host_dtype(self):
        return _HOST_DTYPES[self.kind]

    @property
    def clickhouse_type(self) -> str:
        return _CLICKHOUSE_TYPES[self.kind]

    @property
    def is_string(self) -> bool:
        return self.kind == ColumnKind.STRING


def _cols(*specs) -> tuple:
    return tuple(Column(name, kind) for name, kind in specs)


K = ColumnKind

# The `flows` table — same 52 logical columns as the reference's flows_local
# (create_table.sh:31-84), in declaration order.
FLOW_SCHEMA: tuple = _cols(
    ("timeInserted", K.DATETIME),
    ("flowStartSeconds", K.DATETIME),
    ("flowEndSeconds", K.DATETIME),
    ("flowEndSecondsFromSourceNode", K.DATETIME),
    ("flowEndSecondsFromDestinationNode", K.DATETIME),
    ("flowEndReason", K.U8),
    ("sourceIP", K.STRING),
    ("destinationIP", K.STRING),
    ("sourceTransportPort", K.U16),
    ("destinationTransportPort", K.U16),
    ("protocolIdentifier", K.U8),
    ("packetTotalCount", K.U64),
    ("octetTotalCount", K.U64),
    ("packetDeltaCount", K.U64),
    ("octetDeltaCount", K.U64),
    ("reversePacketTotalCount", K.U64),
    ("reverseOctetTotalCount", K.U64),
    ("reversePacketDeltaCount", K.U64),
    ("reverseOctetDeltaCount", K.U64),
    ("sourcePodName", K.STRING),
    ("sourcePodNamespace", K.STRING),
    ("sourceNodeName", K.STRING),
    ("destinationPodName", K.STRING),
    ("destinationPodNamespace", K.STRING),
    ("destinationNodeName", K.STRING),
    ("destinationClusterIP", K.STRING),
    ("destinationServicePort", K.U16),
    ("destinationServicePortName", K.STRING),
    ("ingressNetworkPolicyName", K.STRING),
    ("ingressNetworkPolicyNamespace", K.STRING),
    ("ingressNetworkPolicyRuleName", K.STRING),
    ("ingressNetworkPolicyRuleAction", K.U8),
    ("ingressNetworkPolicyType", K.U8),
    ("egressNetworkPolicyName", K.STRING),
    ("egressNetworkPolicyNamespace", K.STRING),
    ("egressNetworkPolicyRuleName", K.STRING),
    ("egressNetworkPolicyRuleAction", K.U8),
    ("egressNetworkPolicyType", K.U8),
    ("tcpState", K.STRING),
    ("flowType", K.U8),
    ("sourcePodLabels", K.STRING),
    ("destinationPodLabels", K.STRING),
    ("throughput", K.U64),
    ("reverseThroughput", K.U64),
    ("throughputFromSourceNode", K.U64),
    ("throughputFromDestinationNode", K.U64),
    ("reverseThroughputFromSourceNode", K.U64),
    ("reverseThroughputFromDestinationNode", K.U64),
    ("clusterUUID", K.STRING),
    ("egressName", K.STRING),
    ("egressIP", K.STRING),
    ("trusted", K.U8),
)

FLOW_COLUMNS = tuple(c.name for c in FLOW_SCHEMA)
STRING_COLUMNS = tuple(c.name for c in FLOW_SCHEMA if c.is_string)
NUMERIC_COLUMNS = tuple(c.name for c in FLOW_SCHEMA if not c.is_string)

_BY_NAME = {c.name: c for c in FLOW_SCHEMA}


def column(name: str) -> Column:
    return _BY_NAME[name]


# Result table for throughput anomaly detection — matches the reference's
# tadetector_local (create_table.sh:363-384).
TADETECTOR_SCHEMA: tuple = _cols(
    ("sourceIP", K.STRING),
    ("sourceTransportPort", K.U16),
    ("destinationIP", K.STRING),
    ("destinationTransportPort", K.U16),
    ("protocolIdentifier", K.U16),
    ("flowStartSeconds", K.DATETIME),
    ("podNamespace", K.STRING),
    ("podLabels", K.STRING),
    ("podName", K.STRING),
    ("destinationServicePortName", K.STRING),
    ("direction", K.STRING),
    ("flowEndSeconds", K.DATETIME),
    ("throughputStandardDeviation", K.F64),
    ("aggType", K.STRING),
    ("algoType", K.STRING),
    ("algoCalc", K.F64),
    ("throughput", K.F64),
    ("anomaly", K.STRING),
    # Effective ARIMA refit cadence the job ran with (1 = the
    # reference's exact refit-per-step, k>1 = grouped-refit
    # approximation). 0 = no cadence recorded: non-ARIMA rows, or
    # ARIMA rows migrated from pre-v5 stores (disambiguate via
    # algoType). Extension beyond the reference schema so the
    # approximation is observable in results.
    ("refitEvery", K.U64),
    ("id", K.STRING),
)

# Result table for NetworkPolicy recommendation — matches the reference's
# recommendations_local (create_table.sh:353-360).
RECOMMENDATIONS_SCHEMA: tuple = _cols(
    ("id", K.STRING),
    ("type", K.STRING),
    ("timeCreated", K.DATETIME),
    ("policy", K.STRING),
    ("kind", K.STRING),
)

# Result table for abnormal traffic-drop detection — the capability the
# reference ships only on its Snowflake backend (UDTF result row at
# snowflake/udfs/udfs/drop_detection/drop_detection_udf.py:6-19; query
# shape snowflake/cmd/dropDetection.go:36-175).
DROPDETECTION_SCHEMA: tuple = _cols(
    ("jobType", K.STRING),
    ("id", K.STRING),
    ("timeCreated", K.DATETIME),
    ("endpoint", K.STRING),
    ("direction", K.STRING),
    ("avgDrop", K.F64),
    ("stdevDrop", K.F64),
    ("anomalyDropDate", K.DATETIME),
    ("anomalyDropNumber", K.U64),
)

# Result table for frequent flow-pattern mining (analytics/itemsets.py;
# the BASELINE north-star FP-Growth config). `items` is the itemset as
# "column=value|column=value" (the #/| delimiter convention the NPR
# peer strings use). No reference table: the reference has no itemset
# mining.
FLOWPATTERNS_SCHEMA: tuple = _cols(
    ("id", K.STRING),
    ("timeCreated", K.DATETIME),
    ("items", K.STRING),
    ("itemsetLength", K.U8),
    ("support", K.U64),
)

# Result table for spatial DBSCAN anomaly detection
# (analytics/spatial.py; BASELINE north-star config 3): one row per
# noise flow — a flow outside every recurring traffic pattern.
SPATIALNOISE_SCHEMA: tuple = _cols(
    ("id", K.STRING),
    ("timeCreated", K.DATETIME),
    ("sourceIP", K.STRING),
    ("destinationIP", K.STRING),
    ("destinationTransportPort", K.U16),
    ("octetDeltaCount", K.U64),
)

# Durable (cold) tier of the detector's flow-state working-set store
# (ingest/state_tier.py): one row per spilled connection series, the
# StreamState fields plus a restart-stable identity. The connection
# 6-tuple is stored with STRING IPs — dictionary codes are not stable
# across restarts — and `keyHash` (64-bit BLAKE2b of the resolved
# tuple) is the recovery index key; `seq` disambiguates re-spills of
# the same key (latest wins on read, older rows are prunable).
DETSTATE_SCHEMA: tuple = _cols(
    ("sourceIP", K.STRING),
    ("destinationIP", K.STRING),
    ("sourceTransportPort", K.U16),
    ("destinationTransportPort", K.U16),
    ("protocolIdentifier", K.U16),
    ("flowStartSeconds", K.DATETIME),
    ("ewma", K.F64),
    ("mean", K.F64),
    ("m2", K.F64),
    ("count", K.U64),
    ("seq", K.U64),
    ("keyHash", K.U64),
    ("timeSpilled", K.DATETIME),
)

#: the one authoritative name of the self-scraped metrics history
#: table — the store registers it, the planner resolves it, and the
#: scrape loop writes it, all from this constant
METRICS_TABLE = "__metrics__"

#: scale factor for metric values stored in the `__metrics__` table:
#: the query plane aggregates in exact int64, so float samples
#: (histogram sums in seconds, fractional gauges) are stored as
#: micro-units — `round(value * 1e6)` — and consumers divide back.
METRICS_VALUE_SCALE = 1_000_000

# The `__metrics__` table: the process's own Prometheus registry as
# stored time series (the role Grafana-over-ClickHouse history plays
# in the reference — dashboards query the store, never live scrapes).
# One row per series sample per scrape tick, Prometheus exposition
# naming: counters under their declared name, histograms as
# `<name>_bucket` (le in `labels`) / `<name>_sum` / `<name>_count`.
# Rows at coarser `resolution` are the downsampler's rollups: `value`
# is the LAST sample in the bucket (cumulative counters stay exact),
# and valueMin/Max/Sum/Count fold the raw samples exactly, so
# min/max/sum/count aggregations over a window are bit-identical
# whether they scan raw 15s points or rollup parts.
METRICS_SCHEMA: tuple = _cols(
    ("timeInserted", K.DATETIME),   # sample (bucket-start) time
    ("metric", K.STRING),           # exposition series name
    ("labels", K.STRING),           # sorted `k=v,k=v` (incl. `le`)
    ("node", K.STRING),             # recording node id ('' standalone)
    ("kind", K.STRING),             # counter|gauge|sum|count|bucket
    ("resolution", K.U64),          # seconds per sample bucket
    ("value", K.U64),               # last sample, micro-units
    ("valueMin", K.U64),            # exact folds over the raw samples
    ("valueMax", K.U64),
    ("valueSum", K.U64),
    ("valueCount", K.U64),
)
