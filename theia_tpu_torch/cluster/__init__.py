"""Multi-node cluster tier: membership, WAL log-shipping replication,
ingest routing, partition-tolerant failover (docs/cluster.md)."""

from .membership import (
    ClusterConfigError,
    ClusterMap,
    HeartbeatLoop,
    parse_peers,
)
from .node import ClusterNode, ClusterStateError
from .replication import (
    ACK_POLICIES,
    FollowerApplier,
    ReplicationLagError,
    ReplicationLeader,
    StaleReadError,
)
from .router import IngestRouter, RouterForwardError
from .transport import ClusterTransport, PeerUnreachable

__all__ = [
    "ACK_POLICIES",
    "ClusterConfigError",
    "ClusterMap",
    "ClusterNode",
    "ClusterStateError",
    "ClusterTransport",
    "FollowerApplier",
    "HeartbeatLoop",
    "IngestRouter",
    "PeerUnreachable",
    "ReplicationLagError",
    "ReplicationLeader",
    "RouterForwardError",
    "StaleReadError",
    "parse_peers",
]
