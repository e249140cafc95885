"""The multi-node cluster tier's error types, which the manager's
request handlers map to HTTP codes, and its transport's peer header
(transport.py).

Membership, WAL log-shipping replication, ingest routing and failover
are not ported yet (ROADMAP A19): the manager refuses a peer list, so
on a single node these errors are never raised. Each class is the
reference's own, from the module named beside it."""

__all__ = [
    "ClusterStateError",
    "ReplicationLagError",
    "RouterForwardError",
    "StaleReadError",
]


# cluster/node.py
class ClusterStateError(Exception):
    """A cluster control operation conflicts with this node's current
    state (promote below the applied LSN, promote on a leader, ...) —
    HTTP 409."""


# cluster/replication.py
class ReplicationLagError(Exception):
    """The configured ack quorum cannot be met right now (followers
    down/lagging/partitioned) — HTTP 503: retry later, the dedup
    window makes the retry idempotent."""


# cluster/replication.py
class StaleReadError(Exception):
    """A bounded-staleness follower read exceeded the staleness budget
    (HTTP 503 — read from the leader or retry after catch-up)."""


# cluster/router.py
class RouterForwardError(Exception):
    """A forwarded slice could not be acknowledged by its owner (after
    the client's full retry budget) — HTTP 503: the producer retries
    the whole batch; every already-landed slice resolves
    duplicate:true."""
