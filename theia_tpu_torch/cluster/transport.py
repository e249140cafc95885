"""Cluster-internal HTTP transport: one choke point for every byte
that crosses a node boundary.

All peer traffic — heartbeats, WAL frame shipping, resync streams,
promote RPCs, query-partial fan-out — goes through `ClusterTransport`,
which is where the network-level fault sites live:

    net.send           before any bytes leave for a peer
    net.recv           on the server side, before a peer's request is
                       processed (fired by the API handler via
                       `fire_recv`)
    peer.partition     BOTH directions of one link — checked inside
                       net.send and net.recv, so arming
                       `peer.partition#node2:error` severs the node2
                       link symmetrically: the deterministic
                       network-partition drill (utils/faults.py
                       grammar; per-peer targeting via `#<peer>`)

Connections are PERSISTENT: each peer keeps a small stack of idle
`http.client` connections reused across requests (heartbeats at 1 Hz,
a frame ship per ingest batch, and a partial per distributed query
used to pay a fresh TCP handshake each) and reconnects on error. A
request that fails on a REUSED connection before any response byte is
retried once on a fresh one — the classic keep-alive race where the
peer closed the idle socket; every cluster POST is idempotent by
design (duplicate frame ships are skipped, resyncs and partials are
pure), so the single silent retry is safe.

Requests carry `X-Theia-Node` (the sender's id) so the receiving side
can attribute the hit to a link, and the bearer token when the cluster
is authenticated (peers authenticate to each other exactly like
producers do — one token, the deployment's service secret). When the
calling thread runs inside a SAMPLED trace context (obs/trace.py), a
`traceparent` header rides along too, so the receiving node's spans
join the originating trace; unsampled/untraced requests carry no
header — with tracing disabled the wire is byte-identical.
"""

from __future__ import annotations

import http.client
import io
import json
import ssl
import threading
import urllib.error
import urllib.parse
from typing import Dict, List, Optional, Tuple

from ..obs import trace as _trace
from ..utils.faults import fire as _fire_fault
from ..utils.logging import get_logger
from ..analysis.lockdep import named_lock

logger = get_logger("cluster")

#: header carrying the sender's node id on every cluster request
NODE_HEADER = "X-Theia-Node"


class PeerUnreachable(Exception):
    """Transport-level failure talking to a peer (connect/read error,
    5xx, or an armed partition fault) — retryable, the peer may heal."""

    def __init__(self, peer: str, detail: str) -> None:
        super().__init__(f"peer {peer} unreachable: {detail}")
        self.peer = peer


def fire_recv(peer: Optional[str], path: str) -> None:
    """Server-side fault hook: the API handler calls this with the
    request's X-Theia-Node before processing a /cluster/* (or
    /query/partial) request, so a partition drill drops inbound
    traffic too (a real partition is symmetric)."""
    if peer:
        _fire_fault("net.recv", peer=peer, path=path)
        _fire_fault("peer.partition", peer=peer, path=path)


class ClusterTransport:
    """Minimal JSON/bytes HTTP client for peer calls, with per-peer
    persistent connection reuse."""

    #: idle connections kept per peer (heartbeat + shipper + a couple
    #: of concurrent query fan-outs share the stack; excess closes)
    MAX_IDLE_PER_PEER = 4

    def __init__(self, cmap, token: str = "",
                 ca_cert: Optional[str] = None,
                 timeout: float = 10.0) -> None:
        self.cmap = cmap
        self.token = token
        self.timeout = float(timeout)
        self._ctx = (ssl.create_default_context(cafile=ca_cert)
                     if ca_cert else None)
        self._idle: Dict[str, List[http.client.HTTPConnection]] = {}
        self._idle_lock = named_lock("transport.idle")
        self._closed = False

    # -- connection pool ---------------------------------------------------

    def _new_conn(self, peer: str,
                  timeout: float) -> http.client.HTTPConnection:
        import socket as _socket
        url = urllib.parse.urlsplit(self.cmap.addr(peer))
        if url.scheme == "https":
            ctx = self._ctx or ssl.create_default_context()
            conn = http.client.HTTPSConnection(
                url.hostname, url.port, timeout=timeout, context=ctx)
        else:
            conn = http.client.HTTPConnection(
                url.hostname, url.port, timeout=timeout)
        conn.connect()
        # TCP_NODELAY: a request is several small send()s (status
        # line, headers, body); on a REUSED connection Nagle + the
        # peer's delayed ACK turns each into a ~40ms stall — the
        # whole point of persistent connections is sub-ms peer calls
        conn.sock.setsockopt(_socket.IPPROTO_TCP,
                             _socket.TCP_NODELAY, 1)
        return conn

    def _acquire(self, peer: str, timeout: float
                 ) -> Tuple[http.client.HTTPConnection, bool]:
        """(connection, was_reused). A pooled connection gets the
        caller's timeout re-applied (resyncs run longer than pings)."""
        with self._idle_lock:
            stack = self._idle.get(peer)
            conn = stack.pop() if stack else None
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn, True
        return self._new_conn(peer, timeout), False

    def _release(self, peer: str,
                 conn: http.client.HTTPConnection) -> None:
        with self._idle_lock:
            if not self._closed:
                stack = self._idle.setdefault(peer, [])
                if len(stack) < self.MAX_IDLE_PER_PEER:
                    stack.append(conn)
                    return
        conn.close()

    def close(self) -> None:
        """Drop every pooled connection (node shutdown)."""
        with self._idle_lock:
            self._closed = True
            conns = [c for stack in self._idle.values()
                     for c in stack]
            self._idle.clear()
        for c in conns:
            try:
                c.close()
            except Exception:
                pass

    def pool_stats(self) -> Dict[str, int]:
        with self._idle_lock:
            return {p: len(s) for p, s in self._idle.items()}

    # -- requests ----------------------------------------------------------

    def _headers(self, extra: Optional[Dict[str, str]] = None
                 ) -> Dict[str, str]:
        h = {NODE_HEADER: self.cmap.self_id}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        tp = _trace.traceparent()
        if tp:
            h["traceparent"] = tp
        if extra:
            h.update(extra)
        return h

    def request(self, peer: str, path: str,
                data: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None) -> Dict[str, object]:
        """One GET (data=None) or POST to `peer`; returns the parsed
        JSON body. Raises PeerUnreachable on transport failure / 5xx /
        armed partition; an HTTP 4xx surfaces as urllib HTTPError (a
        protocol error, not a connectivity one)."""
        raw = self.request_raw(peer, path, data=data, headers=headers,
                               timeout=timeout)
        try:
            return json.loads(raw) if raw else {}
        except json.JSONDecodeError as e:
            raise PeerUnreachable(peer, f"undecodable response: {e}")

    def request_raw(self, peer: str, path: str,
                    data: Optional[bytes] = None,
                    headers: Optional[Dict[str, str]] = None,
                    timeout: Optional[float] = None) -> bytes:
        """`request` without the JSON decode — binary answers (query
        partial frames) read the body verbatim."""
        try:
            _fire_fault("net.send", peer=peer, path=path)
            _fire_fault("peer.partition", peer=peer, path=path)
        except Exception as e:
            raise PeerUnreachable(peer,
                                  f"{type(e).__name__}: {e}")
        t = timeout or self.timeout
        method = "POST" if data is not None else "GET"
        for attempt in (0, 1):
            conn, reused = self._acquire(peer, t)
            try:
                conn.request(method, path, body=data,
                             headers=self._headers(headers))
                resp = conn.getresponse()
                body = resp.read()
            except Exception as e:
                conn.close()
                if reused and attempt == 0 and isinstance(
                        e, (OSError, http.client.HTTPException)) \
                        and not isinstance(e, TimeoutError):
                    # stale keep-alive: the peer closed the idle
                    # socket under us — one silent retry on a FRESH
                    # connection (cluster POSTs are idempotent). A
                    # TIMEOUT is not that race (it manifests as an
                    # immediate reset, never a full timeout): a slow
                    # peer must not be waited on twice or re-execute
                    # the request.
                    continue
                raise PeerUnreachable(
                    peer, f"{type(e).__name__}: "
                          f"{getattr(e, 'reason', None) or e}")
            if resp.will_close:
                conn.close()
            else:
                self._release(peer, conn)
            if resp.status >= 500:
                raise PeerUnreachable(
                    peer, f"{resp.status}: "
                          f"{body[:200].decode(errors='replace')}")
            if resp.status >= 400:
                raise urllib.error.HTTPError(
                    self.cmap.addr(peer) + path, resp.status,
                    body.decode(errors="replace"), resp.headers,
                    io.BytesIO(body))
            return body
        raise PeerUnreachable(peer, "retry budget exhausted")
