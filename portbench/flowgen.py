"""Flow records from a seed, as an Antrea Flow Aggregator exports them,
encoded as TBLK ingest blocks.

A frozen copy of the port's synthetic generator (the distributions of
`theia_tpu_torch/data/synth.py`: pod-to-pod, pod-to-service and
pod-to-external connections, a noisy per-connection throughput with a
spike on a share of them) and of its TBLK encoder
(`theia_tpu_torch/store/wire.py::encode_block`), rebuilt for streaming:
connections are drawn once, and every round each connection exports one
record (the active-flow timeout), so any number of rounds can be cut
into blocks without holding them all. Strings are built once per pod,
not once per row.

Imports nothing of the port: the benchmark's traffic must not change
when the program does.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

#: the flow table's columns in the port's schema order, with their wire
#: dtypes ("str" for dictionary strings)
SCHEMA: List[Tuple[str, str]] = [
    tuple(c) for c in json.loads(
        (Path(__file__).with_name("flow_schema.json")).read_text())]

#: the synthetic generator's epoch (2021-01-01 UTC)
DEFAULT_START = 1609459200
BLOCK_MAGIC = b"TBLK"
_HDR = struct.Struct("<IH")

FLOW_TYPE_INTRA_NODE = 1
FLOW_TYPE_INTER_NODE = 2
FLOW_TYPE_TO_EXTERNAL = 3

DEFAULTS = {
    "n_series": 64, "n_namespaces": 4, "pods_per_namespace": 8,
    "n_nodes": 3, "n_services": 4, "external_fraction": 0.1,
    "service_fraction": 0.3, "base_throughput": 1.0e6,
    "anomaly_fraction": 0.1, "anomaly_magnitude": 20.0,
    "protected_fraction": 0.0, "interval_seconds": 1,
    "start_time": DEFAULT_START,
    "cluster_uuid": "8a6a2e0e-0000-4000-8000-000000000001",
}


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser, elementwise on uint64."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


class Connections:
    """The per-connection identities of one cluster, drawn from the seed,
    and the per-round numeric columns. Each string column is a table of
    its distinct values plus one code per connection."""

    def __init__(self, params: Dict, seed: int, rounds: int,
                 spike_rounds: Tuple[int, int]) -> None:
        p = {**DEFAULTS, **params}
        self.p = p
        self.seed = int(seed)
        self.rounds = int(rounds)
        S = self.n = int(p["n_series"])
        rng = np.random.default_rng([self.seed, 0])
        n_ns, n_pods = int(p["n_namespaces"]), int(p["pods_per_namespace"])
        ns = rng.integers(0, n_ns, size=S)
        src_pod = rng.integers(0, n_pods, size=S)
        dns = rng.integers(0, n_ns, size=S)
        dst_pod = rng.integers(0, n_pods, size=S)
        src_node = rng.integers(0, int(p["n_nodes"]), size=S)
        dst_node = rng.integers(0, int(p["n_nodes"]), size=S)
        u = rng.random(size=S)
        ext = u < p["external_fraction"]
        svc = (~ext) & (u < p["external_fraction"] + p["service_fraction"])
        self.src_port = rng.integers(32768, 61000, size=S)
        self.dst_port = np.where(ext, 443, np.where(
            svc, 80, rng.integers(5201, 5210, size=S)))
        self.base = p["base_throughput"] * (0.5 + rng.random(size=S))
        anomalous = rng.random(size=S) < p["anomaly_fraction"]
        lo, hi = spike_rounds
        spike_t = rng.integers(lo, max(hi, lo + 1), size=S)
        self.spike_t = np.where(anomalous, spike_t, -1)
        protected = rng.random(size=S) < p["protected_fraction"]
        self.ext, self.svc, self.protected = ext, svc, protected
        n_svc = int(p["n_services"])
        idx = np.arange(S)

        # strings: a small vocabulary per column (per pod, namespace,
        # node, service) and one index a connection; code 0 is ""
        pods = n_ns * n_pods
        pod_ip = [f"10.{(g >> 16) & 255}.{(g >> 8) & 255}.{g & 255}"
                  for g in range(pods)]
        pod_name = [f"pod-{g // n_pods}-{g % n_pods}" for g in range(pods)]
        pod_lbl = ['{"app": "app-%d-%d"}' % (g // n_pods, g % n_pods)
                   for g in range(pods)]
        ns_name = [f"ns-{i}" for i in range(n_ns)]
        node = [f"node-{i}" for i in range(int(p["n_nodes"]))]
        ext_ip = [f"203.0.113.{i}" for i in range(250)]
        svc_name = [f"ns-{d}/svc-{k}:http" for d in range(n_ns)
                    for k in range(n_svc)]
        cluster_ip = [f"10.96.0.{k + 1}" for k in range(n_svc)]
        ing = [f"allow-ingress-{k}" for k in range(5)]
        eg = [f"allow-egress-{k}" for k in range(5)]
        sg, dg = ns * n_pods + src_pod, dns * n_pods + dst_pod
        every = np.ones(S, bool)
        ing_on = protected & ~ext

        def col(vocab, index, cond=every):
            table = np.array([b""] + [v.encode("utf-8") for v in vocab],
                             dtype=bytes)
            return table, np.where(cond, np.asarray(index) + 1, 0
                                   ).astype(np.int64)

        zero = np.zeros(S, np.int64)
        strings = {
            "sourceIP": col(pod_ip, sg),
            "destinationIP": col(pod_ip + ext_ip, np.where(
                ext, pods + idx % 250, dg)),
            "sourcePodName": col(pod_name, sg),
            "sourcePodNamespace": col(ns_name, ns),
            "sourceNodeName": col(node, src_node),
            "destinationPodName": col(pod_name, dg, ~ext),
            "destinationPodNamespace": col(ns_name, dns, ~ext),
            "destinationNodeName": col(node, dst_node, ~ext),
            "destinationClusterIP": col(cluster_ip, idx % n_svc, svc),
            "destinationServicePortName": col(
                svc_name, dns * n_svc + idx % n_svc, svc),
            "ingressNetworkPolicyName": col(ing, idx % 5, ing_on),
            "ingressNetworkPolicyNamespace": col(ns_name, dns, ing_on),
            "ingressNetworkPolicyRuleName": col(["rule-0"], zero, ing_on),
            "egressNetworkPolicyName": col(eg, idx % 5, protected),
            "egressNetworkPolicyNamespace": col(ns_name, ns, protected),
            "egressNetworkPolicyRuleName": col(["rule-0"], zero, protected),
            "tcpState": col(["ESTABLISHED"], zero),
            "sourcePodLabels": col(pod_lbl, sg),
            "destinationPodLabels": col(pod_lbl, dg, ~ext),
            "clusterUUID": col([p["cluster_uuid"]], zero),
            "egressName": col([], zero, ~every),
            "egressIP": col([], zero, ~every),
        }
        #: column → (table of utf-8 strings, code of each connection)
        self.strings = strings
        self.flow_type = np.where(ext, FLOW_TYPE_TO_EXTERNAL, np.where(
            src_node == dst_node, FLOW_TYPE_INTRA_NODE,
            FLOW_TYPE_INTER_NODE))
        self.flow_start = int(p["start_time"]) - 10

    def key_hash(self) -> np.ndarray:
        """A 64-bit hash of each connection's key (the detector's
        6-tuple): connections with equal keys hash alike."""
        h = np.zeros(self.n, np.uint64)
        for part in (self.strings["sourceIP"][1], self.src_port,
                     self.strings["destinationIP"][1], self.dst_port,
                     np.full(self.n, 6), np.full(self.n, self.flow_start)):
            h = _mix64(h ^ _mix64(np.asarray(part, np.int64)
                                  .astype(np.uint64)))
        return h

    def throughput(self, r: int) -> np.ndarray:
        """Round r's throughput of every connection (int64)."""
        rng = np.random.default_rng([self.seed, 1, r])
        noise = rng.normal(1.0, 0.05, size=self.n)
        series = self.base * np.clip(noise, 0.1, None)
        spike = self.base * self.p["anomaly_magnitude"]
        return np.where(self.spike_t == r, spike, series).astype(np.int64)

    def rounds_iter(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """(r, numeric columns of every connection in round r), carrying
        the cumulative counters from round to round."""
        S = self.n
        interval = int(self.p["interval_seconds"])
        pkt_tot = np.zeros(S, np.int64)
        oct_tot = np.zeros(S, np.int64)
        rpkt_tot = np.zeros(S, np.int64)
        roct_tot = np.zeros(S, np.int64)
        for r in range(self.rounds):
            thr = self.throughput(r)
            octd = thr * interval
            pktd = np.maximum(octd // 1400, 1)
            rpktd = np.maximum(octd // 28000, 1)
            roctd = octd // 20
            pkt_tot += pktd
            oct_tot += octd
            rpkt_tot += rpktd
            roct_tot += roctd
            end = np.full(S, int(self.p["start_time"]) + r * interval,
                          np.int64)
            yield r, {
                "timeInserted": end,
                "flowStartSeconds": np.full(S, self.flow_start, np.int64),
                "flowEndSeconds": end,
                "flowEndSecondsFromSourceNode": end,
                "flowEndSecondsFromDestinationNode": end,
                "flowEndReason": np.full(S, 3),
                "sourceTransportPort": self.src_port,
                "destinationTransportPort": self.dst_port,
                "protocolIdentifier": np.full(S, 6),
                "packetTotalCount": pkt_tot.copy(),
                "octetTotalCount": oct_tot.copy(),
                "packetDeltaCount": pktd,
                "octetDeltaCount": octd,
                "reversePacketTotalCount": rpkt_tot.copy(),
                "reverseOctetTotalCount": roct_tot.copy(),
                "reversePacketDeltaCount": rpktd,
                "reverseOctetDeltaCount": roctd,
                "destinationServicePort": np.where(self.svc, 80, 0),
                "ingressNetworkPolicyRuleAction": np.where(
                    self.protected & ~self.ext, 1, 0),
                "ingressNetworkPolicyType": np.where(
                    self.protected & ~self.ext, 1, 0),
                "egressNetworkPolicyRuleAction": np.where(
                    self.protected, 1, 0),
                "egressNetworkPolicyType": np.where(self.protected, 1, 0),
                "flowType": self.flow_type,
                "throughput": thr,
                "reverseThroughput": thr // 20,
                "throughputFromSourceNode": thr,
                "throughputFromDestinationNode": thr,
                "reverseThroughputFromSourceNode": thr // 20,
                "reverseThroughputFromDestinationNode": thr // 20,
                "trusted": np.zeros(S, np.int64),
            }


# -- the TBLK encoder ---------------------------------------------------

def _width_reduce(a: np.ndarray) -> Tuple[np.ndarray, int]:
    if a.dtype.kind in "iu" and a.itemsize > 1 and len(a):
        mn, mx = int(a.min()), int(a.max())
        for cand in ("<u1", "<u2", "<u4"):
            cdt = np.dtype(cand)
            if cdt.itemsize >= a.itemsize:
                break
            if mx - mn <= int(np.iinfo(cdt).max):
                return (a - mn).astype(cand), mn
    return a, 0


def encode_block(conns: Connections, numeric: Dict[str, np.ndarray],
                 rows: np.ndarray) -> bytes:
    """One TBLK payload: the rows `rows` (connection indices) of a round
    whose numeric columns are `numeric`. A string column ships the
    block's distinct strings in table order and local codes."""
    parts: List[bytes] = [BLOCK_MAGIC, _HDR.pack(len(rows), len(SCHEMA))]
    for name, dt in SCHEMA:
        bname = name.encode("utf-8")
        if dt == "str":
            table, codes = conns.strings[name]
            c = codes[rows]
            uniq, local = np.unique(c, return_inverse=True)
            code_dt = ("<u1" if len(uniq) <= 0xFF
                       else "<u2" if len(uniq) <= 0xFFFF else "<i4")
            enc = table[uniq].tolist()
            lens = np.fromiter(map(len, enc), "<i4", count=len(enc))
            blob = b"".join(enc)
            parts += [struct.pack("<H", len(bname)), bname,
                      struct.pack("<BIIB", 1, len(uniq), len(blob),
                                  np.dtype(code_dt).itemsize),
                      lens.tobytes(), blob,
                      local.astype(code_dt).tobytes()]
        else:
            a = np.ascontiguousarray(numeric[name][rows].astype(dt))
            stored, base = _width_reduce(a)
            dtb = np.dtype(dt).str.encode("ascii")
            sdt = stored.dtype.str.encode("ascii")
            parts += [struct.pack("<H", len(bname)), bname,
                      struct.pack("<BH", 0, len(dtb)), dtb,
                      struct.pack("<H", len(sdt)), sdt,
                      struct.pack("<qI", base, stored.nbytes),
                      stored.tobytes()]
    return b"".join(parts)


class Block:
    """One encoded block and where its rows came from."""
    __slots__ = ("payload", "rounds", "conns")

    def __init__(self, payload: bytes, rounds: np.ndarray,
                 conns: np.ndarray) -> None:
        self.payload = payload
        self.rounds = rounds      # [n] int32 round of each row
        self.conns = conns        # [n] int32 connection of each row


def stream_blocks(conns: Connections, n_streams: int,
                  block_rows: int) -> Iterator[Tuple[int, Block]]:
    """(stream, block) in round order: stream s owns the connections
    whose key hash is s mod n_streams, sends each round's records of its
    connections in connection order, and cuts its sequence into blocks
    of `block_rows` (a block may span two rounds). A stream's last
    partial block is sent when the rounds run out."""
    owner = (conns.key_hash() % np.uint64(n_streams)).astype(np.int64)
    mine = [np.flatnonzero(owner == s) for s in range(n_streams)]
    pend: List[List[Tuple[int, np.ndarray, Dict]]] = [
        [] for _ in range(n_streams)]
    pend_rows = [0] * n_streams

    def cut(s: int, final: bool):
        while pend_rows[s] >= block_rows or (final and pend_rows[s]):
            take = min(block_rows, pend_rows[s])
            chunks, got = [], 0
            while got < take:
                r, idx, num = pend[s][0]
                k = min(take - got, len(idx))
                chunks.append((r, idx[:k], num))
                if k == len(idx):
                    pend[s].pop(0)
                else:
                    pend[s][0] = (r, idx[k:], num)
                got += k
            pend_rows[s] -= take
            if len(chunks) == 1:
                payload = encode_block(conns, chunks[0][2], chunks[0][1])
            else:
                payload = _join(conns, chunks)
            yield s, Block(payload, np.concatenate(
                [np.full(len(i), r, np.int32) for r, i, _ in chunks]),
                np.concatenate([i for _, i, _ in chunks]).astype(np.int32))

    for r, num in conns.rounds_iter():
        for s in range(n_streams):
            if len(mine[s]):
                pend[s].append((r, mine[s], num))
                pend_rows[s] += len(mine[s])
            yield from cut(s, False)
    for s in range(n_streams):
        yield from cut(s, True)


def _join(conns: Connections, chunks) -> bytes:
    """Encode rows from two or more rounds as one block."""
    numeric = {name: np.concatenate([num[name][idx]
                                     for _, idx, num in chunks])
               for name, dt in SCHEMA if dt != "str"}
    rows = np.concatenate([idx for _, idx, _ in chunks])
    # numeric columns are already gathered: index them by position
    pos = np.arange(len(rows))
    return encode_block(_Gathered(conns, rows), numeric, pos)


class _Gathered:
    """A view of `conns` whose connection i is `rows[i]`: lets
    encode_block index the string codes by block position."""

    def __init__(self, conns: Connections, rows: np.ndarray) -> None:
        self.strings = {c: (t, codes[rows])
                        for c, (t, codes) in conns.strings.items()}
