"""Plain reference of the ingest path: what the store must hold and which
records the streaming detector must flag.

The detector: per connection (the 6-tuple key), the EWMA of the
throughput with α = 0.5 and a Welford running sample standard
deviation over the points seen so far; a point is anomalous when the
connection has seen two points or more and |x − ewma| exceeds that
deviation. Each line is one rounded operation in the state's precision
(float32 as the configuration states; the control runs it in
bfloat16). The points of a connection are taken in the order its
stream sent them.

Imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def key_ids(conns) -> Tuple[np.ndarray, int]:
    """A dense id per distinct connection key (equal keys, one id)."""
    keys = np.stack([conns.strings["sourceIP"][1], conns.src_port,
                     conns.strings["destinationIP"][1], conns.dst_port],
                    axis=1).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.ravel()
    return inv, int(inv.max()) + 1 if len(inv) else 0


def detector_flags(key: np.ndarray, x: np.ndarray, n_keys: int,
                   dtype: str = "float32") -> np.ndarray:
    """Anomaly flag of each point. `key` [n] is each point's connection
    id and `x` [n] its value, points in send order (a connection's
    points keep their relative order)."""
    order = np.argsort(key, kind="stable")
    k = key[order]
    n = len(k)
    if n == 0:
        return np.zeros(0, bool)
    start = np.r_[True, k[1:] != k[:-1]]
    run_start = np.maximum.accumulate(np.where(start, np.arange(n), 0))
    tick = np.arange(n) - run_start
    flags_sorted = np.zeros(n, bool)
    if dtype == "float32":
        f = np.float32
        ewma = np.zeros(n_keys, f)
        mean = np.zeros(n_keys, f)
        m2 = np.zeros(n_keys, f)
    else:
        import torch
        tdt = getattr(torch, dtype)
        ewma = torch.zeros(n_keys, dtype=tdt)
        mean = torch.zeros(n_keys, dtype=tdt)
        m2 = torch.zeros(n_keys, dtype=tdt)
    count = np.zeros(n_keys, np.int64)
    xs = x[order]
    for t in range(int(tick.max()) + 1):
        at = np.flatnonzero(tick == t)
        kk = k[at]
        count[kk] += 1
        c = count[kk]
        if dtype == "float32":
            xv = xs[at].astype(np.float64).astype(f)
            delta = xv - mean[kk]
            mean[kk] = mean[kk] + delta / c.astype(f)
            m2[kk] = m2[kk] + delta * (xv - mean[kk])
            ewma[kk] = f(0.5) * ewma[kk] + f(0.5) * xv
            std = np.sqrt(m2[kk] / np.maximum(c - 1, 1).astype(f))
            flags_sorted[at] = (c >= 2) & (np.abs(xv - ewma[kk]) > std)
        else:
            import torch
            tk = torch.from_numpy(kk)
            xv = torch.from_numpy(xs[at].astype(np.float64)).to(tdt)
            ct = torch.from_numpy(c).to(tdt)
            delta = xv - mean[tk]
            mean[tk] = mean[tk] + delta / ct
            m2[tk] = m2[tk] + delta * (xv - mean[tk])
            ewma[tk] = 0.5 * ewma[tk] + 0.5 * xv
            std = torch.sqrt(m2[tk] / torch.from_numpy(
                np.maximum(c - 1, 1)).to(tdt))
            flags_sorted[at] = (c >= 2) & (
                (xv - ewma[tk]).abs() > std).numpy()
    flags = np.empty(n, bool)
    flags[order] = flags_sorted
    return flags


def store_groups(conns, rounds: np.ndarray, rows: np.ndarray,
                 throughput_of) -> Dict[str, Dict[str, int]]:
    """The readback aggregates by source namespace over the rows
    (rounds[i], conns rows[i]): count and int64 sums, mins and maxes,
    keyed by the namespace string."""
    interval = int(conns.p["interval_seconds"])
    start = int(conns.p["start_time"])
    table, codes = conns.strings["sourcePodNamespace"]
    g = codes[rows]
    thr = np.empty(len(rows), np.int64)
    for r in np.unique(rounds):
        at = rounds == r
        thr[at] = throughput_of(int(r))[rows[at]]
    octd = thr * interval
    cols = {
        "count": np.ones(len(rows), np.int64),
        "sum_octetDeltaCount": octd,
        "sum_packetDeltaCount": np.maximum(octd // 1400, 1),
        "sum_throughput": thr,
        "sum_sourceTransportPort": conns.src_port[rows].astype(np.int64),
        "sum_destinationTransportPort":
            conns.dst_port[rows].astype(np.int64),
        "sum_flowEndSeconds": start + rounds.astype(np.int64) * interval,
    }
    n_g = len(table)
    out: Dict[str, Dict[str, int]] = {}
    sums = {}
    for name, v in cols.items():
        acc = np.zeros(n_g, np.int64)
        np.add.at(acc, g, v)
        sums[name] = acc
    end = cols["sum_flowEndSeconds"]
    mn = np.full(n_g, np.iinfo(np.int64).max)
    mx = np.full(n_g, np.iinfo(np.int64).min)
    np.minimum.at(mn, g, end)
    np.maximum.at(mx, g, end)
    for i in np.flatnonzero(sums["count"]):
        name = table[i].decode("utf-8")
        out[name] = {k: int(v[i]) for k, v in sums.items()}
        out[name]["min_flowEndSeconds"] = int(mn[i])
        out[name]["max_flowEndSeconds"] = int(mx[i])
    return out
