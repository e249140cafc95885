"""Frequent flow-pattern mining with on-device support counting.

Ports theia_tpu/analytics/itemsets.py, one device. The BASELINE
north-star NPR config: "FP-Growth frequent-itemset mining on 1B
(src,dst,port) tuples, allreduce support counts over chips".

FP-Growth's tree is pointer-chasing, but its OUTPUT (all itemsets with
support >= min_support) is what matters. This module produces the same
output with staged, batched support counting (Apriori staging):

  level 1: per-item support = one scatter-add over the whole tuple
           stream;
  level 2: frequent items remapped to a dense [0, F) id space; every
           transaction's C(k,2) slot pairs encode to pair ids
           fa*F + fb; support = one scatter-add into F^2 counters;
  level 3: frequent pairs remapped to [0, P); triples encode to
           pair_id*F + fc; support = one scatter-add into P*F.

Every count is an int32 `index_add_` on the device, exact. With a
mesh, transactions shard over the mesh's first axis and each level's
count vectors are summed over the shards (the reference's `shard_map`
+ psum branch of `_counts_over`).

Transactions here are flow tuples: each row contributes one item per
selected column (e.g. sourcePodNamespace, destinationPodNamespace,
destinationTransportPort, protocolIdentifier) so a frequent itemset is
a recurring traffic pattern — the raw material for policy-rule
generalization.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..schema import ColumnarBatch
from ..utils.device import auto_mesh, resolve_device

DEFAULT_COLUMNS = (
    "sourcePodNamespace", "destinationPodNamespace",
    "destinationTransportPort", "protocolIdentifier")

# Dense count-buffer budget (int32 entries): 64M entries = 256 MiB.
_MAX_DENSE_COUNTS = 64 * 1024 * 1024


def _support_1(items: torch.Tensor, *, n_items: int) -> torch.Tensor:
    """items [n, k] int32 global item ids → per-item counts [n_items].
    Each transaction counts an item at most once (set semantics)."""
    flat = items.reshape(-1)
    counts = torch.zeros(n_items, dtype=torch.int32, device=items.device)
    return counts.index_add_(0, flat, torch.ones_like(flat))


def _support_2(dense: torch.Tensor, *, f: int) -> torch.Tensor:
    """dense [n, k] ids in [0, f) or -1 → pair counts [f*f] over all
    slot pairs a < b (invalid members drop out via id -1)."""
    n, k = dense.shape
    counts = torch.zeros(f * f, dtype=torch.int32, device=dense.device)
    for a in range(k):
        for b in range(a + 1, k):
            ia, ib = dense[:, a], dense[:, b]
            lo = torch.minimum(ia, ib)
            hi = torch.maximum(ia, ib)
            valid = lo >= 0
            pid = torch.where(valid, lo * f + hi, 0)
            counts.index_add_(0, pid, valid.to(torch.int32))
    return counts


def _support_3(dense: torch.Tensor, pair_id: torch.Tensor,
               *, p: int, f: int) -> torch.Tensor:
    """Triple counts [p*f]: for each transaction, each frequent pair
    (dense pair id in [0,p) via `pair_id` lookup, -1 if not frequent)
    x each third member c > the pair's slots.

    A pair with an invalid member would index `pair_id` out of range
    (lo = -1 gives -f - 1, or -2 when f == 1): the reference's gather
    clamps it and masks the result, a CUDA gather would fault, so the
    index is masked to 0 before the gather; the counts are the same."""
    n, k = dense.shape
    counts = torch.zeros(p * f, dtype=torch.int32, device=dense.device)
    for a in range(k):
        for b in range(a + 1, k):
            ia, ib = dense[:, a], dense[:, b]
            lo, hi = torch.minimum(ia, ib), torch.maximum(ia, ib)
            pair_ok = lo >= 0
            pid = torch.where(pair_ok,
                              pair_id[torch.where(pair_ok, lo * f + hi, 0)],
                              -1)
            for c in range(b + 1, k):
                ic = dense[:, c]
                valid = (pid >= 0) & (ic >= 0)
                tid = torch.where(valid, pid * f + ic, 0)
                counts.index_add_(0, tid, valid.to(torch.int32))
    return counts


def _encode_items(flows: ColumnarBatch, columns: Sequence[str]
                  ) -> Tuple[np.ndarray, List[Tuple[str, int]]]:
    """Rows → [n, k] global item ids; item = (column, code). Returns the
    id→(column, code) table for decoding."""
    mats, table = [], []
    base = 0
    for col in columns:
        codes = np.asarray(flows[col], np.int64)
        if len(codes) and int(codes.min()) < 0:
            # A negative sentinel would alias into the previous column's
            # item-id range and corrupt support counts on decode.
            raise ValueError(
                f"column {col!r} contains negative codes; itemset "
                f"columns must be non-negative dictionary codes")
        n_codes = int(codes.max()) + 1 if len(codes) else 1
        mats.append(codes + base)
        table.extend((col, c) for c in range(n_codes))
        base += n_codes
    return np.stack(mats, axis=1).astype(np.int32), table


def mine_frequent_patterns(
        flows: ColumnarBatch,
        min_support: int,
        columns: Sequence[str] = DEFAULT_COLUMNS,
        max_len: int = 3,
        mesh=None,
        device="cuda",
        ) -> List[Tuple[Tuple[Tuple[str, str], ...], int]]:
    """All itemsets (as ((column, value), ...) tuples) with support >=
    min_support, FP-Growth-equivalent output, counted on `device`.
    With `mesh`, transactions shard over the mesh's first axis and
    each level's counts are summed over the shards (psum)."""
    dev = None if mesh is not None else resolve_device(device)
    n = len(flows)
    if n == 0:
        return []
    items, table = _encode_items(flows, columns)
    n_items = len(table)
    count_1 = _counts_over(items, mesh, dev,
                           partial(_support_1, n_items=n_items))

    def decode(item_id: int) -> Tuple[str, str]:
        col, code = table[item_id]
        d = flows.dicts.get(col)
        return (col, d.decode_one(code) if d else str(code))

    out: List[Tuple[Tuple[Tuple[str, str], ...], int]] = []
    frequent_1 = np.nonzero(count_1 >= min_support)[0]
    for item in frequent_1:
        out.append(((decode(int(item)),), int(count_1[item])))
    if max_len < 2 or len(frequent_1) == 0:
        return out

    # Level 2: dense remap of frequent items. Counting is dense
    # (f^2 / p*f buffers) — exact but memory-quadratic, so refuse
    # clearly rather than OOM the device.
    f = len(frequent_1)
    if f * f > _MAX_DENSE_COUNTS:
        raise ValueError(
            f"{f} frequent items -> {f * f:,} pair counters exceeds "
            f"the dense-counting budget ({_MAX_DENSE_COUNTS:,}); "
            f"raise min_support or mine fewer columns")
    remap = np.full(n_items, -1, np.int32)
    remap[frequent_1] = np.arange(f, dtype=np.int32)
    dense = remap[items]
    count_2 = _counts_over(dense, mesh, dev, partial(_support_2, f=f))
    freq_pairs = np.nonzero(count_2 >= min_support)[0]
    for pid in freq_pairs:
        lo, hi = divmod(int(pid), f)
        out.append(((decode(int(frequent_1[lo])),
                     decode(int(frequent_1[hi]))), int(count_2[pid])))
    if max_len < 3 or len(freq_pairs) == 0:
        return out

    # Level 3: dense remap of frequent pairs.
    p = len(freq_pairs)
    if p * f > _MAX_DENSE_COUNTS:
        raise ValueError(
            f"{p} frequent pairs x {f} items -> {p * f:,} triple "
            f"counters exceeds the dense-counting budget "
            f"({_MAX_DENSE_COUNTS:,}); raise min_support")
    pair_remap = np.full(f * f, -1, np.int32)
    pair_remap[freq_pairs] = np.arange(p, dtype=np.int32)
    count_3 = _counts_over(
        dense, mesh, dev,
        partial(_support_3, p=p, f=f),
        extra=pair_remap)
    for tid in np.nonzero(count_3 >= min_support)[0]:
        pid, c = divmod(int(tid), f)
        lo, hi = divmod(int(freq_pairs[pid]), f)
        out.append(((decode(int(frequent_1[lo])),
                     decode(int(frequent_1[hi])),
                     decode(int(frequent_1[c]))), int(count_3[tid])))
    return out


def run_pattern_mining(db,
                       min_support: int = 0,
                       columns: Sequence[str] = DEFAULT_COLUMNS,
                       max_len: int = 3,
                       start_time: Optional[int] = None,
                       end_time: Optional[int] = None,
                       mining_id: Optional[str] = None,
                       mesh="auto",
                       now: Optional[int] = None,
                       progress=None,
                       device="cuda") -> str:
    """Execute a pattern-mining job over the flow store; writes one
    row per frequent itemset to the `flowpatterns` table and returns
    the mining id.

    The user-facing form of the north-star FP-Growth config — a job
    kind beside TAD/NPR (the reference has no itemset mining at all).
    min_support=0 auto-scales to 1% of the window's rows (floor 2).
    mesh="auto" shards transactions over every visible card with
    psum-allreduced support counts when `device` is a card
    (utils.device.auto_mesh); without a mesh, support counts run on
    `device`.
    """
    import time as _time
    import uuid as _uuid

    mining_id = mining_id or str(_uuid.uuid4())
    if mesh == "auto":
        mesh = auto_mesh(device)
    if mesh is None:
        resolve_device(device)

    if progress:
        progress.stage("read")
    flows = db.flows.select(start_time, end_time)
    if len(flows) == 0:
        if progress:
            progress.done()
        return mining_id
    support = int(min_support) if min_support else max(
        2, len(flows) // 100)

    if progress:
        progress.stage("mine")
    patterns = mine_frequent_patterns(
        flows, support, columns=columns, max_len=max_len, mesh=mesh,
        device=device)

    if progress:
        progress.stage("write")
    created = int(now if now is not None else _time.time())
    rows = [{
        "id": mining_id,
        "timeCreated": created,
        # column=value pairs |-joined: the same delimiter convention
        # the NPR peer strings use (reference
        # policy_recommendation_job.py peer-string protocol)
        "items": "|".join(f"{col}={val}" for col, val in itemset),
        "itemsetLength": len(itemset),
        "support": support_count,
    } for itemset, support_count in patterns]
    if rows:
        db.flowpatterns.insert_rows(rows)
    if progress:
        progress.done()
    return mining_id


def _counts_over(rows: np.ndarray, mesh, device, fn,
                 extra: Optional[np.ndarray] = None) -> np.ndarray:
    """Run a support-count function over all rows: on `device`, or
    over the mesh's first axis with the shards' counts summed in shard
    order (theia_tpu/analytics/itemsets.py:256-290: shard_map + psum;
    the later axes replicate). The counts come back as numpy."""
    def count(block: np.ndarray, dev) -> torch.Tensor:
        args = [torch.from_numpy(np.ascontiguousarray(block)).to(dev)]
        if extra is not None:
            args.append(torch.from_numpy(extra).to(dev))
        return fn(*args)

    if mesh is None:
        return count(rows, device).cpu().numpy()
    from ..parallel.mesh import psum

    n_dev = mesh.shape[mesh.axis_names[0]]
    devs = mesh.devices.reshape(n_dev, -1)[:, 0]
    pad = (-len(rows)) % n_dev
    if pad:
        # Padding rows use item id 0; subtract their contribution after.
        rows = np.concatenate(
            [rows, np.zeros((pad, rows.shape[1]), rows.dtype)])
    n_loc = len(rows) // n_dev
    counts = psum([count(rows[i * n_loc:(i + 1) * n_loc], d)
                   for i, d in enumerate(devs)])[0]
    counts = counts.cpu().numpy().copy()
    if pad:
        # Remove the padded rows' counts (they all landed on id 0's
        # buckets — recompute their exact contribution).
        pad_rows = np.zeros((pad, rows.shape[1]), rows.dtype)
        counts -= count(pad_rows, devs[0]).cpu().numpy()
    return counts
