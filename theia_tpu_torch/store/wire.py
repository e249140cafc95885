"""TBLK columnar block wire format — the one shared column-walk codec.

A TBLK block is the column section of a WAL record body promoted to a
first-class producer wire format: producers
encode once, and the same bytes then ride every hop of the ingest path
without re-materialization — admission charges rows/bytes from the
header without decoding (`peek_counts`), the cluster router re-slices
cross-node forwards by column gather on the encoded bytes
(`gather_parts`), the WAL journals the received column bytes verbatim
(`wal.append(..., wire=...)`), and decode happens exactly once, at the
node that owns the rows.

Layout (all little-endian)::

    block    := "TBLK" columns
    columns  := u32 n_rows  u16 n_cols  col*
    col      := u16 name_len  name_utf8  u8 kind  body
    kind 0 (numeric):
        u16 dtype_len  dtype_str  u16 stored_len  stored_str
        i64 base  u32 nbytes  stored_bytes
        (stored = width-reduced (value - base), see `width_reduce`)
    kind 1 (dictionary string):
        u32 n_uniq  u32 blob_len  u8 code_size
        i32 lens[n_uniq]  utf8_blob  codes[n_rows]  (u1/u2/i4)

``columns`` is byte-for-byte the tail of a WAL record body
(`wal.encode_record_parts` = table-name header + ``columns``) and of a
part file's record section (store/parts.py) — which is the point:
one codec, one skip-walk, no forked framing logic. Unlike the TFB2
stream format (ingest/native.py), a block is fully self-contained —
string columns carry their batch-unique strings, so decode is
STATELESS: no per-stream dictionary delta chain, no decode
serialization, shard-parallel by construction.

Fault sites: ``wire.decode`` fires on every block/record decode,
``wire.gather`` on every router column-gather — both registered in
utils/faults.KNOWN_SITES for drills.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..schema.columnar import ColumnarBatch, StringDictionary
from ..utils.faults import FaultError
from ..utils.faults import fire as _fire_fault

#: wire magic for one self-contained columnar block sent as an ingest
#: payload: ``BLOCK_MAGIC + encode_columns_body(batch)``
BLOCK_MAGIC = b"TBLK"

_HDR = struct.Struct("<IH")          # n_rows, n_cols
_CODE_DTYPES = {1: "<u1", 2: "<u2", 4: "<i4"}


class WireCorruption(ValueError):
    """A columnar block failed structural validation (bad framing,
    impossible lengths, truncation). ValueError so HTTP handlers map
    it to 400 without a dedicated ladder rung."""


def _byteview(arr: np.ndarray) -> memoryview:
    """Flat byte view of a C-contiguous array — zero-copy: appenders
    checksum and write column buffers in place instead of
    materializing a second copy of the whole batch."""
    return memoryview(np.ascontiguousarray(arr)).cast("B")


def width_reduce(a: np.ndarray) -> Tuple[np.ndarray, int]:
    """(stored, base): the narrowest unsigned representation of
    (a - min). Ports and flags are int64 in the schema but fit a byte,
    and per-batch timestamps cluster within seconds of each other —
    the ~3x byte cut behind the WAL record format, the part storage
    format (store/parts.py), and TBLK blocks. Returns (a, 0) unchanged
    when no narrower type holds the span."""
    if a.dtype.kind in "iu" and a.itemsize > 1 and len(a):
        mn, mx = int(a.min()), int(a.max())
        span = mx - mn
        for cand in ("<u1", "<u2", "<u4"):
            cdt = np.dtype(cand)
            if cdt.itemsize >= a.itemsize:
                break
            if span <= int(np.iinfo(cdt).max):
                return (a - mn).astype(cand), mn
    return a, 0


# -- encode ---------------------------------------------------------------

def encode_columns_parts(batch: ColumnarBatch) -> List[memoryview]:
    """Serialize a batch's columns into the ``columns`` section, as a
    list of buffers (small header bytes + zero-copy column views) —
    the WAL appender checksums and writes them without concatenating.

    String columns (those with a dictionary on the batch) ship their
    batch-unique strings + local codes, so decode never depends on
    receiver dictionary state; numeric columns ship width-reduced
    little-endian bytes."""
    parts: List = [_HDR.pack(len(batch), len(batch.columns))]
    for name, arr in batch.columns.items():
        bname = name.encode("utf-8")
        d = batch.dicts.get(name)
        if d is not None:
            codes = np.ascontiguousarray(arr)
            # O(n + dict) unique via occupancy mask (codes are dense
            # dictionary indices) — ~10x cheaper than sort-based
            # np.unique on large batches
            mask = np.zeros(len(d), bool)
            mask[codes] = True
            uniq = np.flatnonzero(mask)
            code_dt = ("<u1" if len(uniq) <= 0xFF
                       else "<u2" if len(uniq) <= 0xFFFF else "<i4")
            remap = (np.cumsum(mask, dtype=np.int32) - 1).astype(
                code_dt)
            local = np.ascontiguousarray(remap[codes])
            encoded = [str(s).encode("utf-8") for s in d.decode(uniq)]
            lens = np.fromiter(map(len, encoded), "<i4",
                               count=len(encoded))
            blob = b"".join(encoded)
            parts.append(struct.pack("<H", len(bname)) + bname
                         + struct.pack("<BIIB", 1, len(uniq),
                                       len(blob), local.itemsize))
            parts.append(_byteview(lens))
            parts.append(blob)
            parts.append(_byteview(local))
        else:
            a = np.ascontiguousarray(arr)
            if a.dtype.byteorder == ">":
                a = a.astype(a.dtype.newbyteorder("<"))
            dt = a.dtype.str.encode("ascii")
            stored, base = width_reduce(a)
            sdt = stored.dtype.str.encode("ascii")
            parts.append(struct.pack("<H", len(bname)) + bname
                         + struct.pack("<BH", 0, len(dt)) + dt
                         + struct.pack("<H", len(sdt)) + sdt
                         + struct.pack("<qI", base, stored.nbytes))
            parts.append(_byteview(stored))
    return parts


def encode_columns_body(batch: ColumnarBatch) -> bytes:
    """One contiguous ``columns`` section."""
    return b"".join(bytes(p) for p in encode_columns_parts(batch))


def encode_block(batch: ColumnarBatch) -> bytes:
    """A complete TBLK ingest payload for `batch` (producer side)."""
    return BLOCK_MAGIC + encode_columns_body(batch)


# -- header peek (admission) ----------------------------------------------

def peek_counts(buf, offset: int = 0) -> Tuple[int, int]:
    """(n_rows, n_cols) from a ``columns`` header at `offset`, WITHOUT
    decoding — the admission controller charges row tokens from this
    before any column work happens. Every encoded cell costs at least
    one byte (u1 planes / u1 codes), so a header whose row x col
    product exceeds the remaining payload is structurally impossible
    and raises: a 40-byte payload cannot claim 4B rows to drain the
    row bucket or park a huge allocation downstream."""
    mv = memoryview(buf)
    if len(mv) - offset < _HDR.size:
        raise WireCorruption("columnar block shorter than its header")
    n_rows, n_cols = _HDR.unpack_from(mv, offset)
    if n_rows * max(n_cols, 1) > len(mv) - offset:
        raise WireCorruption(
            f"block header claims {n_rows} rows x {n_cols} cols in "
            f"{len(mv) - offset} payload bytes")
    return n_rows, n_cols


# -- decode (the ONE column walk) -----------------------------------------

def decode_columns(buf, offset: int = 0,
                   columns: Optional[frozenset] = None
                   ) -> Tuple[ColumnarBatch, int]:
    """Inverse of `encode_columns_parts`: (batch with fresh per-block
    dictionaries, end offset). Raises WireCorruption on structural
    damage; the caller decides whether to drop or abort — and checks
    the end offset against its framing (trailing bytes are the
    CALLER's corruption, this walk only owns the column section).

    `columns` restricts decoding to that column subset: the byte
    ranges of every other column are SKIPPED — no array construction,
    no string decode — which is what makes a cold part file cheap to
    query when the plan touches 4 of the 52 columns, and a router
    forward cheap when it only needs destinationIP. Framing is still
    fully walked, so a truncated/corrupt block raises either way."""
    try:
        return _decode_columns(buf, offset, columns)
    except (WireCorruption, FaultError):
        # injected faults surface as themselves: a drill must observe
        # WHICH site fired, not a corruption it didn't inject
        raise
    except Exception as e:
        raise WireCorruption(f"undecodable columnar block: {e}")


def _decode_columns(buf, offset: int,
                    columns: Optional[frozenset]
                    ) -> Tuple[ColumnarBatch, int]:
    _fire_fault("wire.decode")
    mv = memoryview(buf)
    n_rows, n_cols = _HDR.unpack_from(mv, offset)
    off = offset + _HDR.size
    cols: Dict[str, np.ndarray] = {}
    dicts: Dict[str, StringDictionary] = {}
    for _ in range(n_cols):
        (nlen,) = struct.unpack_from("<H", mv, off)
        off += 2
        name = bytes(mv[off:off + nlen]).decode("utf-8")
        off += nlen
        (kind,) = struct.unpack_from("<B", mv, off)
        off += 1
        wanted = columns is None or name in columns
        if kind == 1:
            n_uniq, blob_len, code_size = struct.unpack_from(
                "<IIB", mv, off)
            off += 9
            code_dt = _CODE_DTYPES.get(code_size)
            if code_dt is None:
                raise WireCorruption(
                    f"bad string code itemsize {code_size}")
            if not wanted:
                off += 4 * n_uniq + blob_len + code_size * n_rows
                continue
            lens = np.frombuffer(mv, "<i4", count=n_uniq, offset=off)
            off += 4 * n_uniq
            blob = bytes(mv[off:off + blob_len])
            off += blob_len
            d = StringDictionary()
            mapping = np.empty(max(n_uniq, 1), np.int32)
            pos = 0
            for i in range(n_uniq):
                end = pos + int(lens[i])
                mapping[i] = d.encode_one(blob[pos:end].decode("utf-8"))
                pos = end
            if pos != blob_len:
                raise WireCorruption("string blob length mismatch")
            local = np.frombuffer(mv, code_dt, count=n_rows,
                                  offset=off).astype(np.int64)
            off += code_size * n_rows
            cols[name] = (mapping[:n_uniq][local] if n_uniq
                          else np.zeros(n_rows, np.int32))
            dicts[name] = d
        elif kind == 0:
            (dlen,) = struct.unpack_from("<H", mv, off)
            off += 2
            dtype = np.dtype(bytes(mv[off:off + dlen]).decode("ascii"))
            off += dlen
            (slen,) = struct.unpack_from("<H", mv, off)
            off += 2
            stored_dt = np.dtype(
                bytes(mv[off:off + slen]).decode("ascii"))
            off += slen
            base, rlen = struct.unpack_from("<qI", mv, off)
            off += 12
            if not wanted:
                off += rlen
                continue
            arr = np.frombuffer(mv, stored_dt, count=n_rows,
                                offset=off)
            arr = arr.astype(dtype) if stored_dt != dtype \
                else arr.copy()
            if base:
                arr += dtype.type(base)
            off += rlen
            cols[name] = arr
        else:
            raise WireCorruption(f"unknown column kind {kind}")
    if off > len(mv):
        raise WireCorruption("columnar block truncated")
    return ColumnarBatch(cols, dicts), off


def decode_block(payload,
                 columns: Optional[frozenset] = None) -> ColumnarBatch:
    """Decode one complete TBLK ingest payload (magic + columns),
    rejecting trailing garbage. Stateless — any thread, any shard, no
    stream slot required."""
    mv = memoryview(payload)
    if bytes(mv[:4]) != BLOCK_MAGIC:
        raise WireCorruption("not a TBLK block")
    batch, end = decode_columns(mv, 4, columns)
    if end != len(mv):
        raise WireCorruption(
            f"block has {len(mv) - end} trailing bytes")
    return batch


# -- column gather (router re-slice, no decode) ---------------------------

def gather_parts(buf, indices, offset: int = 0
                 ) -> Tuple[List, int]:
    """Re-slice an encoded ``columns`` section to `indices` WITHOUT
    decoding: numeric columns gather their width-reduced stored bytes
    (base and dtypes ride verbatim), string columns gather their local
    codes while the unique-string table ships verbatim (a superset of
    what the slice references — codes stay valid, decode is
    unaffected). Returns (buffer list forming a complete ``columns``
    section of len(indices) rows, end offset of the source walk).

    This is the router's cross-node forward path: slicing a 52-column
    batch for a peer costs ~n_cols fancy-indexes over flat bytes
    instead of a full decode → take → re-encode round trip."""
    try:
        return _gather_parts(buf, indices, offset)
    except (WireCorruption, FaultError):
        raise
    except Exception as e:
        raise WireCorruption(f"ungatherable columnar block: {e}")


def _gather_parts(buf, indices, offset: int) -> Tuple[List, int]:
    _fire_fault("wire.gather")
    mv = memoryview(buf)
    n_rows, n_cols = _HDR.unpack_from(mv, offset)
    idx = np.asarray(indices, np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= n_rows):
        raise WireCorruption(
            f"gather indices out of range for {n_rows} rows")
    parts: List = [_HDR.pack(len(idx), n_cols)]
    off = offset + _HDR.size
    for _ in range(n_cols):
        col_start = off
        (nlen,) = struct.unpack_from("<H", mv, off)
        off += 2 + nlen
        (kind,) = struct.unpack_from("<B", mv, off)
        off += 1
        if kind == 1:
            n_uniq, blob_len, code_size = struct.unpack_from(
                "<IIB", mv, off)
            off += 9
            code_dt = _CODE_DTYPES.get(code_size)
            if code_dt is None:
                raise WireCorruption(
                    f"bad string code itemsize {code_size}")
            off += 4 * n_uniq + blob_len
            codes = np.frombuffer(mv, code_dt, count=n_rows,
                                  offset=off)
            off += code_size * n_rows
            # header + lens + blob verbatim; only the codes re-slice
            parts.append(mv[col_start:off - code_size * n_rows])
            parts.append(_byteview(codes[idx]))
        elif kind == 0:
            (dlen,) = struct.unpack_from("<H", mv, off)
            off += 2 + dlen
            (slen,) = struct.unpack_from("<H", mv, off)
            stored_dt = np.dtype(
                bytes(mv[off + 2:off + 2 + slen]).decode("ascii"))
            off += 2 + slen
            base, rlen = struct.unpack_from("<qI", mv, off)
            head_end = off
            off += 12
            stored = np.frombuffer(mv, stored_dt, count=n_rows,
                                   offset=off)
            off += rlen
            parts.append(mv[col_start:head_end])
            parts.append(struct.pack(
                "<qI", base, stored_dt.itemsize * len(idx)))
            parts.append(_byteview(stored[idx]))
        else:
            raise WireCorruption(f"unknown column kind {kind}")
    if off > len(mv):
        raise WireCorruption("columnar block truncated")
    return parts, off
