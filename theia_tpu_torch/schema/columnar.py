"""Columnar batch representation: struct-of-arrays with dictionary-encoded
strings.

A `ColumnarBatch` is the unit of data movement through the framework: the
ingest path produces them, the store accumulates them, and the analytics jobs
slice/stack them into device tensors. All columns are fixed-width numpy
arrays of equal length, so a batch (or any column subset of it) can be
`jax.device_put` without copies or Python-object traversal.

The reference moves rows as ClickHouse result sets / Spark DataFrames; here
the equivalent contract is "int32 codes + per-column StringDictionary"
(reference behavior: string group-bys over e.g. sourcePodLabels in
plugins/anomaly-detection/anomaly_detection.py:118-137 and
plugins/policy-recommendation/policy_recommendation_job.py map steps).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
from ..analysis.lockdep import named_lock


class StringDictionary:
    """Append-only string↔int32 dictionary.

    Code 0 is always the empty string, matching ClickHouse's String default
    and the reference's pervasive `== ''` predicates (e.g. the unprotected
    flow filter in policy_recommendation_job.py:785-802).
    """

    __slots__ = ("_to_code", "_strings", "_lock")

    def __init__(self) -> None:
        self._to_code: Dict[str, int] = {"": 0}
        self._strings: List[str] = [""]
        self._lock = named_lock("schema.dict")

    def __len__(self) -> int:
        return len(self._strings)

    def encode_one(self, s: str) -> int:
        # Reads are lock-free (append-only tables); allocation of a new
        # code is locked so concurrent encoders can't mint two codes for
        # the same string (the tables share these dictionaries across
        # insert threads).
        code = self._to_code.get(s)
        if code is None:
            with self._lock:
                code = self._to_code.get(s)
                if code is None:
                    code = len(self._strings)
                    self._strings.append(s)
                    self._to_code[s] = code
        return code

    def encode(self, values: Sequence[str]) -> np.ndarray:
        """Vectorized encode: dedupe first so the Python loop only touches
        unique values (cheap for the low-cardinality k8s-identity columns)."""
        arr = np.asarray(values, dtype=object)
        uniques, inverse = np.unique(arr, return_inverse=True)
        codes_for_uniques = np.fromiter(
            (self.encode_one(u) for u in uniques), dtype=np.int32,
            count=len(uniques))
        return codes_for_uniques[inverse].astype(np.int32)

    def decode_one(self, code: int) -> str:
        return self._strings[int(code)]

    def decode(self, codes: np.ndarray) -> np.ndarray:
        table = np.asarray(self._strings, dtype=object)
        return table[np.asarray(codes, dtype=np.int64)]

    def lookup(self, s: str) -> Optional[int]:
        """Code for `s` if present, else None (never allocates)."""
        return self._to_code.get(s)

    def entries_since(self, start: int) -> List[str]:
        """Snapshot of entries [start:), in code order — for replaying
        deltas into a peer dictionary (native decoder, wire blocks)."""
        with self._lock:
            return list(self._strings[start:])

    def copy(self) -> "StringDictionary":
        """Independent copy (same codes for existing strings)."""
        out = StringDictionary()
        with self._lock:
            out._strings = list(self._strings)
            out._to_code = dict(self._to_code)
        return out


class DictionaryMapper:
    """Cached int32 code remap from source dictionaries onto one
    destination dictionary.

    The hot-path alternative to re-encoding strings row-by-row: per
    source dictionary, keep an int32 array mapping its codes to the
    destination's, extended only for entries minted since the last
    call — amortized O(new dictionary entries), zero string work for
    a steady population. Entries hold a strong reference to their
    source dictionary so an id() can never be recycled while its
    mapping is cached; a bounded LRU evicts mappings orphaned by
    producer resets. NOT thread-safe: callers serialize (the ingest
    detector lock, the table adoption lock).
    """

    def __init__(self, dst: StringDictionary,
                 max_entries: int = 128) -> None:
        self.dst = dst
        self.max_entries = max_entries
        self._maps: Dict[int, tuple] = {}   # id(src) → (src, mapping)

    def mapping(self, src: StringDictionary) -> np.ndarray:
        entry = self._maps.pop(id(src), None)
        if entry is None or entry[0] is not src:
            if len(self._maps) >= self.max_entries:
                # Every lookup re-inserts its key (pop above + insert
                # below), so insertion order IS recency order: the
                # front of the dict holds the coldest entries.
                for stale in list(self._maps)[:self.max_entries // 2]:
                    del self._maps[stale]
            entry = (src, np.zeros(0, np.int32))
        src_ref, mapping = entry
        if len(mapping) < len(src):
            new = np.fromiter(
                (self.dst.encode_one(s)
                 for s in src.entries_since(len(mapping))),
                dtype=np.int32)
            mapping = np.concatenate([mapping, new])
        self._maps[id(src)] = (src_ref, mapping)
        return mapping

    def remap(self, codes: np.ndarray,
              src: StringDictionary) -> np.ndarray:
        if src is self.dst:
            return np.asarray(codes, np.int32)
        return self.mapping(src)[np.asarray(codes, np.int64)]


class ColumnarBatch:
    """Equal-length struct-of-arrays with an associated dictionary set.

    `dicts` maps string-column name → StringDictionary used to encode that
    column. Dictionaries are shared by reference (typically owned by the
    FlowStore) so codes are comparable across batches.
    """

    def __init__(self, columns: Mapping[str, np.ndarray],
                 dicts: Optional[Mapping[str, StringDictionary]] = None):
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: lengths {sorted(lengths)}")
        self.columns: Dict[str, np.ndarray] = dict(columns)
        self.dicts: Dict[str, StringDictionary] = dict(dicts or {})

    def __len__(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    @property
    def column_names(self) -> Iterable[str]:
        return self.columns.keys()

    def strings(self, name: str) -> np.ndarray:
        """Decode a dictionary-encoded column back to python strings."""
        return self.dicts[name].decode(self.columns[name])

    def take(self, indices: np.ndarray) -> "ColumnarBatch":
        return ColumnarBatch(
            {k: v[indices] for k, v in self.columns.items()}, self.dicts)

    def filter(self, mask: np.ndarray) -> "ColumnarBatch":
        return ColumnarBatch(
            {k: v[mask] for k, v in self.columns.items()}, self.dicts)

    def select(self, names: Sequence[str]) -> "ColumnarBatch":
        return ColumnarBatch({n: self.columns[n] for n in names},
                             {n: d for n, d in self.dicts.items()
                              if n in names})

    def column_selector(self, mask: np.ndarray, dtype=np.int64):
        """Narrow-column masked materializer: `col(name)` returns one
        column under `mask`, skipping the copy when the mask is all-true.
        The query paths use this instead of `filter(mask)` because
        masking all 52 columns costs more than the kernel the handful of
        surviving columns feed."""
        full = bool(mask.all())

        def col(name: str) -> np.ndarray:
            arr = np.asarray(self.columns[name], dtype)
            return arr if full else arr[mask]

        return col

    @staticmethod
    def concat(batches: Sequence["ColumnarBatch"]) -> "ColumnarBatch":
        """Concatenate batches. String columns encoded with *different*
        dictionaries are re-encoded against a merged dictionary (codes are
        only comparable when the dictionary object is shared)."""
        if not batches:
            return ColumnarBatch({})
        names = list(batches[0].column_names)
        dicts: Dict[str, StringDictionary] = {}
        cols: Dict[str, np.ndarray] = {}
        for n in names:
            parts = [b[n] for b in batches]
            col_dicts = [b.dicts.get(n) for b in batches]
            present = [d for d in col_dicts if d is not None]
            if present and any(d is not present[0] for d in present):
                # Mixed dictionaries: remap every batch's codes into a
                # fresh copy of the first batch's dictionary (codes it
                # already issued stay stable; the originals — possibly
                # store-owned — are left unmutated).
                merged = present[0].copy()
                remapped = []
                for part, d in zip(parts, col_dicts):
                    if d is None or d is merged:
                        remapped.append(part)
                        continue
                    mapping = np.fromiter(
                        (merged.encode_one(s) for s in d._strings),
                        dtype=np.int32, count=len(d))
                    remapped.append(mapping[np.asarray(part, np.int64)])
                parts = remapped
                dicts[n] = merged
            elif present:
                dicts[n] = present[0]
            cols[n] = np.concatenate(parts)
        return ColumnarBatch(cols, dicts)

    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, object]], schema,
                  dicts: Optional[Mapping[str, StringDictionary]] = None
                  ) -> "ColumnarBatch":
        """Build a batch from row dicts against a schema (tuple of Column).

        Missing values take the column default (0 / empty string)."""
        dicts = dict(dicts or {})
        cols: Dict[str, np.ndarray] = {}
        for col in schema:
            if col.is_string:
                d = dicts.setdefault(col.name, StringDictionary())
                values = [str(r.get(col.name, "")) for r in rows]
                cols[col.name] = d.encode(values) if rows else np.zeros(
                    0, np.int32)
            else:
                cols[col.name] = np.asarray(
                    [r.get(col.name, 0) for r in rows], dtype=col.host_dtype)
        return ColumnarBatch(cols, dicts)

    def to_rows(self, schema=None) -> List[Dict[str, object]]:
        """Materialize python row dicts (decoding strings). Test/CLI helper —
        not a hot path."""
        names = list(self.column_names)
        decoded = {
            n: (self.strings(n) if n in self.dicts else self.columns[n])
            for n in names}
        out = []
        for i in range(len(self)):
            out.append({n: (decoded[n][i].item()
                            if isinstance(decoded[n][i], np.generic)
                            else decoded[n][i]) for n in names})
        return out
