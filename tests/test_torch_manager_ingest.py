"""Port parity for the manager slice's request half: the same
seq-stamped payloads go through `IngestManager.ingest()` of a
reference manager and of a port manager (fused engine, the card's
engine; the port on the CPU), each over its own parts store and WAL.

Held: WAL segment files byte-identical, acks equal (rows, duplicate,
alert count), store rows equal, connection alerts identical apart
from the two wall-clock stamps (`time`, `latency_s`), heavy-hitter
alerts equal in kind and destination with their floats within rtol
1e-5 (the CMS total is a float32 sum in another order than XLA's, as
in tests/test_torch_device_path.py), a re-sent seq answered
`duplicate: true`, and a forced reject raised as AdmissionRejected."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from theia_tpu.data.synth import SynthConfig, generate_flows
from theia_tpu.ingest.native import BlockEncoder
from theia_tpu.manager.admission import AdmissionRejected as RefRejected
from theia_tpu.manager.ingest import IngestManager as RefManager
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu.store import wire as ref_wire
from theia_tpu_torch.manager.admission import AdmissionRejected
from theia_tpu_torch.manager.ingest import IngestManager
from theia_tpu_torch.store import FlowDatabase

HH_RTOL = 1e-5
N_SHARDS = 2
CAPACITY = 512
#: alert keys that are wall-clock measurements, not detector output
CLOCK_KEYS = ("time", "latency_s")
HH_FLOATS = ("estimate", "share")


@pytest.fixture(autouse=True)
def _engines(monkeypatch):
    monkeypatch.setenv("THEIA_DETECTOR_ENGINE", "fused")
    monkeypatch.setenv("THEIA_STORE_ENGINE", "parts")


def _batches(n=4, n_series=120, points=4):
    return [generate_flows(SynthConfig(
        n_series=n_series, points_per_series=points,
        anomaly_fraction=0.3, seed=seed)) for seed in range(n)]


def _payloads(fmt, batches):
    """TBLK blocks (stateless) or one stream's TFB2 blocks (dictionary
    deltas against the stream's decoder)."""
    if fmt == "tblk":
        return [ref_wire.encode_block(b) for b in batches]
    enc = BlockEncoder()
    return [enc.encode(b) for b in batches]


def _open(db_cls, manager_cls, root: Path):
    db = db_cls(engine="parts", parts_dir=str(root / "parts"))
    db.attach_wal(str(root / "wal"), sync="always")
    kw = {} if manager_cls is RefManager else {"device": "cpu"}
    im = manager_cls(db, n_shards=N_SHARDS, streaming_capacity=CAPACITY,
                     **kw)
    return db, im


def _close(db, im):
    im.close()
    db.close_wal()


def _wal_files(root: Path) -> dict:
    return {p.name: p.read_bytes()
            for p in sorted((root / "wal").iterdir()) if p.is_file()}


def _store_rows(db) -> list:
    data = db.flows.scan()
    cols = sorted(data.columns)
    decoded = {c: (data.strings(c) if c in data.dicts
                   else np.asarray(data[c])) for c in cols}
    return sorted(tuple(str(decoded[c][i]) for c in cols)
                  for i in range(len(data)))


def _ack(out) -> dict:
    return {k: out[k] for k in ("rows", "alerts", "duplicate")
            if k in out}


def _assert_same_alerts(ref_ring, port_ring):
    assert len(port_ring) == len(ref_ring)
    for a, b in zip(port_ring, ref_ring):
        floats = HH_FLOATS if a["kind"] != "connection_anomaly" else ()
        strip = CLOCK_KEYS + floats
        assert {k: v for k, v in a.items() if k not in strip} == \
            {k: v for k, v in b.items() if k not in strip}
        if floats:
            np.testing.assert_allclose([a[k] for k in floats],
                                       [b[k] for k in floats],
                                       rtol=HH_RTOL)


def _run(root: Path, db_cls, manager_cls, payloads, stream="s"):
    db, im = _open(db_cls, manager_cls, root)
    try:
        acks = [_ack(im.ingest(p, stream=stream, seq=i))
                for i, p in enumerate(payloads)]
        # the producer's retry of an acknowledged batch
        acks.append(_ack(im.ingest(payloads[-1], stream=stream,
                                   seq=len(payloads) - 1)))
        ring = im.recent_alerts(10_000)
        rows = _store_rows(db)
        stats = (im.rows_ingested, im.detector_stats()["series"])
    finally:
        _close(db, im)
    return acks, ring, rows, stats, _wal_files(root)


@pytest.mark.parametrize("fmt", ["tblk", "tfb2"])
def test_ingest_matches_reference(tmp_path, fmt):
    payloads = _payloads(fmt, _batches())
    ref = _run(tmp_path / "ref", RefDatabase, RefManager, payloads)
    port = _run(tmp_path / "port", FlowDatabase, IngestManager, payloads)
    (acks_r, ring_r, rows_r, stats_r, wal_r) = ref
    (acks_p, ring_p, rows_p, stats_p, wal_p) = port
    assert acks_p == acks_r
    assert acks_p[-1]["duplicate"] is True
    assert sum(a["alerts"] for a in acks_p) > 0
    assert any(a["kind"] == "connection_anomaly" for a in ring_p)
    _assert_same_alerts(ring_r, ring_p)
    assert rows_p == rows_r
    assert stats_p == stats_r
    assert wal_p and wal_p.keys() == wal_r.keys()
    for name in wal_r:
        assert wal_p[name] == wal_r[name], f"WAL segment {name} differs"


def test_resent_seq_is_duplicate_after_restart(tmp_path):
    """The dedup window survives a restart on both: each reopens its
    own WAL, and the re-sent seq answers duplicate with the original
    row count, touching no state."""
    payloads = _payloads("tblk", _batches(n=2))
    for db_cls, manager_cls, name in (
            (RefDatabase, RefManager, "ref"),
            (FlowDatabase, IngestManager, "port")):
        root = tmp_path / name
        db, im = _open(db_cls, manager_cls, root)
        try:
            first = im.ingest(payloads[0], stream="p", seq=1)
        finally:
            _close(db, im)
        db, im = _open(db_cls, manager_cls, root)
        try:
            again = im.ingest(payloads[0], stream="p", seq=1)
            assert _ack(again) == {"rows": first["rows"], "alerts": 0,
                                   "duplicate": True}
            assert len(db.flows) == first["rows"]
            assert im.rows_ingested == 0
        finally:
            _close(db, im)


def test_forced_reject_raises_on_both(tmp_path, monkeypatch):
    monkeypatch.setenv("THEIA_ADMISSION_FORCE_LEVEL", "reject")
    payload = _payloads("tblk", _batches(n=1))[0]
    for db_cls, manager_cls, rejected, name in (
            (RefDatabase, RefManager, RefRejected, "ref"),
            (FlowDatabase, IngestManager, AdmissionRejected, "port")):
        db, im = _open(db_cls, manager_cls, tmp_path / name)
        try:
            with pytest.raises(rejected) as err:
                im.ingest(payload, stream="s", seq=1)
            assert err.value.retry_after > 0
            assert len(db.flows) == 0
        finally:
            _close(db, im)
