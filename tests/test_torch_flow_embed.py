"""The spatial anomaly job's flow embedding on the job's device
(theia_tpu_torch/ops/embed.py, csrc/flow_embed.cu) and its route in
analytics/spatial.py.

The CPU cases hold the plain version bit-equal (every column compared
as uint32 bit patterns) to the numpy `flow_embeddings`, the port's and
the reference's, on seeded flows and on edge values; the wrapper's
checks; and run_spatial's embed stage: one `sad.embed` span on the
job's device, or on the mesh's first device, the rows written those
of the numpy embedding. The `cuda` cases hold the kernel bit-equal to the plain
version on the card and count its launches in a SAD job. This file
imports JAX only inside the CPU case that compares with the reference,
so on a machine without it the card cases run with
`python -m pytest --noconftest -m cuda tests/test_torch_flow_embed.py`.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from theia_tpu_torch.analytics import spatial as port_spatial
from theia_tpu_torch.data.synth import SynthConfig
from theia_tpu_torch.data.synth import generate_flows as port_generate
from theia_tpu_torch.obs import trace
from theia_tpu_torch.ops import _build, embed
from theia_tpu_torch.schema import FLOW_SCHEMA, ColumnarBatch
from theia_tpu_torch.store import FlowDatabase
from test_torch_analysis import port_lockdep_clean  # noqa: F401
from test_torch_build import STREAM, FakeEntry, fake_cuda  # noqa: F401
from test_torch_build import fake_library

#: the SAD cell's store shape: 8,192 connections × 32 records
CELL_SHAPE = (8192, 32)
#: edge values of each column as the store holds it
EDGE_CODES = (0, 1, 2 ** 31 - 1, -1, -2 ** 31)
EDGE_PORTS = (0, 65_535)
EDGE_OCTETS = (0, 1, 2 ** 53, 2 ** 53 + 1, 2 ** 63 - 1)


def _edge_columns() -> dict:
    """Every combination of the edge values, one flow each."""
    rows = list(itertools.product(EDGE_CODES, EDGE_CODES, EDGE_PORTS,
                                  EDGE_OCTETS))
    src, dst, port, octets = zip(*rows)
    return {"sourceIP": np.asarray(src, np.int32),
            "destinationIP": np.asarray(dst, np.int32),
            "destinationTransportPort": np.asarray(port, np.int32),
            "octetDeltaCount": np.asarray(octets, np.int64)}


def _synth_columns(n_series: int, seed: int) -> dict:
    """The four columns of seeded synth flows, 32 a connection."""
    flows = port_generate(SynthConfig(n_series=n_series,
                                      points_per_series=CELL_SHAPE[1],
                                      seed=seed))
    return {c: np.ascontiguousarray(flows[c])
            for c in port_spatial.SPATIAL_COLUMNS}


def _tensors(cols: dict, device="cpu") -> list:
    return [torch.from_numpy(cols[c]).to(device)
            for c in port_spatial.SPATIAL_COLUMNS]


def _bits(a) -> np.ndarray:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
    return np.ascontiguousarray(a).view(np.uint32)


# -- the plain version, without a card -----------------------------------

@pytest.mark.parametrize("case", ["synth", "edge"])
def test_plain_embedding_bit_equal_to_numpy(case):
    """The plain version against the port's numpy flow_embeddings and
    the reference's, all 7 columns as uint32 bit patterns."""
    from theia_tpu.analytics import spatial as ref_spatial
    cols = _synth_columns(512, 7) if case == "synth" else _edge_columns()
    got = embed.flow_embedding(*_tensors(cols))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (len(cols["sourceIP"]), embed.EMBED_DIM)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(port_spatial.flow_embeddings(cols)))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(ref_spatial.flow_embeddings(cols)))


def test_constants_are_the_numpy_codes():
    """The wrapper's width and the columns' dtypes are the job's: the
    embedding's EMBED_DIM and the store's host dtypes."""
    assert embed.EMBED_DIM == port_spatial.EMBED_DIM
    dtypes = {c.name: c.host_dtype for c in FLOW_SCHEMA}
    assert [torch.from_numpy(np.zeros(1, dtypes[c])).dtype
            for c in port_spatial.SPATIAL_COLUMNS] == list(embed.DTYPES)


def _refused(case: str) -> list:
    src, dst, port, octets = _tensors(_synth_columns(4, 3))
    if case == "lengths":
        return [src, dst[:-1], port, octets]
    if case == "codes_int64":
        return [src.long(), dst, port, octets]
    if case == "octets_float":
        return [src, dst, port, octets.double()]
    if case == "two_d":
        return [src.reshape(2, -1), dst.reshape(2, -1), port.reshape(2, -1),
                octets.reshape(2, -1)]
    if case == "strided":
        return [src[::2], dst[::2], port[::2], octets[::2]]
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["lengths", "codes_int64", "octets_float",
                                  "two_d", "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Mixed lengths, other dtypes, other ranks and strided columns
    raise on either device, before any launch."""
    before = _build.launches()
    with pytest.raises(ValueError, match="flow_embed"):
        embed.flow_embedding(*_refused(case))
    assert _build.launches() == before


def test_route_by_device_and_empty_input():
    assert embed.route(torch.device("cpu")) == "torch"
    assert embed.route(torch.device("cuda", 0)) == "kernel"
    with pytest.raises(ValueError, match="no route"):
        embed.route(torch.device("meta"))
    empty = [torch.zeros(0, dtype=d) for d in embed.DTYPES]
    out = embed.flow_embedding(*empty)
    assert (tuple(out.shape), out.dtype) == ((0, 7), torch.float32)


def test_kernel_call_passes_the_columns_the_length_and_the_output(
        fake_cuda, monkeypatch):
    """The launch without a card (test_torch_build's fakes): the four
    columns' pointers, n, the [n, 7] float32 output's pointer, then
    the stream; one launch counted under flow_embed."""
    cols = _tensors(_synth_columns(4, 3))
    fn = FakeEntry()
    fake_library(monkeypatch, embed._CONSTANTS, {"flow_embed": fn})
    before = _build.launches().get("flow_embed", 0)
    out = embed._embed_kernel(*cols)
    (args,) = fn.calls
    assert args == (*(c.data_ptr() for c in cols), len(cols[0]),
                    out.data_ptr(), STREAM)
    assert (tuple(out.shape), out.dtype) == ((len(cols[0]), 7),
                                             torch.float32)
    assert _build.launches()["flow_embed"] == before + 1
    assert fake_cuda == [cols[0].device]


def _one_off_rows():
    """Two recurring services and two probes (tests/test_spatial.py)."""
    rows = []
    for i in range(40):
        rows.append({"sourceIP": "10.0.0.1", "destinationIP": "10.0.1.1",
                     "destinationTransportPort": 5432,
                     "octetDeltaCount": 5000 + (i % 7) * 10})
        rows.append({"sourceIP": "10.0.0.2", "destinationIP": "10.0.1.2",
                     "destinationTransportPort": 443,
                     "octetDeltaCount": 800 + (i % 5) * 5})
    rows.append({"sourceIP": "172.16.9.9", "destinationIP": "10.0.1.1",
                 "destinationTransportPort": 22, "octetDeltaCount": 120})
    rows.append({"sourceIP": "172.16.9.9", "destinationIP": "10.0.1.2",
                 "destinationTransportPort": 3389, "octetDeltaCount": 95})
    return rows


def _numpy_outliers(flows, device="cpu"):
    """spatial_outliers over the numpy embedding, on `device`."""
    emb = torch.from_numpy(port_spatial.flow_embeddings(flows))
    return port_spatial.spatial_outliers(flows, embeddings=emb.to(device),
                                         device=device)


def _store() -> FlowDatabase:
    db = FlowDatabase()
    db.insert_flows(port_generate(SynthConfig(n_series=61,
                                              points_per_series=9,
                                              seed=17)))
    db.insert_flows(ColumnarBatch.from_rows(_one_off_rows(), FLOW_SCHEMA,
                                            db.flows.dicts))
    return db


@pytest.mark.parametrize("sharded", [False, True])
def test_run_spatial_embeds_once_on_the_job_device(sharded):
    """run_spatial's embed stage is one `sad.embed` span (route torch
    on the CPU, rows n) around the columns' copy (`sad.to_device`), on
    the job's device or, over a mesh, on its first device; the score
    stage copies nothing more. Either way the rows written are those
    of spatial_outliers over the numpy embedding, in order."""
    from theia_tpu_torch.parallel import make_mesh
    db = _store()
    flows = db.flows.select(None, None)
    want = _numpy_outliers(flows)
    assert want
    written, insert_rows = [], db.spatialnoise.insert_rows

    def write(rows):
        written.extend(rows)
        return insert_rows(rows)

    db.spatialnoise.insert_rows = write
    mesh = make_mesh(devices=[torch.device("cpu")] * 8) if sharded else None
    capture = trace.start_capture()
    try:
        port_spatial.run_spatial(db, spatial_id="s", now=3, mesh=mesh,
                                 device="cpu")
    finally:
        trace.stop_capture(capture)
    ops = [r["op"] for r in capture.records]
    embeds = [r for r in capture.records if r["op"] == "sad.embed"]
    copies = [r for r in capture.records if r["op"] == "sad.to_device"]
    (sp,) = embeds
    assert (sp["rows"], sp["route"]) == (len(flows), "torch")
    (copy,) = copies
    assert (copy["rows"], copy["parent"]) == (len(flows), "sad.embed")
    assert ops.index("sad.embed") < ops.index("dbscan.count_pass")
    assert [{k: v for k, v in r.items() if k not in ("id", "timeCreated")}
            for r in written] == want


def test_spatial_outliers_takes_device_embeddings_as_they_lie():
    """A tensor on the job's device is scored without a copy or a
    second embedding; the noise flows equal those of the numpy
    embedding."""
    flows = _store().flows.select(None, None)
    emb = port_spatial.device_embeddings(flows, "cpu")
    np.testing.assert_array_equal(_bits(emb),
                                  _bits(port_spatial.flow_embeddings(flows)))
    want = _numpy_outliers(flows)
    capture = trace.start_capture()
    try:
        got = port_spatial.spatial_outliers(flows, embeddings=emb,
                                            device="cpu")
    finally:
        trace.stop_capture(capture)
    assert got == want
    ops = [r["op"] for r in capture.records]
    assert "sad.to_device" not in ops and "sad.embed" not in ops


# -- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _differ(got: torch.Tensor, want: torch.Tensor, octets) -> str:
    """The rows whose bits differ, with their octet counts, for the
    failure message."""
    rows = (_bits(got) != _bits(want)).any(1).nonzero()[0]
    return "; ".join(f"row {i}: octets {int(octets[i])} got "
                     f"{got[i].tolist()} want {want[i].tolist()}"
                     for i in rows[:10]) + f" ({len(rows)} rows)"


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_at_the_cells_size():
    """262,144 flows of the cell's shape: the kernel, one launch,
    against the plain version and the numpy embedding."""
    dev = _card()
    cols = _synth_columns(CELL_SHAPE[0], 14)
    before = _build.launches().get("flow_embed", 0)
    got = embed.flow_embedding(*_tensors(cols, dev)).cpu()
    assert _build.launches()["flow_embed"] - before == 1
    want = embed.flow_embedding(*_tensors(cols))
    assert tuple(got.shape) == (CELL_SHAPE[0] * CELL_SHAPE[1], 7)
    assert np.array_equal(_bits(got), _bits(want)), \
        _differ(got, want, cols["octetDeltaCount"])
    assert np.array_equal(_bits(got),
                          _bits(port_spatial.flow_embeddings(cols)))


@pytest.mark.cuda
@pytest.mark.parametrize("octets", ["all_to_2_24", "sample_to_2_63"])
def test_kernel_bit_equal_on_the_log_axis(octets):
    """Every octet count in 0..2²⁴, and a seeded sample of 10⁷ up to
    2⁶³ − 1, with seeded codes: the kernel against the plain version,
    bit for bit. A difference is reported with its values."""
    dev = _card()
    rng = np.random.default_rng(19)
    if octets == "all_to_2_24":
        oct_ = np.arange(2 ** 24 + 1, dtype=np.int64)
    else:
        oct_ = rng.integers(0, 2 ** 63 - 1, size=10 ** 7, dtype=np.int64,
                            endpoint=True)
    n = len(oct_)
    cols = {"sourceIP": rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32),
            "destinationIP": rng.integers(0, 2 ** 20, n, dtype=np.int32),
            "destinationTransportPort": rng.integers(0, 65_536, n,
                                                     dtype=np.int32),
            "octetDeltaCount": oct_}
    got = embed.flow_embedding(*_tensors(cols, dev)).cpu()
    want = embed.flow_embedding(*_tensors(cols))
    assert np.array_equal(_bits(got), _bits(want)), _differ(got, want, oct_)


@pytest.mark.cuda
def test_refuses_mixed_devices_before_a_launch():
    dev = _card()
    src, dst, port, octets = _tensors(_synth_columns(4, 3), dev)
    before = _build.launches()
    with pytest.raises(ValueError, match="one device"):
        embed.flow_embedding(src, dst.cpu(), port, octets)
    assert _build.launches() == before


@pytest.mark.cuda
def test_one_device_sad_job_launches_the_kernel_once():
    """run_spatial on the card with no mesh: one flow_embed launch and
    the two points passes, and the rows of spatial_outliers over the
    numpy embedding copied to the card, in order."""
    dev = _card()
    db = _store()
    want = _numpy_outliers(db.flows.select(None, None), dev)
    assert want
    written, insert_rows = [], db.spatialnoise.insert_rows

    def write(rows):
        written.extend(rows)
        return insert_rows(rows)

    db.spatialnoise.insert_rows = write
    before = _build.launches()
    port_spatial.run_spatial(db, spatial_id="card", now=3, mesh=None,
                             device=dev)
    after = _build.launches()
    assert after.get("flow_embed", 0) - before.get("flow_embed", 0) == 1
    assert after.get("points_pairs", 0) - before.get("points_pairs", 0) == 2
    assert [{k: v for k, v in r.items() if k not in ("id", "timeCreated")}
            for r in written] == want


@pytest.mark.cuda
def test_sharded_sad_job_embeds_once_on_the_first_shard():
    """run_spatial over four logical shards of the card: one flow_embed
    launch on the mesh's first device, and the rows of the numpy
    embedding, in order."""
    from theia_tpu_torch.parallel import make_mesh
    dev = _card()
    db = _store()
    want = _numpy_outliers(db.flows.select(None, None), dev)
    assert want
    written, insert_rows = [], db.spatialnoise.insert_rows

    def write(rows):
        written.extend(rows)
        return insert_rows(rows)

    db.spatialnoise.insert_rows = write
    before = _build.launches()
    port_spatial.run_spatial(db, spatial_id="shards", now=3,
                             mesh=make_mesh(devices=[dev] * 4), device=dev)
    after = _build.launches()
    assert after.get("flow_embed", 0) - before.get("flow_embed", 0) == 1
    assert [{k: v for k, v in r.items() if k not in ("id", "timeCreated")}
            for r in written] == want
