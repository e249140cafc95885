"""Port parity: the NPR job, theia_tpu_torch against theia_tpu, on the
CPU (device="cpu").

`distinct_rows` and `device_distinct` (device path forced on) against
the reference's jitted `distinct_rows` and its host path
(`group_reduce`): unique rows, their lexicographic order and their
counts exact. `run_npr` on the reference's FlowDatabase and the
port's, filled with the same synthetic flows: equal `recommendations`
rows, for every policy option and both job types.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theia_tpu.analytics import npr as ref_npr
from theia_tpu.analytics import npr_device as ref_dev
from theia_tpu.data.synth import SynthConfig
from theia_tpu.data.synth import generate_flows as ref_generate
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu.store.views import group_reduce
from theia_tpu_torch.analytics import npr as port_npr
from theia_tpu_torch.analytics import npr_device as port_dev
from theia_tpu_torch.data.synth import generate_flows as port_generate
from theia_tpu_torch.store import FlowDatabase
from test_torch_analysis import port_lockdep_clean  # noqa: F401


def _keys(seed, n, k=9, card=17):
    return np.random.default_rng(seed).integers(
        0, card, size=(n, k)).astype(np.int32)


def _port_distinct(keys):
    uniq, counts, n_unique = port_dev.distinct_rows(torch.from_numpy(keys))
    u = int(n_unique)
    return uniq[:u].numpy(), counts[:u].numpy()


@pytest.mark.parametrize("n,k,card", [
    (513, 9, 17), (1000, 4, 3), (64, 1, 1000), (1, 9, 5), (2, 3, 1)])
def test_distinct_rows_match_reference(n, k, card):
    keys = _keys(n, n, k, card)
    uniq, counts, n_unique = ref_dev.distinct_rows(keys)
    u = int(n_unique)
    got_u, got_c = _port_distinct(keys)
    assert len(got_u) == u
    np.testing.assert_array_equal(got_u, np.asarray(uniq[:u]))
    np.testing.assert_array_equal(got_c, np.asarray(counts[:u]))
    assert got_c.dtype == np.int32 and int(got_c.sum()) == n


def test_distinct_rows_all_unique_and_all_same():
    got_u, got_c = _port_distinct(
        np.arange(32, dtype=np.int32)[::-1].reshape(32, 1).copy())
    np.testing.assert_array_equal(got_u[:, 0], np.arange(32))
    assert (got_c == 1).all()
    got_u, got_c = _port_distinct(np.full((16, 3), 7, np.int32))
    np.testing.assert_array_equal(got_u, [[7, 7, 7]])
    np.testing.assert_array_equal(got_c, [16])


@pytest.mark.parametrize("flag", ["0", "1"])
def test_device_distinct_matches_reference_and_host_path(flag):
    keys = _keys(6, 1000, k=4, card=9).astype(np.int64)
    want_u, want_c = group_reduce(keys, np.ones((len(keys), 1), np.int64))
    ref_u, ref_c = ref_dev.device_distinct(keys, use_device=flag)
    got_u, got_c = port_dev.device_distinct(keys, use_device=flag,
                                            device="cpu")
    for u, c in ((ref_u, ref_c), (got_u, got_c)):
        assert u.dtype == c.dtype == np.int64
        np.testing.assert_array_equal(u, want_u)
        np.testing.assert_array_equal(c, want_c[:, 0])


def test_device_distinct_auto_threshold(monkeypatch):
    """auto: the device path from _AUTO_THRESHOLD rows on, the host
    path below; both equal the host result."""
    calls = []
    orig = port_dev.distinct_rows
    monkeypatch.setattr(port_dev, "distinct_rows",
                        lambda k: calls.append(len(k)) or orig(k))
    for n in (port_dev._AUTO_THRESHOLD - 1, port_dev._AUTO_THRESHOLD):
        keys = _keys(n, n, k=9, card=4).astype(np.int64)
        got_u, got_c = port_dev.device_distinct(keys, device="cpu")
        want_u, want_c = group_reduce(keys, np.ones((n, 1), np.int64))
        np.testing.assert_array_equal(got_u, want_u)
        np.testing.assert_array_equal(got_c, want_c[:, 0])
    assert calls == [port_dev._AUTO_THRESHOLD]


def test_device_distinct_empty_and_sentinel():
    u, c = port_dev.device_distinct(np.zeros((0, 9), np.int64),
                                    use_device="1", device="cpu")
    assert u.shape == (0, 9) and c.shape == (0,)
    keys = _keys(3, 10).astype(np.int64)
    keys[4, 2] = port_dev._SENTINEL
    with pytest.raises(ValueError, match="sentinel"):
        port_dev.device_distinct(keys, use_device="1", device="cpu")


def test_explicit_mesh_rows_equal_one_device():
    """An explicit 8-shard CPU mesh: device_distinct's rows and counts
    equal mesh=None's (61 rows: sentinel padding), and run_npr over it
    writes the policies of mesh=None; a mesh string other than "auto"
    is refused as the reference refuses it."""
    from theia_tpu_torch.parallel import make_mesh
    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    keys = _keys(3, 61, card=4)
    got = port_dev.device_distinct(keys, use_device="1", mesh=mesh)
    want = port_dev.device_distinct(keys, use_device="1", device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    db = FlowDatabase()
    db.insert_flows(port_generate(SynthConfig(n_series=24,
                                              points_per_series=4)))
    port_npr.run_npr(db, recommendation_id="sh", mesh=mesh)
    port_npr.run_npr(db, recommendation_id="lo", mesh=None, device="cpu")
    recs = db.recommendations.scan()
    ids = recs.strings("id")
    sh, lo = (sorted(zip(recs.filter(ids == i).strings("kind"),
                         recs.filter(ids == i).strings("policy")))
              for i in ("sh", "lo"))
    assert sh and sh == lo
    with pytest.raises(ValueError, match="THEIA_MESH"):
        port_npr.run_npr(FlowDatabase(), mesh="rows", device="cpu")


def _flows(generate, seed=3):
    """Synthetic flows, a third with NP verdicts set, and a seeded
    quarter of the rows marked trusted (the subsequent job's input)."""
    flows = generate(SynthConfig(n_series=48, points_per_series=6,
                                 protected_fraction=0.3, seed=seed))
    rng = np.random.default_rng(seed)
    flows.columns["trusted"] = (rng.random(len(flows)) < 0.25).astype(
        flows["trusted"].dtype)
    return flows


def _recommendations(db):
    return sorted(tuple(sorted(r.items()))
                  for r in db.recommendations.scan().to_rows())


@pytest.mark.parametrize("job_type", ["initial", "subsequent"])
@pytest.mark.parametrize("option", [1, 2, 3])
def test_run_npr_matches_reference(job_type, option, monkeypatch):
    import datetime
    monkeypatch.setenv("THEIA_NPR_DEVICE", "1")
    ref_db, port_db = RefDatabase(), FlowDatabase()
    ref_db.insert_flows(_flows(ref_generate))
    port_db.insert_flows(_flows(port_generate))
    now = datetime.datetime(2026, 1, 2, tzinfo=datetime.timezone.utc)
    kw = dict(recommendation_type=job_type, option=option,
              recommendation_id="npr-parity", now=now,
              to_services=option != 2)
    ref_npr.run_npr(ref_db, mesh=None, **kw)
    port_npr.run_npr(port_db, device="cpu", **kw)
    want = _recommendations(ref_db)
    assert want
    assert _recommendations(port_db) == want


def test_read_distinct_flows_match_reference():
    ref_flows, port_flows = _flows(ref_generate, 8), _flows(port_generate, 8)
    for unprotected in (True, False):
        for rm_labels in (True, False):
            want = ref_npr.read_distinct_flows(
                ref_flows, unprotected=unprotected, rm_labels=rm_labels,
                use_device="1")
            got = port_npr.read_distinct_flows(
                port_flows, unprotected=unprotected, rm_labels=rm_labels,
                use_device="1", device="cpu")
            assert want and got == want
