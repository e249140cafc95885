"""Port parity: the multi-device job paths, theia_tpu_torch.parallel
against theia_tpu.parallel, on the CPU.

The reference runs on the 8 virtual CPU devices tests/conftest.py
provides; the port runs on an 8-shard mesh that lists the CPU eight
times (one controller, logical shards: parallel/mesh.py). Each case
of tests/test_parallel.py compares the reference's sharded function
with the port's, and the port's sharded result with its own
one-device result.

Tolerances: series-sharded rows (EWMA, ARIMA, DBSCAN), NPR policies,
DISTINCT rows and counts, itemset counts and SAD flags are exact
against the port's one-device path (the same per-series or per-pair
code). Against the reference they carry the one-device port's own
limits (ARIMA algoCalc rtol 1e-9, tests/test_torch_arima.py; stddev
rtol 2e-15, tests/test_torch_tad.py). The time-sharded EWMA runs the
reference's block scan and shard composition, but not its
`associative_scan` tree op for op inside XLA, and its stddev is a
psum of partial sums: it is held to TIME_RTOL, against both the
reference's sharded output and the port's local path, with flags
equal (the data keeps every point off the threshold).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theia_tpu import parallel as ref_par
from theia_tpu.analytics import npr_device as ref_dev
from theia_tpu.analytics import itemsets as ref_its
from theia_tpu.analytics import tad as ref_tad
from theia_tpu_torch import parallel as port_par
from theia_tpu_torch.analytics import itemsets as port_its
from theia_tpu_torch.analytics import npr_device as port_dev
from theia_tpu_torch.analytics import tad as port_tad
from theia_tpu_torch.ops import _build
from theia_tpu_torch.ops import dbscan as port_dbscan
from theia_tpu_torch.ops.arima import arima_scores as port_arima
from theia_tpu_torch.ops.ewma import ewma_scores as port_ewma
from theia_tpu_torch.parallel import engine as port_engine
from test_torch_analysis import port_lockdep_clean  # noqa: F401

CPU8 = [torch.device("cpu")] * 8
#: the time-sharded EWMA (float64), against the reference's sharded
#: output and the port's local scan
TIME_RTOL = 1e-12
STD_RTOL = 2e-15
ARIMA_RTOL = 1e-9


def cpu_mesh(time_shards=1):
    return port_par.make_mesh(devices=CPU8, time_shards=time_shards)


def _batch(rng, S=16, T=24):
    x = rng.uniform(1e5, 1e7, size=(S, T))
    mask = np.ones((S, T), bool)
    # make some series ragged
    mask[S // 4, (3 * T) // 4:] = False
    mask[S - 1, T // 4:] = False
    x[~mask] = 0.0
    return x, mask


def _port_local(fn, x, mask, **kw):
    out = fn(torch.from_numpy(x), torch.from_numpy(mask), **kw)
    return [o.numpy() for o in out]


def test_series_dp_matches_reference(eight_devices, rng):
    x, mask = _batch(rng)
    ref_mesh = ref_par.make_mesh(8, time_shards=1)
    r_e, r_std, r_anom, r_count = ref_par.make_sharded_ewma(ref_mesh)(
        *ref_par.shard_arrays(ref_mesh, x, mask))
    mesh = cpu_mesh()
    e, std, anom, count = port_par.make_sharded_ewma(mesh)(
        *port_par.shard_arrays(mesh, x, mask))
    # series data parallelism runs the one-device scan per slab
    l_e, l_std, l_anom = _port_local(port_ewma, x, mask)
    np.testing.assert_array_equal(e.numpy(), l_e)
    np.testing.assert_array_equal(anom.numpy(), l_anom)
    np.testing.assert_array_equal(std.numpy(), l_std)
    np.testing.assert_array_equal(e.numpy(), np.asarray(r_e))
    np.testing.assert_allclose(std.numpy(), np.asarray(r_std),
                               rtol=STD_RTOL)
    np.testing.assert_array_equal(anom.numpy(), np.asarray(r_anom))
    assert int(count) == int(r_count) == int(l_anom.sum())


@pytest.mark.parametrize("time_shards,S,T", [(2, 8, 32), (4, 4, 64),
                                             (8, 3, 40)])
def test_time_sharded_scan_matches_reference(eight_devices, rng,
                                             time_shards, S, T):
    """4x2 and 2x4 as tests/test_parallel.py, and 1x8 with padding:
    the cross-shard composition reproduces the recurrence."""
    x, mask = _batch(rng, S=S, T=T)
    mesh = cpu_mesh(time_shards)
    pad_s = -S % mesh.shape["series"]
    xp = np.pad(x, ((0, pad_s), (0, 0)))
    mp = np.pad(mask, ((0, pad_s), (0, 0)))
    e, std, anom, count = port_par.make_sharded_ewma(mesh)(
        *port_par.shard_arrays(mesh, xp, mp))
    e, std, anom = e.numpy()[:S], std.numpy()[:S], anom.numpy()[:S]
    ref_mesh = ref_par.make_mesh(8, time_shards=time_shards)
    r_e, r_std, r_anom, r_count = ref_par.make_sharded_ewma(ref_mesh)(
        *ref_par.shard_arrays(ref_mesh, xp, mp))
    np.testing.assert_allclose(e, np.asarray(r_e)[:S], rtol=TIME_RTOL)
    np.testing.assert_allclose(std, np.asarray(r_std)[:S],
                               rtol=TIME_RTOL)
    np.testing.assert_array_equal(anom, np.asarray(r_anom)[:S])
    assert int(count) == int(r_count)
    l_e, l_std, l_anom = _port_local(port_ewma, x, mask)
    np.testing.assert_allclose(e, l_e, rtol=TIME_RTOL)
    np.testing.assert_allclose(std, l_std, rtol=TIME_RTOL)
    np.testing.assert_array_equal(anom, l_anom)


def test_pad_to_multiple():
    arr = np.ones((5, 3))
    padded, orig = port_par.pad_to_multiple(arr, 4, axis=0)
    assert padded.shape == (8, 3) and orig == 5
    assert padded[5:].sum() == 0
    keys = np.arange(21, dtype=np.int32).reshape(7, 3)
    for axis, fill in ((0, 9), (1, -1)):
        got = port_par.pad_to_multiple(keys, 4, axis=axis, fill=fill)
        want = ref_par.pad_to_multiple(keys, 4, axis=axis, fill=fill)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_sharded_arima_matches_reference(eight_devices, rng):
    S, T = 16, 24
    x = np.maximum(
        1e6 + 1e5 * rng.standard_normal((S, T)).cumsum(axis=1), 1e3)
    x[2, 20] *= 30.0
    mask = np.ones((S, T), bool)
    mask[5, 18:] = False
    mesh = cpu_mesh()
    calc, std, anom = port_par.make_sharded_arima(mesh, refit_every=1)(
        *port_par.shard_arrays(mesh, x, mask))
    l_calc, l_std, l_anom = _port_local(port_arima, x, mask,
                                        refit_every=1)
    np.testing.assert_array_equal(calc.numpy(), l_calc)
    np.testing.assert_array_equal(std.numpy(), l_std)
    np.testing.assert_array_equal(anom.numpy(), l_anom)
    ref_mesh = ref_par.make_mesh(8, time_shards=1)
    r_calc, r_std, r_anom = ref_par.make_sharded_arima(
        ref_mesh, refit_every=1)(*ref_par.shard_arrays(ref_mesh, x, mask))
    np.testing.assert_allclose(calc.numpy(), np.asarray(r_calc),
                               rtol=ARIMA_RTOL)
    np.testing.assert_array_equal(anom.numpy(), np.asarray(r_anom))
    assert anom.numpy()[2, 20]


def test_sharded_dbscan_matches_reference(eight_devices, rng):
    x = rng.uniform(1e6, 2e8, size=(8, 16))
    x[1, 3] = 9e9   # isolated outlier
    mask = np.ones(x.shape, bool)
    mesh = cpu_mesh()
    calc, std, anom = port_par.make_sharded_dbscan(
        mesh, eps=2.5e8, min_samples=4)(
        *port_par.shard_arrays(mesh, x, mask))
    _, l_std, l_anom = _port_local(port_dbscan.dbscan_scores, x, mask)
    np.testing.assert_array_equal(anom.numpy(), l_anom)
    np.testing.assert_array_equal(std.numpy(), l_std)
    ref_mesh = ref_par.make_mesh(8, time_shards=1)
    _, r_std, r_anom = ref_par.make_sharded_dbscan(
        ref_mesh, eps=2.5e8, min_samples=4)(
        *ref_par.shard_arrays(ref_mesh, x, mask))
    np.testing.assert_array_equal(anom.numpy(), np.asarray(r_anom))
    np.testing.assert_allclose(std.numpy(), np.asarray(r_std),
                               rtol=STD_RTOL)
    assert anom.numpy()[1, 3] and not calc.numpy().any()


@pytest.mark.parametrize("n,block", [(64, 16), (61, 8)])
def test_sharded_points_dbscan_matches_tiled(eight_devices, rng, n,
                                             block):
    """The port's sharded passes against its one-device tiled pass and
    against the reference's sharded (untiled) body: equal flags."""
    pts = rng.normal(0, 1, size=(n, 5)).astype(np.float32)
    pts[7] += 25.0
    valid = np.ones(n, bool)
    valid[-3:] = False
    pts_p, _ = port_par.pad_to_multiple(pts, 8, axis=0)
    valid_p, _ = port_par.pad_to_multiple(valid, 8, axis=0)
    mesh = port_par.make_rows_mesh(devices=CPU8)
    got = port_par.make_sharded_points_dbscan(mesh, eps=1.2,
                                              block=block)(pts_p, valid_p)
    tiled = port_dbscan.dbscan_points_noise(
        torch.from_numpy(pts_p), torch.from_numpy(valid_p), eps=1.2,
        block=block)
    np.testing.assert_array_equal(got.numpy(), tiled.numpy())
    ref = ref_par.make_sharded_points_dbscan(
        ref_par.make_rows_mesh(8), eps=1.2)(pts_p, valid_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[7] and not got[n - 1]


def test_points_passes_keep_the_one_device_flags(rng):
    """dbscan_points_noise, now its count and reach passes, gives the
    flags of the reference's tiled scan."""
    from theia_tpu.ops.dbscan import dbscan_points_noise as ref_points
    pts = rng.normal(0, 1, size=(300, 7)).astype(np.float32)
    valid = np.ones(300, bool)
    valid[::17] = False
    got = port_dbscan.dbscan_points_noise(
        torch.from_numpy(pts), torch.from_numpy(valid), eps=0.9,
        block=64)
    want = ref_points(pts, valid, eps=0.9, block=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_score_series_mesh_pads_and_slices(eight_devices, rng):
    # S not divisible by the mesh: padding must not leak phantom rows.
    S, T = 11, 13
    x = rng.uniform(1e5, 1e7, size=(S, T))
    mask = np.ones((S, T), bool)
    c_sh, s_sh, a_sh = port_tad.score_series(x, mask, "EWMA",
                                             mesh=cpu_mesh())
    c_lo, s_lo, a_lo = port_tad.score_series(x, mask, "EWMA",
                                             device="cpu")
    assert c_sh.shape == (S, T) and s_sh.shape == (S,)
    np.testing.assert_array_equal(c_sh, c_lo)
    np.testing.assert_array_equal(a_sh, a_lo)
    c_ref, s_ref, a_ref = ref_tad.score_series(
        x, mask, "EWMA", mesh=ref_par.make_mesh(8, time_shards=1))
    np.testing.assert_array_equal(c_sh, c_ref)
    np.testing.assert_allclose(s_sh, s_ref, rtol=STD_RTOL)
    np.testing.assert_array_equal(a_sh, a_ref)
    # fewer series than shards: one device, the mesh's (the default
    # device="cuda" is not read)
    c5, _, a5 = port_tad.score_series(x[:5], mask[:5], "DBSCAN",
                                      mesh=cpu_mesh())
    c5_lo, _, a5_lo = port_tad.score_series(x[:5], mask[:5], "DBSCAN",
                                            device="cpu")
    np.testing.assert_array_equal(a5, a5_lo)


def test_long_series_auto_time_sharding(eight_devices, rng):
    """Fewer series than shards + long T: EWMA re-shards over TIME, as
    the reference does (theia_tpu/analytics/tad.py:118-141), within
    TIME_RTOL of the local path and of the reference's."""
    assert port_tad.LONG_SERIES_T == ref_tad.LONG_SERIES_T
    S, T = 3, port_tad.LONG_SERIES_T
    x = rng.uniform(1e5, 1e7, size=(S, T))
    mask = np.ones((S, T), bool)
    c_sh, s_sh, a_sh = port_tad.score_series(x, mask, "EWMA",
                                             mesh=cpu_mesh())
    c_lo, s_lo, a_lo = port_tad.score_series(x, mask, "EWMA",
                                             device="cpu")
    assert c_sh.shape == (S, T)
    np.testing.assert_allclose(c_sh, c_lo, rtol=TIME_RTOL)
    np.testing.assert_allclose(s_sh, s_lo, rtol=TIME_RTOL)
    np.testing.assert_array_equal(a_sh, a_lo)
    c_ref, s_ref, a_ref = ref_tad.score_series(
        x, mask, "EWMA", mesh=ref_par.make_mesh(8, time_shards=1))
    np.testing.assert_allclose(c_sh, c_ref, rtol=TIME_RTOL)
    np.testing.assert_allclose(s_sh, s_ref, rtol=TIME_RTOL)
    np.testing.assert_array_equal(a_sh, a_ref)

    # below the threshold the local path still wins (no re-mesh)
    xs = rng.uniform(1e5, 1e7, size=(3, 64))
    ms = np.ones((3, 64), bool)
    c2, _, a2 = port_tad.score_series(xs, ms, "EWMA", mesh=cpu_mesh(),
                                      device="cpu")
    c2_lo, _, a2_lo = port_tad.score_series(xs, ms, "EWMA",
                                            device="cpu")
    np.testing.assert_array_equal(c2, c2_lo)
    np.testing.assert_array_equal(a2, a2_lo)


def _tad_rows(db, tad_id):
    data = db.tadetector.scan()
    ids = data.strings("id")
    return sorted(tuple(sorted((k, v) for k, v in r.items() if k != "id"))
                  for r in data.filter(ids == tad_id).to_rows())


def _split_floats(rows):
    floats = ("algoCalc", "throughputStandardDeviation")
    return ([tuple(kv for kv in r if kv[0] not in floats) for r in rows],
            np.array([[v for k, v in r if k in floats] for r in rows]))


@pytest.mark.parametrize("algo", ["EWMA", "ARIMA", "DBSCAN"])
def test_run_tad_sharded_rows_match_reference(eight_devices, algo):
    """The job entry point over an 8-shard CPU mesh writes the rows of
    its mesh=None run, and the reference's rows on 8 devices."""
    from theia_tpu.data.synth import SynthConfig, generate_flows
    from theia_tpu.store import FlowDatabase as RefDatabase
    from theia_tpu_torch.analytics import TadQuerySpec, run_tad
    from theia_tpu_torch.store import FlowDatabase

    cfg = SynthConfig(n_series=16, points_per_series=24,
                      anomaly_fraction=0.4, anomaly_magnitude=30.0,
                      base_throughput=1e7)
    db, ref_db = FlowDatabase(), RefDatabase()
    from theia_tpu_torch.data.synth import generate_flows as port_gen
    db.insert_flows(port_gen(cfg))
    ref_db.insert_flows(generate_flows(cfg))
    run_tad(db, algo, TadQuerySpec(), tad_id="sh", mesh=cpu_mesh(),
            device="cpu")
    run_tad(db, algo, TadQuerySpec(), tad_id="lo", mesh=None,
            device="cpu")
    ref_tad.run_tad(ref_db, algo, ref_tad.TadQuerySpec(), tad_id="sh",
                    mesh=ref_par.make_mesh(8, time_shards=1))
    sh, lo, ref = (_tad_rows(db, "sh"), _tad_rows(db, "lo"),
                   _tad_rows(ref_db, "sh"))
    assert sh == lo and sh, f"{algo} sharded != single-device"
    got_exact, got_f = _split_floats(sh)
    want_exact, want_f = _split_floats(ref)
    assert got_exact == want_exact
    rtol = ARIMA_RTOL if algo == "ARIMA" else STD_RTOL
    np.testing.assert_allclose(got_f, want_f, rtol=rtol)


def test_run_npr_sharded_policies_match_reference(eight_devices):
    """An explicitly passed mesh opts into the sharded device distinct
    (no THEIA_NPR_DEVICE needed): the policies of mesh=None and of the
    reference's sharded run."""
    from theia_tpu.analytics import run_npr as ref_run_npr
    from theia_tpu.data.synth import SynthConfig, generate_flows
    from theia_tpu.store import FlowDatabase as RefDatabase
    from theia_tpu_torch.analytics import run_npr
    from theia_tpu_torch.data.synth import generate_flows as port_gen
    from theia_tpu_torch.store import FlowDatabase

    cfg = SynthConfig(n_series=24, points_per_series=4)
    db, ref_db = FlowDatabase(), RefDatabase()
    db.insert_flows(port_gen(cfg))
    ref_db.insert_flows(generate_flows(cfg))
    calls = []
    orig = port_dev.make_sharded_distinct

    def spy(mesh):
        calls.append(mesh.size)
        return orig(mesh)

    port_par.reset_cache()
    try:
        port_dev.make_sharded_distinct = spy
        run_npr(db, recommendation_id="sh", mesh=cpu_mesh(), device="cpu")
    finally:
        port_dev.make_sharded_distinct = orig
        port_par.reset_cache()
    assert calls == [8]
    run_npr(db, recommendation_id="lo", mesh=None, device="cpu")
    ref_run_npr(ref_db, recommendation_id="sh",
                mesh=ref_par.make_mesh(8, time_shards=1))

    def policies(d, rid):
        recs = d.recommendations.scan()
        mine = recs.filter(recs.strings("id") == rid)
        return sorted(zip(mine.strings("kind"), mine.strings("policy")))

    sh = policies(db, "sh")
    assert sh and sh == policies(db, "lo") == policies(ref_db, "sh")


@pytest.mark.parametrize("n,k,card", [(61, 4, 5), (8 * 64, 5, 13),
                                      (8 * 16, 3, 1), (9, 9, 3)])
def test_sharded_distinct_with_sentinel_padding(eight_devices, n, k,
                                                card):
    """device_distinct over the mesh pads rows to the shard multiple
    with the sentinel; uniques and counts equal the host group_reduce,
    the port's one-device DISTINCT and the reference's sharded one."""
    keys = np.random.default_rng(n).integers(
        0, card, size=(n, k)).astype(np.int64)
    u_sh, c_sh = port_dev.device_distinct(keys, use_device=True,
                                          mesh=cpu_mesh())
    u_lo, c_lo = port_dev.device_distinct(keys, use_device=False)
    u_one, c_one = port_dev.device_distinct(keys, use_device=True,
                                            device="cpu")
    u_ref, c_ref = ref_dev.device_distinct(
        keys, use_device=True, mesh=ref_par.make_rows_mesh(8))
    for u, c in ((u_lo, c_lo), (u_one, c_one), (u_ref, c_ref)):
        np.testing.assert_array_equal(u_sh, u)
        np.testing.assert_array_equal(c_sh, c)
    # fewer rows than shards: the DISTINCT runs on the mesh's device
    u_few, c_few = port_dev.device_distinct(keys[:5], use_device=True,
                                            mesh=cpu_mesh())
    u_host, c_host = port_dev.device_distinct(keys[:5], use_device=False)
    np.testing.assert_array_equal(u_few, u_host)
    np.testing.assert_array_equal(c_few, c_host)


def test_sharded_distinct_step_matches_reference(eight_devices):
    """make_sharded_distinct's padded output (uniq, counts, n_unique)
    against the reference's, every shard a block of duplicates."""
    keys = np.full((8 * 16, 3), 42, np.int32)
    keys[::5, 1] = 7
    got = port_dev.make_sharded_distinct(
        port_par.make_rows_mesh(devices=CPU8))(keys)
    want = ref_dev.make_sharded_distinct(ref_par.make_rows_mesh(8))(keys)
    u = int(got[2])
    assert u == int(want[2]) == 2
    np.testing.assert_array_equal(got[0][:u].numpy(),
                                  np.asarray(want[0])[:u])
    np.testing.assert_array_equal(got[1][:u].numpy(),
                                  np.asarray(want[1])[:u])


@pytest.mark.parametrize("n_rows", [403, 400])
def test_itemset_counts_over_mesh_match_reference(eight_devices, n_rows):
    """_counts_over on the mesh (padding rows subtracted) against the
    reference's psum version and the port's one device, at all three
    levels."""
    from functools import partial
    rng = np.random.default_rng(n_rows)
    items = rng.integers(0, 12, size=(n_rows, 4)).astype(np.int32)
    dense = np.where(rng.random((n_rows, 4)) < 0.2, -1,
                     rng.integers(0, 5, size=(n_rows, 4))).astype(np.int32)
    pair_id = np.full(25, -1, np.int32)
    pair_id[[1, 7, 13, 19]] = np.arange(4, dtype=np.int32)
    mesh = cpu_mesh()
    ref_mesh = ref_par.make_mesh(8, time_shards=1)
    cases = [(items, partial(port_its._support_1, n_items=12),
              partial(ref_its._support_1, n_items=12), None),
             (dense, partial(port_its._support_2, f=5),
              partial(ref_its._support_2, f=5), None),
             (dense, partial(port_its._support_3, p=4, f=5),
              partial(ref_its._support_3, p=4, f=5), pair_id)]
    import jax.numpy as jnp
    for rows, fn, ref_fn, extra in cases:
        got = port_its._counts_over(rows, mesh, None, fn, extra=extra)
        one = port_its._counts_over(rows, None, torch.device("cpu"), fn,
                                    extra=extra)
        want = ref_its._counts_over(
            rows, ref_mesh, ref_fn,
            extra=None if extra is None else jnp.asarray(extra))
        np.testing.assert_array_equal(got, one)
        np.testing.assert_array_equal(got, want)
        assert got.sum() > 0


def test_job_mesh_env_switch(monkeypatch):
    """THEIA_MESH as the reference reads it, over the visible cards:
    none or one card answers None; eight answer an 8-shard mesh."""
    port_par.reset_cache()
    try:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
        monkeypatch.setenv("THEIA_MESH", "off")
        assert port_par.job_mesh() is None
        monkeypatch.setenv("THEIA_MESH", "auto")
        m = port_par.job_mesh()
        assert m is not None and m.size == 8
        assert m.axis_names == ("series", "time")
        assert [str(d) for d in m.devices.flatten()] == [
            f"cuda:{i}" for i in range(8)]
        monkeypatch.setenv("THEIA_MESH", "4")
        assert port_par.job_mesh().size == 4
        monkeypatch.setenv("THEIA_MESH", "four")
        with pytest.raises(ValueError, match="THEIA_MESH"):
            port_par.job_mesh()
        for count in (1, 0):
            port_par.reset_cache()
            monkeypatch.setattr(torch.cuda, "device_count",
                                lambda c=count: c)
            monkeypatch.setenv("THEIA_MESH", "auto")
            assert port_par.job_mesh() is None
    finally:
        port_par.reset_cache()


def test_cached_kernel_memoizes_per_key():
    port_par.reset_cache()
    built = []
    for _ in range(3):
        fn = port_par.cached_kernel(("k", cpu_mesh()),
                                    lambda: built.append(1) or len)
    assert fn is len and built == [1]
    port_par.reset_cache()
    port_par.cached_kernel(("k", cpu_mesh()), lambda: built.append(1) or len)
    assert built == [1, 1]
    assert port_engine._lock is not None
    port_par.reset_cache()


def test_mesh_reads_as_the_reference(eight_devices):
    mesh = cpu_mesh(time_shards=2)
    ref_mesh = ref_par.make_mesh(8, time_shards=2)
    assert mesh.axis_names == tuple(ref_mesh.axis_names)
    assert dict(mesh.shape) == dict(ref_mesh.shape)
    assert mesh.size == ref_mesh.size == mesh.devices.size
    assert mesh == cpu_mesh(time_shards=2) != cpu_mesh()
    assert hash(mesh) == hash(cpu_mesh(time_shards=2))
    rows = port_par.make_rows_mesh(3, devices=CPU8)
    assert rows.axis_names == ("rows",) and rows.size == 3
    with pytest.raises(ValueError, match="divide"):
        port_par.make_mesh(devices=CPU8[:6], time_shards=4)
    with pytest.raises(ValueError, match="device"):
        port_par.make_rows_mesh(devices=[])


def test_collectives_keep_shard_order():
    parts = [torch.full((2,), float(i)) for i in range(4)]
    gathered = port_par.mesh.all_gather(parts)
    assert len(gathered) == 4 and gathered[0] is gathered[3]
    assert gathered[0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    total = port_par.mesh.psum([torch.tensor([v], dtype=torch.float64)
                                for v in (0.1, 0.2, 0.3)])
    # (0.1 + 0.2) + 0.3 != 0.1 + (0.2 + 0.3) in float64
    assert [t.item() for t in total] == [(0.1 + 0.2) + 0.3] * 3


@pytest.mark.cuda
def test_four_shards_on_one_card_launch_b2_once_each():
    """A 4-shard mesh on cuda:0 gives the rows of mesh=None for DBSCAN,
    and B2's launch counter moves by 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    x = rng.uniform(1e6, 2e8, size=(64, 128))
    x[5, 7] = 9e9
    mask = np.ones(x.shape, bool)
    mesh = port_par.make_mesh(devices=["cuda:0"] * 4)
    before = _build.launches().get("dbscan_noise", 0)
    got = port_tad.score_series(x, mask, "DBSCAN", mesh=mesh)
    assert _build.launches()["dbscan_noise"] - before == 4
    want = port_tad.score_series(x, mask, "DBSCAN", device="cuda")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2][5, 7]
