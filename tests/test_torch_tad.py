"""Port parity: the TAD batch job, theia_tpu_torch.analytics.tad against
theia_tpu.analytics.tad, on the CPU (device="cpu").

The same synthetic flows go through the reference's build_series and
detect_anomalies / run_tad and through the port's (build_series is a
verbatim copy). Result rows must match one for one, in order:
identity columns, `anomaly`, `flowEndSeconds`, `throughput` and
`refitEvery` exactly; `throughputStandardDeviation` within rtol 2e-15
(a sum over T in another order); `algoCalc` exactly for EWMA (the same
scan) and DBSCAN (zeros), within rtol 1e-9 for ARIMA (libm and FMA
differences; tests/test_torch_arima.py states where they come from).
run_tad writes through the reference's FlowDatabase: the port touches
it only through `flows.scan()` and `tadetector.insert_rows`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theia_tpu.analytics import series as ref_series
from theia_tpu.analytics import tad as ref_tad
from theia_tpu.data.synth import SynthConfig, generate_flows
from theia_tpu.store import FlowDatabase
from theia_tpu_torch.analytics import series as port_series
from theia_tpu_torch.analytics import tad as port_tad

CALC_RTOL = {"EWMA": 0.0, "DBSCAN": 0.0, "ARIMA": 1e-9}
STD_RTOL = 2e-15
FLOATS = ("algoCalc", "throughputStandardDeviation")


def _flows(**kw):
    cfg = dict(n_series=24, points_per_series=40, anomaly_fraction=0.3,
               anomaly_magnitude=100.0, base_throughput=1e7, seed=7)
    cfg.update(kw)
    return generate_flows(SynthConfig(**cfg))


def _assert_rows_match(got, want, algo):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key in FLOATS:
                rtol = CALC_RTOL[algo] if key == "algoCalc" else STD_RTOL
                np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                           atol=0, err_msg=key)
            else:
                assert g[key] == w[key], (key, g[key], w[key])
                assert type(g[key]) is type(w[key]), key


@pytest.mark.parametrize("algo", port_tad.ALGORITHMS)
@pytest.mark.parametrize("agg", ["", "pod"])
def test_detect_anomalies_rows_match_reference(algo, agg):
    flows = _flows(points_per_series=40 if algo != "ARIMA" else 24)
    spec = port_series.TadQuerySpec(agg_flow=agg)
    batch = port_series.build_series(flows, spec)
    ref_batch = ref_series.build_series(
        flows, ref_series.TadQuerySpec(agg_flow=agg))
    np.testing.assert_array_equal(batch.values, ref_batch.values)
    got = port_tad.detect_anomalies(batch, algo, "job", now=0,
                                    device="cpu")
    want = ref_tad.detect_anomalies(ref_batch, algo, "job", now=0)
    assert any(r["anomaly"] == "true" for r in want)
    _assert_rows_match(got, want, algo)


@pytest.mark.parametrize("algo", port_tad.ALGORITHMS)
def test_run_tad_writes_the_reference_rows(algo):
    flows = _flows(n_series=16,
                   points_per_series=32 if algo != "ARIMA" else 20,
                   seed=11)
    dbs = []
    for _ in range(2):
        db = FlowDatabase()
        db.insert_flows(flows)
        dbs.append(db)
    spec = ref_series.TadQuerySpec()
    assert ref_tad.run_tad(dbs[0], algo, spec, tad_id="t1", now=0) == "t1"
    assert port_tad.run_tad(dbs[1], algo, port_series.TadQuerySpec(),
                            tad_id="t1", now=0, device="cpu") == "t1"
    want = dbs[0].tadetector.scan().to_rows()
    got = dbs[1].tadetector.scan().to_rows()
    assert len(want) > 1
    _assert_rows_match(got, want, algo)


@pytest.mark.parametrize("algo", port_tad.ALGORITHMS)
def test_no_anomaly_filler_row_matches_reference(algo):
    flows = _flows(n_series=4, points_per_series=8, anomaly_fraction=0.0,
                   seed=3)
    # a time window past every flow: no series at all
    spec = port_series.TadQuerySpec(start_time=2 ** 40)
    batch = port_series.build_series(flows, spec)
    assert batch.n_series == 0
    got = port_tad.detect_anomalies(batch, algo, "none", now=123,
                                    device="cpu")
    want = ref_tad.detect_anomalies(
        ref_series.build_series(flows,
                                ref_series.TadQuerySpec(start_time=2 ** 40)),
        algo, "none", now=123)
    assert got == want
    assert got[0]["anomaly"] == "NO ANOMALY DETECTED"
    # scored series on which nothing fires: one point each (stddev
    # NULL, too short for ARIMA), or for DBSCAN one dense cluster
    vals = np.full((3, 6), 5e6)
    mask = np.ones((3, 6), bool)
    if algo != "DBSCAN":
        mask[:, 1:] = False
    flat = port_series.SeriesBatch(("destinationIP",),
                                   {"destinationIP": np.array(
                                       ["a", "b", "c"], dtype=object)},
                                   vals, np.zeros((3, 6), np.int64), mask,
                                   "external")
    got = port_tad.detect_anomalies(flat, algo, "flat", now=5,
                                    device="cpu")
    assert got == [port_tad._no_anomaly_row("external", algo, "flat", 5,
                                            got[0]["refitEvery"])]
    assert got == ref_tad.detect_anomalies(flat, algo, "flat", now=5)


def test_effective_refit_matches_reference():
    for algo in port_tad.ALGORITHMS:
        for refit in (0, 1, 16):
            for steps in (0, 100, 5000):
                assert port_tad.effective_refit(algo, refit, steps) == \
                    ref_tad.effective_refit(algo, refit, steps)
    with pytest.raises(ValueError):
        port_tad.effective_refit("ARIMA", -1, 10)


def test_score_series_device_and_mesh_rules(monkeypatch):
    vals = np.full((2, 5), 1e6)
    mask = np.ones((2, 5), bool)
    with pytest.raises(ValueError):
        port_tad.score_series(vals, mask, "KMEANS", device="cpu")
    with pytest.raises(NotImplementedError):
        port_tad.score_series(vals, mask, "EWMA", mesh=object(),
                              device="cpu")
    with pytest.raises(NotImplementedError):
        port_tad.run_tad(None, "EWMA", port_series.TadQuerySpec(),
                         mesh="off", device="cpu")
    for mesh in ("auto", None):
        calc, std, anom = port_tad.score_series(vals, mask, "EWMA",
                                                mesh=mesh, device="cpu")
        assert isinstance(calc, np.ndarray) and anom.dtype == bool
    # the default device is the card: without one it raises, it never
    # runs quietly on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_tad.score_series(vals, mask, "EWMA")
