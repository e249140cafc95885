"""Port parity: theia_tpu_torch.analytics.streaming against
theia_tpu.analytics.streaming, on the CPU.

The port rounds every float32 operation once (no fused multiply-add),
as the reference's `_update` does when run op by op: against that,
state and flags are bit-exact. The reference's jitted functions are
compiled by XLA's CPU backend, which contracts `m2 + delta*(xa-mean)`
into a fused multiply-add inside its fused loops, so m2 can differ by
an ulp per update, and the differences add up over the ticks of a
series: against jitted references m2 is held to rtol 1e-5 (40 ticks of
float32 at 2^-24 each is under 3e-6). ewma, count and mean involve no
contractible product at alpha = 0.5 and stay bit-exact, as do the
anomaly flags and alerts on these inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.analytics import streaming as ref
from theia_tpu.data.synth import SynthConfig, generate_flows
from theia_tpu_torch.analytics import streaming as port
from theia_tpu_torch.data import synth as port_synth


def _state(rng, n):
    return (rng.normal(5, 2, n).astype(np.float32),
            rng.integers(0, 6, n).astype(np.int32),
            rng.normal(5, 2, n).astype(np.float32),
            rng.uniform(0, 30, n).astype(np.float32))


def _ref_state(arrays):
    return ref.StreamState(*(jnp.asarray(a) for a in arrays))


def _port_state(arrays):
    return port.StreamState(*(torch.from_numpy(a.copy()) for a in arrays))


#: m2 tolerance against the reference's jitted (FMA-contracted) code
M2_RTOL = 1e-5


def _assert_state_equal(p, r, jitted=True):
    for name, a, b in zip(port.StreamState._fields, p, r):
        if name == "m2" and jitted:
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=M2_RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_update_bit_exact(alpha):
    rng = np.random.default_rng(5)
    arrays = _state(rng, 2048)
    x = rng.normal(5, 3, 2048).astype(np.float32)
    active = rng.random(2048) < 0.7
    r_new, r_anom = ref._update(_ref_state(arrays), jnp.asarray(x),
                                jnp.asarray(active), alpha)
    p_new, p_anom = port._update(_port_state(arrays), torch.from_numpy(x),
                                 torch.from_numpy(active), alpha)
    _assert_state_equal(p_new, r_new, jitted=False)
    np.testing.assert_array_equal(p_anom.numpy(), np.asarray(r_anom))
    assert p_anom.any()


def test_stream_update_dense_matches_reference():
    rng = np.random.default_rng(6)
    arrays = _state(rng, 64)
    r, p = _ref_state(arrays), _port_state(arrays)
    for _ in range(10):
        x = rng.normal(5, 3, 64).astype(np.float32)
        active = rng.random(64) < 0.6
        r, ra = ref.stream_update(r, jnp.asarray(x), jnp.asarray(active))
        p, pa = port.stream_update(p, torch.from_numpy(x),
                                   torch.from_numpy(active))
        _assert_state_equal(p, r)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))


@pytest.mark.parametrize("t,u,live", [(1, 64, 50), (3, 64, 64),
                                      (4, 256, 200)])
def test_stream_update_sparse_matches_reference(t, u, live):
    """Padding slots hold `capacity`: the reference clamps and drops
    them, the port masks them; real state must come out equal, and
    rows outside `slots` untouched."""
    rng = np.random.default_rng(t * 1000 + u)
    cap = 512
    arrays = _state(rng, cap)
    slots = np.full(u, cap, np.int32)
    slots[:live] = np.sort(rng.choice(cap, live, replace=False))
    r, p = _ref_state(arrays), _port_state(arrays)
    for _ in range(3):
        x = rng.normal(5, 3, (t, u)).astype(np.float32)
        active = rng.random((t, u)) < 0.8
        active[:, live:] = False
        r, ra = ref.stream_update_sparse(r, jnp.asarray(slots),
                                         jnp.asarray(x),
                                         jnp.asarray(active), 0.5)
        same, pa = port.stream_update_sparse(p, torch.from_numpy(slots),
                                             torch.from_numpy(x),
                                             torch.from_numpy(active))
        assert same is p   # updated in place
        _assert_state_equal(p, r)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    outside = np.setdiff1d(np.arange(cap), slots[:live])
    for a, b in zip(p, arrays):
        np.testing.assert_array_equal(a.numpy()[outside], b[outside])


def _strip(alerts):
    return [{k: v for k, v in a.items() if k != "latency_s"}
            for a in alerts]


def _detector_pair(capacity):
    return (ref.StreamingDetector(capacity=capacity),
            port.StreamingDetector(capacity=capacity, device="cpu"))


def _assert_detectors_equal(d_ref, d_port):
    assert d_port.n_series == d_ref.n_series
    assert d_port.dropped_series == d_ref.dropped_series
    _assert_state_equal(d_port.state, d_ref.state)


def _batches(cfg):
    return (generate_flows(cfg),
            port_synth.generate_flows(port_synth.SynthConfig(
                **{f: getattr(cfg, f)
                   for f in cfg.__dataclass_fields__})))


def test_ingest_one_point_per_tick_matches_reference():
    """tests/test_streaming.py's spike case: micro-batches of one point
    per series, 40 ticks."""
    cfg = SynthConfig(n_series=16, points_per_series=40,
                      anomaly_fraction=0.25, anomaly_magnitude=60.0,
                      seed=13)
    b_ref, b_port = _batches(cfg)
    d_ref, d_port = _detector_pair(64)
    idx = np.arange(len(b_ref)).reshape(16, 40)
    n_alerts = 0
    for t in range(40):
        m_ref, m_port = b_ref.take(idx[:, t]), b_port.take(idx[:, t])
        a_ref = [d_ref.describe_alert(m_ref, a) for a in d_ref.ingest(m_ref)]
        a_port = [d_port.describe_alert(m_port, a)
                  for a in d_port.ingest(m_port)]
        assert _strip(a_port) == _strip(a_ref)
        n_alerts += len(a_ref)
    assert n_alerts > 0
    _assert_detectors_equal(d_ref, d_port)


@pytest.mark.parametrize("n_series,points,capacity,seed", [
    (4, 30, 16, 3),     # every point of each series in ONE batch
    (8, 30, 16, 5),
    (8, 2, 3, 1),       # capacity overflow
    (8, 10, 3, 1),      # dropped series counted once
])
def test_ingest_whole_batches_match_reference(n_series, points,
                                              capacity, seed):
    cfg = SynthConfig(n_series=n_series, points_per_series=points,
                      anomaly_fraction=1.0, anomaly_magnitude=80.0,
                      seed=seed)
    b_ref, b_port = _batches(cfg)
    d_ref, d_port = _detector_pair(capacity)
    for _ in range(2):   # the same series again: dropped ones stay dropped
        assert _strip(d_port.ingest(b_port)) == _strip(d_ref.ingest(b_ref))
        _assert_detectors_equal(d_ref, d_port)
