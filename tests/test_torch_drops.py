"""Port parity: traffic-drop detection, theia_tpu_torch against
theia_tpu, on the CPU (device="cpu").

`drop_scores` on seeded [S, D] count matrices: anomaly flags exact,
mean and stddev within rtol 1e-6 (float32 sums over D in another order
than XLA's; the counts are integers below 2^24, so each row's sum is
exact and only the stddev's sum of squares can round differently).
`run_drop_detection` on the reference's FlowDatabase and the port's,
filled with the same seeded dropped flows: equal `dropdetection`
rows, avgDrop and stdevDrop within the same rtol. And the device rule
for the four job entry points of this slice: the card by default,
the CPU only when asked.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theia_tpu.analytics import drop_detection as ref_dd
from theia_tpu.ops import drops as ref_drops
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.analytics import drop_detection as port_dd
from theia_tpu_torch.ops import drops as port_drops
from theia_tpu_torch.store import FlowDatabase

RTOL = 1e-6
DAY = 86400
FLOATS = ("avgDrop", "stdevDrop")


def _counts(seed, s=64, d=30):
    """Poisson(8) daily counts, a few x20 spikes, ragged masks (some
    rows below MIN_OBSERVATIONS)."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(8.0, size=(s, d)).astype(np.float64)
    counts[rng.random((s, d)) < 0.02] *= 20
    mask = rng.random((s, d)) < 0.9
    mask[: s // 8, 2:] = False
    return counts, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drop_scores_match_reference(seed):
    counts, mask = _counts(seed)
    want = [np.asarray(a) for a in ref_drops.drop_scores(counts, mask)]
    got = [a.numpy() for a in port_drops.drop_scores(
        torch.from_numpy(counts), torch.from_numpy(mask))]
    np.testing.assert_array_equal(got[0], want[0])
    assert want[0].any() and not want[0][: counts.shape[0] // 8].any()
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL, equal_nan=True)


def _drop_rows(seed, endpoints=24, days=20):
    """Dropped flows: per endpoint-day Poisson(4) flows, 1% of
    endpoint-days x20; half the endpoints dropped on ingress (Drop),
    half on egress (Reject); a few pod-less endpoints keyed by IP;
    some allowed flows that must be ignored."""
    rng = np.random.default_rng(seed)
    rows = []
    for e in range(endpoints):
        ingress = e % 2 == 0
        pod = ("", "") if e % 5 == 4 else (f"ns-{e % 3}", f"pod-{e}")
        victim = (pod[0], pod[1], f"10.1.0.{e}")
        other = ("ns-x", "client", f"10.2.0.{e}")
        src, dst = (other, victim) if ingress else (victim, other)
        for day in range(days):
            n = int(rng.poisson(4.0))
            if rng.random() < 0.01 or (e, day) == (3, 7):
                n *= 20
            for i in range(n):
                rows.append({
                    "flowStartSeconds": day * DAY + 60 * i,
                    "flowEndSeconds": day * DAY + 60 * i + 5,
                    "sourcePodNamespace": src[0], "sourcePodName": src[1],
                    "sourceIP": src[2],
                    "destinationPodNamespace": dst[0],
                    "destinationPodName": dst[1], "destinationIP": dst[2],
                    "ingressNetworkPolicyRuleAction": 2 if ingress else 0,
                    "egressNetworkPolicyRuleAction": 0 if ingress else 3,
                    "timeInserted": day * DAY + 60 * i + 10,
                })
        rows.append({"flowStartSeconds": 5, "flowEndSeconds": 9,
                     "sourceIP": "10.9.9.9", "destinationIP": "10.9.9.8",
                     "ingressNetworkPolicyRuleAction": 1})
    return rows


@pytest.mark.parametrize("kwargs", [
    {}, {"start_time": 3 * DAY, "end_time": 15 * DAY}])
def test_run_drop_detection_matches_reference(kwargs):
    rows = _drop_rows(seed=4)
    ref_db, port_db = RefDatabase(), FlowDatabase()
    ref_db.insert_flow_rows(rows)
    port_db.insert_flow_rows(rows)
    job = "11111111-2222-3333-4444-555555555555"
    ref_dd.run_drop_detection(ref_db, detection_id=job, now=7, **kwargs)
    port_dd.run_drop_detection(port_db, detection_id=job, now=7,
                               device="cpu", **kwargs)
    want = ref_db.dropdetection.scan().to_rows()
    got = port_db.dropdetection.scan().to_rows()
    assert want, "the seeded spikes must fire"
    key = lambda r: (r["endpoint"], r["direction"], r["anomalyDropDate"])
    want, got = sorted(want, key=key), sorted(got, key=key)
    assert [{k: v for k, v in r.items() if k not in FLOATS} for r in got] \
        == [{k: v for k, v in r.items() if k not in FLOATS} for r in want]
    for f in FLOATS:
        np.testing.assert_allclose([r[f] for r in got],
                                   [r[f] for r in want], rtol=RTOL)


@pytest.mark.parametrize("entry", [
    "drop_detection.run_drop_detection", "npr.run_npr",
    "itemsets.run_pattern_mining", "spatial.run_spatial"])
def test_job_entry_points_need_a_card_unless_told_cpu(entry, monkeypatch):
    """The default device is the card: without one each job raises
    before it reads a flow, and never runs on the CPU unasked."""
    import importlib
    module, name = entry.split(".")
    fn = getattr(importlib.import_module(
        f"theia_tpu_torch.analytics.{module}"), name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(FlowDatabase())
    fn(FlowDatabase(), device="cpu")
