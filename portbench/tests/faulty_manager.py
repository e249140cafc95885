"""The port's manager with a fault or a control planted under the timed
path, for the runs that must come out not correct:

    python faulty_manager.py <plant> <manager arguments...>

Faults:
  state_unchanged  the streaming detector's step flags its points but
                   leaves every connection's state as it was
  half_batch       the store inserts the first half of each batch; the
                   SAD job scores the first half of its flows
  altered          the store shifts one value of each batch; the job
                   alters one row of its result

Controls (the nearest precision below the one the configuration
states):
  bf16_state       the streaming detector keeps its EWMA/Welford state
                   in bfloat16 (rounded after every scan, on either
                   engine)
  bf16_pairs       the SAD job's pairwise distance passes run in
                   bfloat16 (TF32 off is float32's)
"""

import sys

import numpy as np


def _bf16_state() -> None:
    import torch
    from theia_tpu_torch.ops import fused_detector

    orig = fused_detector.stream_scan_grouped

    def grouped(group, *a, **kw):
        out = orig(group, *a, **kw)
        for state, *_ in group:
            for t in state:
                if t.is_floating_point():
                    t.copy_(t.to(torch.bfloat16))
        return out
    fused_detector.stream_scan_grouped = grouped


def _bf16_pairs() -> None:
    import torch
    from theia_tpu_torch.ops import dbscan

    def within(tile, points, x2, eps2):
        t, p = tile.to(torch.bfloat16), points.to(torch.bfloat16)
        d2 = (t * t).sum(-1)[:, None] + (p * p).sum(-1)[None, :]
        d2 -= 2 * (t @ p.T)
        return d2 <= eps2
    dbscan._within = within


def plant(name: str) -> None:
    if name == "bf16_state":
        return _bf16_state()
    if name == "bf16_pairs":
        return _bf16_pairs()
    from theia_tpu_torch.analytics import spatial, streaming
    from theia_tpu_torch.store import FlowDatabase

    if name == "state_unchanged":
        orig_update = streaming.stream_update_sparse

        def unchanged(state, slots, x, active, alpha=0.5):
            saved = [t.clone() for t in state]
            st, anomaly = orig_update(state, slots, x, active, alpha)
            for t, s in zip(state, saved):
                t.copy_(s)
            return st, anomaly
        streaming.stream_update_sparse = unchanged
        return

    orig_insert = FlowDatabase.insert_flows
    orig_outliers = spatial.spatial_outliers

    if name == "half_batch":
        def insert(self, batch, now=None, dedup=None, wire=None):
            half = batch.take(np.arange(len(batch) // 2))
            return orig_insert(self, half, now) and len(batch)

        def outliers(flows, *a, **kw):
            kw.pop("embeddings", None)
            return orig_outliers(flows.take(np.arange(len(flows) // 2)),
                                 *a, **kw)
    elif name == "altered":
        def insert(self, batch, now=None, dedup=None, wire=None):
            col = np.array(batch["octetDeltaCount"], copy=True)
            col[0] += 1
            batch.columns["octetDeltaCount"] = col
            return orig_insert(self, batch, now)

        def outliers(flows, *a, **kw):
            out = orig_outliers(flows, *a, **kw)
            if out:
                out[0] = {**out[0],
                          "octetDeltaCount": out[0]["octetDeltaCount"] + 1}
            return out
    else:
        raise SystemExit(f"unknown plant {name!r}")
    FlowDatabase.insert_flows = insert
    spatial.spatial_outliers = outliers


if __name__ == "__main__":
    plant(sys.argv[1])
    from theia_tpu_torch.manager.__main__ import main
    main(sys.argv[2:])
