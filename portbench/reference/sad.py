"""Plain reference of the spatial anomaly (SAD) job: which flows are
DBSCAN noise in the job's embedding.

The job embeds each flow in 7 dimensions (two hash coordinates, in
[0, 100), of each of sourceIP, destinationIP and destinationTransport
Port, hashed from the store's dictionary codes; and log1p of
octetDeltaCount) and marks as noise every flow that is neither a core
point (at least minSamples flows, itself included, within eps) nor
within eps of one. This file works the embedding out again from the
flows the benchmark posted, with the store's codes replayed from the
order the blocks were posted in, and runs the pairwise passes in
blocks of rows on the card in float32 with TF32 off.

A pair whose squared distance lies within 2^-20·(|x|²+|y|²) of eps² is
decided by rounding alone, so the reference runs both passes twice, at
eps² minus and plus that band: a flow that is noise under the looser
relation has to be in the job's result, and a flow in the result has
to be noise under the tighter one.

Imports nothing of the port.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

CATEGORICAL_SCALE = 100.0
BAND = 2.0 ** -20
SEEDS = (0x1234ABCD, 0x9E3779B9)


def hash01(codes: np.ndarray, seed: int) -> np.ndarray:
    h = codes.astype(np.uint32) ^ np.uint32(seed)
    h ^= h >> 16
    h = (h * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
    h ^= h >> 13
    h = (h * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
    h ^= h >> 16
    return h.astype(np.float64) / 4294967296.0


def store_codes(block_codes: List[np.ndarray]) -> Dict[int, int]:
    """The store's dictionary code of each string (by the benchmark's
    table code) when blocks are inserted one after another in this
    order, each carrying its distinct strings in table order: a string
    takes the next code where it first appears; "" is code 0."""
    codes = {0: 0}
    for uniq in block_codes:
        for c in uniq.tolist():
            if c not in codes:
                codes[c] = len(codes)
    return codes


def embeddings(src_codes, dst_codes, ports, octets) -> np.ndarray:
    axes = []
    for codes in (src_codes, dst_codes, ports):
        for seed in SEEDS:
            axes.append(hash01(np.asarray(codes, np.int64), seed)
                        * CATEGORICAL_SCALE)
    axes.append(np.log1p(np.asarray(octets, np.float64)))
    return np.stack(axes, axis=1).astype(np.float32)


def noise_bounds(emb: np.ndarray, eps: float, min_samples: int,
                 device: str = "cuda", dtype: str = "float32",
                 block: int = 1024) -> Tuple[np.ndarray, np.ndarray, int]:
    """(noise under eps² + band, noise under eps² − band, core count
    under eps²) of every point, in `dtype` on `device`."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tdt = getattr(torch, dtype)
        x = torch.from_numpy(emb).to(device=device, dtype=tdt)
        n = x.shape[0]
        sq = (x * x).sum(1)
        e2 = eps * eps
        cnt = {k: torch.zeros(n, dtype=torch.int64, device=device)
               for k in ("lo", "mid", "hi")}

        def tiles():
            for i in range(0, n, block):
                xi, si = x[i:i + block], sq[i:i + block]
                d2 = si[:, None] + sq[None, :] - 2.0 * (xi @ x.T)
                band = BAND * (si[:, None] + sq[None, :])
                yield i, d2, band

        for i, d2, band in tiles():
            j = slice(i, i + d2.shape[0])
            cnt["lo"][j] = (d2 <= e2 - band).sum(1)
            cnt["mid"][j] = (d2 <= e2).sum(1)
            cnt["hi"][j] = (d2 <= e2 + band).sum(1)
        core = {k: v >= min_samples for k, v in cnt.items()}
        reach = {k: torch.zeros(n, dtype=torch.bool, device=device)
                 for k in ("lo", "hi")}
        for i, d2, band in tiles():
            j = slice(i, i + d2.shape[0])
            reach["lo"][j] = ((d2 <= e2 - band) & core["lo"][None, :]).any(1)
            reach["hi"][j] = ((d2 <= e2 + band) & core["hi"][None, :]).any(1)
        sure = ~core["hi"] & ~reach["hi"]
        possible = ~core["lo"] & ~reach["lo"]
        return (sure.cpu().numpy(), possible.cpu().numpy(),
                int(core["mid"].sum()))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def differ(got: Counter, sure: Counter, possible: Counter) -> int:
    """Flows the job got wrong: sure noise it left out, and noise it
    reported that is not noise under the tighter relation."""
    return (sum((sure - got).values())
            + sum((got - possible).values()))


def check(ctx, results: List[List[dict]]) -> dict:
    """The job's noise flows against the reference's, for each job's
    result rows in `results` (the worst job counts)."""
    from portbench.traffic.job_loop import stored_rows, thr_of
    conns = ctx.data["conns"]
    rounds, rows = stored_rows(ctx)
    blocks = [b for _, b in ctx.data["blocks"]]
    src_t, src = conns.strings["sourceIP"]
    dst_t, dst = conns.strings["destinationIP"]
    src_store = store_codes([np.unique(src[b.conns]) for b in blocks])
    dst_store = store_codes([np.unique(dst[b.conns]) for b in blocks])
    octets = thr_of(conns, rounds, rows) * int(conns.p["interval_seconds"])
    emb = embeddings(
        np.array([src_store[c] for c in src[rows].tolist()]),
        np.array([dst_store[c] for c in dst[rows].tolist()]),
        conns.dst_port[rows], octets)
    spec = ctx.traffic["spec"]
    sure, possible, core = noise_bounds(
        emb, float(spec.get("eps", 1.0)), int(spec.get("minSamples", 4)),
        device=ctx.data.get("reference_device", ctx.device),
        dtype=ctx.data.get("reference_dtype", "float32"))

    def flows(mask):
        idx = np.flatnonzero(mask)
        return Counter(zip((src_t[src[rows[idx]]]).tolist(),
                           (dst_t[dst[rows[idx]]]).tolist(),
                           conns.dst_port[rows[idx]].tolist(),
                           octets[idx].tolist()))
    want_sure, want_possible = flows(sure), flows(possible)
    worst = 0
    for stats in results:
        got = Counter((r["sourceIP"].encode(), r["destinationIP"].encode(),
                       int(r["destinationTransportPort"]),
                       int(r["octetDeltaCount"])) for r in stats)
        worst = max(worst, differ(got, want_sure, want_possible))
    ctx.data["sad_n"] = len(rows)
    ctx.data["sad_core"] = core
    ctx.data["sad_dim"] = emb.shape[1]
    from portbench import harness
    harness.note(reference_noise_sure=int(sure.sum()),
                 reference_noise_possible=int(possible.sum()),
                 reference_core=core, flows=len(rows),
                 job_noise=[len(s) for s in results])
    return {"noise_differ": {"value": worst,
                             "limit": ctx.traffic["limits"]["noise_differ"]}}
