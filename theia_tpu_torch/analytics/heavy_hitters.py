"""Streaming heavy-hitter / DDoS detection at ingest line rate.

Ports theia_tpu/analytics/heavy_hitters.py. Per ingest micro-batch,
one device step:

  1. CMS update: per-destination traffic volume sketched into a
     [depth, width] counter array (ops/sketch.py).
  2. Heavy hitters: destinations whose sketched share of total volume
     exceeds `hh_fraction` (the phi-heavy-hitter definition).
  3. Online k-means over per-flow feature vectors (log bytes, log
     packets, log mean packet size, log peer fan-in): flows assigned
     far from every centroid (distance > `ddos_sigma` x the running
     distance scale) are traffic-shape outliers.

Keys are integer dictionary codes straight from the columnar batch —
no string work on the hot path. Alerts carry decoded names.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.sketch import (
    CmsState,
    KMeansState,
    cms_init,
    cms_query,
    cms_update,
    keys_tensor,
    kmeans_init,
    kmeans_step,
)
from ..schema import ColumnarBatch
from ..utils.device import resolve_device

FEATURES = 4


def _fused_step(cms: CmsState, km: KMeansState, keys: torch.Tensor,
                volumes: torch.Tensor, q: torch.Tensor,
                feats: torch.Tensor, valid: torch.Tensor
                ) -> Tuple[CmsState, KMeansState, torch.Tensor,
                           torch.Tensor]:
    """The whole per-batch device step: sketch update, heavy-hitter
    query, k-means step."""
    cms = cms_update(cms, keys, volumes)
    est = cms_query(cms, q)
    km, _, dist = kmeans_step(km, feats, valid)
    return cms, km, est, dist


@dataclasses.dataclass
class HeavyHitterAlert:
    kind: str              # "heavy_hitter" | "ddos_shape"
    destination: str
    estimate: float        # sketched volume (hh) or outlier distance
    share: float           # fraction of total volume (hh) / sigma (ddos)


class HHPlan(NamedTuple):
    """Padded device inputs for one micro-batch's heavy-hitter step,
    built host-side by `build_hh_plan` and consumed by this class's
    `_fused_step` or by the cross-shard fused engine — one function
    for both, so the two engines cannot drift."""
    keys: np.ndarray        # [size] uint32 CMS keys (dst codes, padded)
    vols: np.ndarray        # [size] float32 volumes (zero padding)
    q: np.ndarray           # [q_size] uint32 distinct-dst query keys
    feats: np.ndarray       # [size, FEATURES] float32
    valid: np.ndarray       # [size] bool (False on padding)
    uniq_codes: np.ndarray  # distinct destination codes, unpadded
    dst_codes: np.ndarray   # [n] int64 per-row destination codes
    n: int                  # live rows


def pad_bucket(n: int, minimum: int = 256) -> int:
    """Fixed buckets (next power of two, min 256), so the staged
    shapes repeat from step to step."""
    size = minimum
    while size < n:
        size <<= 1
    return size


def _features_cols(octets: np.ndarray, packets: np.ndarray,
                   dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Traffic-shape feature matrix from raw columns (vectorized,
    host side). octets/packets float64, dst/src int64 codes."""
    # peer fan-in: DISTINCT sources per destination in this batch,
    # from one 1-D unique over a packed 64-bit (dst, src) key (codes
    # are int32, so the pack is lossless).
    pairs = np.unique((dst << np.int64(32)) | src)
    per_dst_dsts, per_dst_counts = np.unique(
        pairs >> np.int64(32), return_counts=True)
    fan_in = per_dst_counts[
        np.searchsorted(per_dst_dsts, dst)].astype(np.float64)
    mean_pkt = octets / np.maximum(packets, 1.0)
    return np.stack([np.log1p(octets), np.log1p(packets),
                     np.log1p(mean_pkt), np.log1p(fan_in)], axis=1)


def build_hh_plan(dst_codes: np.ndarray, src_codes: np.ndarray,
                  octets: np.ndarray, packets: np.ndarray,
                  staging: Optional[Callable] = None) -> HHPlan:
    """Padded device inputs for one micro-batch. `staging(tag, shape,
    dtype)` returns a reusable buffer to fill (the fused engine's
    pinned ring); None allocates fresh arrays. Padded rows carry zero
    volume (sketch-neutral) and are masked out of the centroid
    update."""
    n = len(dst_codes)
    size = pad_bucket(n)

    def _alloc(tag, shape, dtype):
        if staging is None:
            return np.zeros(shape, dtype)
        a = staging(tag, shape, dtype)
        a[...] = 0
        return a

    keys = _alloc("hh_keys", (size,), np.uint32)
    keys[:n] = dst_codes.astype(np.uint32)
    vols = _alloc("hh_vols", (size,), np.float32)
    vols[:n] = octets

    # Heavy-hitter query keys: this batch's distinct destinations.
    uniq_codes = np.unique(dst_codes)
    q = _alloc("hh_q", (pad_bucket(len(uniq_codes)),), np.uint32)
    q[:len(uniq_codes)] = uniq_codes.astype(np.uint32)

    feats = _alloc("hh_feats", (size, FEATURES), np.float32)
    feats[:n] = _features_cols(octets, packets, dst_codes, src_codes)
    valid = _alloc("hh_valid", (size,), bool)
    valid[:n] = True
    return HHPlan(keys, vols, q, feats, valid, uniq_codes,
                  np.asarray(dst_codes), n)


class HeavyHitterDetector:
    """Device-resident CMS + online k-means over ingest micro-batches."""

    def __init__(self, depth: int = 4, width: int = 8192,
                 k: int = 8, hh_fraction: float = 0.10,
                 ddos_sigma: float = 4.0, seed: int = 0,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self.cms: CmsState = cms_init(depth, width, self.device)
        rng = np.random.default_rng(seed)
        self.kmeans: KMeansState = kmeans_init(
            rng.normal(0.0, 1.0, size=(k, FEATURES)), self.device)
        self.hh_fraction = hh_fraction
        self.ddos_sigma = ddos_sigma
        # Running mean distance scale (EW average) for the outlier band.
        self._dist_scale = 1.0
        self.batches = 0
        #: total sketched volume after the last update (host float) —
        #: peers in a sharded ensemble read this to evaluate shares
        #: against the cluster total, not just this shard's.
        self.total_volume = 0.0

    # -- one micro-batch -------------------------------------------------

    def update(self, batch: ColumnarBatch,
               extra_total: float = 0.0) -> List[HeavyHitterAlert]:
        """Advance the sketch/centroids with one micro-batch.

        `extra_total` is volume held by OTHER detector shards in a
        sharded ensemble: the phi-heavy-hitter share is evaluated
        against (this shard's total + extra_total)."""
        if len(batch) == 0:
            return []
        plan = build_hh_plan(
            np.asarray(batch["destinationIP"], np.int64),
            np.asarray(batch["sourceIP"], np.int64),
            np.asarray(batch["octetDeltaCount"], np.float64),
            np.asarray(batch["packetDeltaCount"], np.float64))
        dev = self.device
        self.cms, self.kmeans, est_d, dist_d = _fused_step(
            self.cms, self.kmeans, keys_tensor(plan.keys, dev),
            torch.from_numpy(plan.vols).to(dev),
            keys_tensor(plan.q, dev),
            torch.from_numpy(plan.feats).to(dev),
            torch.from_numpy(plan.valid).to(dev))
        hits = self.threshold(plan, est_d.cpu().numpy(),
                              self.cms.total.item(),
                              dist_d.cpu().numpy(), extra_total,
                              batch.dicts.get("destinationIP"))
        return [alert for alert, _, _ in hits]

    def threshold(self, plan: HHPlan, est, total, dist,
                  extra_total: float = 0.0, dst_dict=None
                  ) -> List[Tuple[HeavyHitterAlert, int, int]]:
        """Host half of `update`: advance the running statistics and
        threshold the fetched estimates. Returns (alert, source_row,
        dst_code) triples — source_row is the plan-local row for
        ddos_shape alerts and -1 for heavy_hitter alerts (whose
        subject is the whole micro-batch, not one row)."""
        est = np.asarray(est)[:len(plan.uniq_codes)]
        total = float(total)
        self.total_volume = total
        dist = np.asarray(dist)[:plan.n]
        self.batches += 1

        hits: List[Tuple[HeavyHitterAlert, int, int]] = []
        grand_total = total + max(float(extra_total), 0.0)
        if grand_total > 0:
            share = est / grand_total
            for code, e, s in zip(plan.uniq_codes, est, share):
                if s >= self.hh_fraction:
                    name = (dst_dict.decode_one(int(code))
                            if dst_dict else str(int(code)))
                    hits.append((HeavyHitterAlert(
                        "heavy_hitter", name, float(e), float(s)),
                        -1, int(code)))
        scale = float(np.mean(dist)) if len(dist) else 0.0
        # Warmup: let centroids settle before alerting on distance.
        if self.batches > 3 and self._dist_scale > 0:
            outliers = dist > self.ddos_sigma * self._dist_scale
            for i in np.nonzero(outliers)[0]:
                code = int(plan.dst_codes[i])
                name = (dst_dict.decode_one(code)
                        if dst_dict else str(code))
                hits.append((HeavyHitterAlert(
                    "ddos_shape", name, float(dist[i]),
                    float(dist[i] / self._dist_scale)),
                    int(i), code))
        self._dist_scale = 0.7 * self._dist_scale + 0.3 * scale
        return hits

    def volume_estimate(self, destination_code: int) -> float:
        return float(cms_query(
            self.cms, keys_tensor(np.asarray([destination_code]),
                                  self.device))[0])
