"""Traffic-drop anomaly scoring.

Ports theia_tpu/ops/drops.py. Re-provides the per-partition statistics
of the reference's Snowflake drop-detection UDTF (snowflake/udfs/udfs/
drop_detection/drop_detection_udf.py:43-56): for each (endpoint,
direction) partition's daily drop-count series, anomaly iff the count
falls outside mean ± 3·stddev_samp, and partitions with fewer than 3
observations are skipped.

Partitions are rows of a padded [S, D] matrix (S partitions × D dates,
the mask marks real observations); the whole fleet scores in one pass
of torch ops on the tensors' device, in float32 as the reference.

Numerics against the reference: the sums over D reduce in another
order than XLA's, so mean and stddev may differ in the last bits
(counts below 2^24 sum exactly, so the mean of a row is exact).
"""

from __future__ import annotations

import torch

from .masked import masked_count, masked_mean, masked_stddev_samp

MIN_OBSERVATIONS = 3
SIGMA = 3.0


def drop_scores(counts: torch.Tensor, mask: torch.Tensor):
    """counts [S, D] float, mask [S, D] bool → (anomaly [S, D] bool,
    mean [S], stddev [S]), float32. Rows with < MIN_OBSERVATIONS valid
    entries produce no anomalies (UDTF end_partition early return)."""
    counts = counts.to(torch.float32)
    mean = masked_mean(counts, mask)
    std = masked_stddev_samp(counts, mask)
    n = masked_count(mask)
    upper = mean + SIGMA * std
    lower = mean - SIGMA * std
    anomaly = (counts > upper[:, None]) | (counts < lower[:, None])
    anomaly &= mask
    anomaly &= (n >= MIN_OBSERVATIONS)[:, None]
    return anomaly, mean, std
