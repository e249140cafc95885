"""Analytics jobs: throughput anomaly detection (TAD) and the
streaming detectors (per-connection EWMA/Welford, heavy-hitter CMS +
k-means)."""

from .heavy_hitters import HeavyHitterAlert, HeavyHitterDetector
from .series import SeriesBatch, TadQuerySpec, build_series
from .streaming import StreamingDetector, stream_update
from .tad import ALGORITHMS, detect_anomalies, run_tad, score_series

__all__ = [
    "SeriesBatch", "TadQuerySpec", "build_series",
    "ALGORITHMS", "detect_anomalies", "run_tad", "score_series",
    "StreamingDetector", "stream_update",
    "HeavyHitterAlert", "HeavyHitterDetector",
]
