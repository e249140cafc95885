"""Device ops: anomaly scoring (EWMA, ARIMA, DBSCAN, spatial DBSCAN,
traffic drops), masked series statistics, sketches, the fused
detector step, and the CUDA kernel build (`_build`)."""

from .arima import arima_scores, arima_walk_forward, boxcox_lambda
from .dbscan import dbscan_noise, dbscan_scores
from .drops import drop_scores
from .ewma import ewma, ewma_scores
from .masked import masked_count, masked_mean, masked_stddev_samp
from .sketch import (cms_init, cms_query, cms_update, kmeans_init,
                     kmeans_step)

__all__ = [
    "arima_scores", "arima_walk_forward", "boxcox_lambda",
    "dbscan_noise", "dbscan_scores",
    "drop_scores",
    "ewma", "ewma_scores",
    "masked_count", "masked_mean", "masked_stddev_samp",
    "cms_init", "cms_query", "cms_update", "kmeans_init", "kmeans_step",
]
