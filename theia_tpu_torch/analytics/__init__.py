"""Streaming detectors: per-connection EWMA/Welford and heavy-hitter
CMS + k-means."""
