"""EWMA constants shared by the streaming detectors.

Ports the part of theia_tpu/ops/ewma.py that the live scoring path
reads: the smoothing factor. The batch EWMA scoring kernels belong to
the TAD job and are not ported yet.
"""

DEFAULT_ALPHA = 0.5
