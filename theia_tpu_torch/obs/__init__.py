"""The port's own metrics registry (a copy of theia_tpu/obs/metrics.py;
separate from the reference's registry)."""

from . import metrics  # noqa: F401
