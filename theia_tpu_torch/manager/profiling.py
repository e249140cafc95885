"""On-demand profiler capture over the system API.

Ports theia_tpu/manager/profiling.py: a capture is a `torch.profiler`
trace of the given duration (CPU activity, plus CUDA activity when the
manager runs on a card), written as a Chrome trace (`trace.json`, which
Perfetto and chrome://tracing load) into the same tar.gz bundle.

SURVEY §5/§7.7: the reference's only runtime introspection is
scraping the Spark UI REST and ClickHouse system tables
(pkg/apiserver/utils/stats/clickhouse_stats.go:92-117 dumps
system.stack_trace); it has no accelerator profiler at all. Here the
manager can capture a real XLA profile of whatever the engine is
doing — device kernels, host callbacks, transfers — and hand back the
trace directory as a tar.gz that loads straight into TensorBoard /
Perfetto / xprof.

    POST /apis/system.theia.antrea.io/v1alpha1/profiles
        body: {"durationSeconds": N}   (default 3, capped)
    GET  .../profiles                  → {"status": ..., "size": ...}
    GET  .../profiles/theia-manager/download → tar.gz

One capture at a time (the profiler cannot nest); bearer-token
protected with the rest of the system group.
"""

from __future__ import annotations

import io
import os
import shutil
import tarfile
import tempfile
import time
from typing import Dict

import torch

from ..utils import get_logger
from .collect import AsyncCollector

logger = get_logger("profiling")

MAX_DURATION_SECONDS = 60.0


class ProfileManager(AsyncCollector):
    """Async single-flight XLA trace collection."""

    kind = "Profile"

    def __init__(self, device="cuda") -> None:
        super().__init__()
        self.device = torch.device(device)
        self.duration: float = 0.0

    def create(self, duration_seconds: float = 3.0) -> Dict[str, object]:
        self.duration = min(max(float(duration_seconds), 0.1),
                            MAX_DURATION_SECONDS)
        return super().create(self.duration)

    def _extra_status(self) -> Dict[str, object]:
        return {"durationSeconds": self.duration}

    def _collect(self, duration: float) -> bytes:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        tmpdir = tempfile.mkdtemp(prefix="theia-torchprof-")
        try:
            with torch.profiler.profile(activities=acts) as prof:
                time.sleep(duration)
            prof.export_chrome_trace(os.path.join(tmpdir, "trace.json"))
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w:gz") as tar:
                for root, _dirs, files in os.walk(tmpdir):
                    for f in files:
                        full = os.path.join(root, f)
                        tar.add(full,
                                arcname=os.path.relpath(full, tmpdir))
            logger.v(1).info("profile captured: %.1fs", duration)
            return buf.getvalue()
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
