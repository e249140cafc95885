"""theia_tpu_torch — the PyTorch/CUDA port of theia_tpu.

A second package beside the JAX one, laid out module for module like
it, so each port file sits where its reference sits
(`theia_tpu_torch/ops/fused_detector.py` ports
`theia_tpu/ops/fused_detector.py`, and so on). It imports torch and
numpy, never jax and never theia_tpu: host-only modules it needs are
kept as copies, held equal to their originals by
tests/test_torch_copies.py.

Ported so far: the live ingest-and-score path (TBLK decode →
ingest-global key remap → per-shard detectors: EWMA/Welford
per-connection scan, Count-Min-Sketch heavy hitters, online k-means →
the alert ring), the batch jobs (TAD, NPR, pattern mining, spatial
and drop detection), the manager that serves them (`python -m
theia_tpu_torch.manager`: POST /ingest through admission, dedup, the
WAL and the parts store; every job kind through the API; /query with
its torch segment reductions under THEIA_QUERY_JAX=1), and the `theia`
CLI (`python -m theia_tpu_torch.cli`, which loads no torch). Every TPU
kernel on those paths is a CUDA C++ kernel under `csrc/`, built with
nvcc at first use (`ops/_build.py`); the rest of their device work is
torch ops.

Device rule: entry points take `device=` (default "cuda") and raise
when CUDA is unavailable unless the caller passed device="cpu"; on a
CPU tensor a kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
