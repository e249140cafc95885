"""theia_tpu_torch — the PyTorch/CUDA port of theia_tpu.

A second package beside the JAX one, laid out module for module like
it, so each port file sits where its reference sits
(`theia_tpu_torch/ops/fused_detector.py` ports
`theia_tpu/ops/fused_detector.py`, and so on). It imports torch and
numpy, never jax and never theia_tpu: host-only modules it needs are
kept as copies, held equal to their originals by
tests/test_torch_copies.py.

Ported so far (the live ingest-and-score path): TBLK decode →
ingest-global key remap → per-shard detectors (EWMA/Welford
per-connection scan, Count-Min-Sketch heavy hitters, online k-means)
→ the alert ring. Every TPU kernel on that path is a CUDA C++ kernel
under `csrc/`, built with nvcc at first use (`ops/_build.py`).

Device rule: entry points take `device=` (default "cuda") and raise
when CUDA is unavailable unless the caller passed device="cpu"; on a
CPU tensor a kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
