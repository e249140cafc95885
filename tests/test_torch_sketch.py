"""Port parity: theia_tpu_torch.ops.sketch against theia_tpu.ops.sketch.

Inputs are made with numpy from a seed and fed to both packages as
float32 / uint32 arrays; the port runs on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.ops import sketch as ref
from theia_tpu_torch.ops import sketch as port


def _keys(rng, n):
    edge = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF,
                     0xDEADBEEF, 0xFFFFFFFE], np.uint32)
    return np.concatenate([edge, rng.integers(0, 2**32, n, dtype=np.uint64)
                           .astype(np.uint32)])


@pytest.mark.parametrize("depth,width", [(4, 8192), (6, 64), (1, 1)])
def test_cms_slots_bit_exact(depth, width):
    """Hash slots equal the reference's bit for bit (exact), keys 0,
    0xFFFFFFFF and high-bit keys included."""
    keys = _keys(np.random.default_rng(1), 4000)
    want = np.asarray(ref._cms_slots(jnp.asarray(keys), depth, width))
    got = port._cms_slots(port.keys_tensor(keys, "cpu"), depth,
                          width).numpy()
    np.testing.assert_array_equal(got, want)


def test_cms_update_and_query_match_reference():
    """Counters and estimates: exact on the CPU (both scatter-adds
    visit updates in index order). Total: the two frameworks sum the
    float32 volumes in another order, so rtol 1e-6 (a few ulp over
    these 3,000-term sums)."""
    rng = np.random.default_rng(7)
    r, p = ref.cms_init(4, 256), port.cms_init(4, 256, device="cpu")
    for _ in range(3):
        keys = rng.integers(0, 300, 3000).astype(np.uint32)
        vols = rng.uniform(0, 1e6, 3000).astype(np.float32)
        r = ref.cms_update(r, jnp.asarray(keys), jnp.asarray(vols))
        p = port.cms_update(p, port.keys_tensor(keys, "cpu"),
                            torch.from_numpy(vols))
        np.testing.assert_array_equal(p.counts.numpy(),
                                      np.asarray(r.counts))
        np.testing.assert_allclose(p.total.item(), float(r.total),
                                   rtol=1e-6)
        q = np.unique(keys)
        np.testing.assert_array_equal(
            port.cms_query(p, port.keys_tensor(q, "cpu")).numpy(),
            np.asarray(ref.cms_query(r, jnp.asarray(q))))


def test_cms_init_rejects_bad_shapes():
    with pytest.raises(ValueError):
        port.cms_init(depth=7, device="cpu")
    with pytest.raises(ValueError):
        port.cms_init(width=100, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_kmeans_step_matches_reference(masked):
    """Assignments and counts exact; centroids within rtol 1e-5
    (float32 matmuls and reductions in another order). Distances come
    from d2 = |x|² + |c|² − 2x·c, a cancellation of terms near 1e2 here
    whose float32 rounding (~1e-5 absolute) passes into sqrt: atol
    1e-4."""
    rng = np.random.default_rng(3)
    init = rng.normal(0, 1, (8, 4)).astype(np.float32)
    r = ref.kmeans_init(init)
    p = port.kmeans_init(init, "cpu")
    for _ in range(4):
        pts = (rng.normal(0, 1, (512, 4))
               + rng.integers(0, 4, (512, 1)) * 3).astype(np.float32)
        valid = (rng.random(512) < 0.8) if masked else None
        r, ra, rd = ref.kmeans_step(
            r, jnp.asarray(pts),
            None if valid is None else jnp.asarray(valid))
        p, pa, pd = port.kmeans_step(
            p, torch.from_numpy(pts),
            None if valid is None else torch.from_numpy(valid))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(p.counts.numpy(),
                                      np.asarray(r.counts))
        np.testing.assert_allclose(pd.numpy(), np.asarray(rd),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(p.centroids.numpy(),
                                   np.asarray(r.centroids),
                                   rtol=1e-5, atol=1e-6)
