"""PyTorch port of the brute-force searches (cupoch_tpu_torch.knn
.bruteforce) against the JAX package on the CPU.

The port computes exact f32 distances; the JAX `nn_search` scores with
an 8+8+8-bit bf16 split, which may pick another winner on ties at about
2^-24 relative. So distances are compared everywhere and indices where
the winner is not tied (its distance differs from the runner-up's).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cupoch_tpu.knn import bruteforce as jbf
from cupoch_tpu_torch.knn import bruteforce as tbf


def _untied(d2_sorted, tol=1e-6):
    """Rows whose first k distances are pairwise apart by more than tol."""
    with np.errstate(invalid="ignore"):
        gaps = np.diff(d2_sorted, axis=-1)
    return ~(np.isfinite(gaps) & (gaps <= tol)).any(-1)


@pytest.mark.parametrize("search", ["nn", "knn", "hybrid"])
def test_torch_bruteforce_matches_jax(rng, search):
    data = rng.uniform(size=(3000, 3)).astype(np.float32)
    q = rng.uniform(size=(700, 3)).astype(np.float32)
    mask = rng.uniform(size=3000) > 0.1
    dj, qj, mj = jnp.asarray(data), jnp.asarray(q), jnp.asarray(mask)
    dt, qt, mt = (torch.as_tensor(x) for x in (data, q, mask))
    if search == "nn":
        ij, d2j = jbf.nn_search(qj, dj, data_mask=mj, tile=256)
        it, d2t = tbf.nn_search(qt, dt, data_mask=mt, tile=256)
        ij, d2j, it, d2t = (np.asarray(x) for x in (ij, d2j, it, d2t))
        assert it.dtype == np.int32 and it.shape == (700,)
        assert mask[it].all()
        # distances exact to f32 rounding; indices equal unless tied
        np.testing.assert_allclose(d2t, d2j, rtol=0, atol=1e-6)
        bi, bd = jbf.knn_search(qj, dj, 2, data_mask=mj)
        untied = _untied(np.asarray(bd))
        assert untied.mean() > 0.99
        np.testing.assert_array_equal(it[untied], ij[untied])
        return
    k = 8
    if search == "knn":
        ij, d2j = jbf.knn_search(qj, dj, k, data_mask=mj, tile=256)
        it, d2t = tbf.knn_search(qt, dt, k, data_mask=mt, tile=256)
    else:
        r = 0.06
        ij, d2j, cj = jbf.hybrid_search(qj, dj, r, k, data_mask=mj, tile=256)
        it, d2t, ct = tbf.hybrid_search(qt, dt, r, k, data_mask=mt, tile=256)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert ct.dtype == torch.int32
    ij, d2j, it, d2t = (np.asarray(x) for x in (ij, d2j, it, d2t))
    assert it.shape == (700, k) and it.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(d2t), np.isfinite(d2j))
    np.testing.assert_array_equal(it < 0, ~np.isfinite(d2t))
    fin = np.isfinite(d2j)
    np.testing.assert_allclose(d2t[fin], d2j[fin], rtol=0, atol=2e-6)
    untied = _untied(np.where(fin, d2j, np.inf))
    assert untied.mean() > 0.9
    np.testing.assert_array_equal(it[untied], ij[untied])


def test_torch_bruteforce_pads_short_rows(rng):
    """k above the data size and fully masked data give -1 / inf."""
    data = rng.uniform(size=(5, 3)).astype(np.float32)
    q = rng.uniform(size=(4, 3)).astype(np.float32)
    it, d2t = tbf.knn_search(torch.as_tensor(q), torch.as_tensor(data), 8)
    ij, d2j = jbf.knn_search(jnp.asarray(q), jnp.asarray(data), 8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), rtol=0,
                               atol=1e-6)
    none = torch.zeros(5, dtype=torch.bool)
    i1, d1 = tbf.nn_search(torch.as_tensor(q), torch.as_tensor(data),
                           data_mask=none)
    assert torch.isinf(d1).all() and i1.shape == (4,)
