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


def _exact_nn(q, data, mask):
    """numpy float32 1-NN in the kernel's order and tie rule: the least
    (dx dx + dy dy) + dz dz over the unmasked points, the least index of
    a tie; (-1, inf) where none scores below inf."""
    with np.errstate(invalid="ignore"):       # inf - inf
        d = q[:, None, :] - data[None, :, :]
        d = d * d
        d2 = (d[..., 0] + d[..., 1]) + d[..., 2]
    d2 = np.where(mask[None, :] & ~np.isnan(d2), d2, np.float32(np.inf))
    idx = d2.argmin(-1).astype(np.int32)
    best = d2.min(-1)
    ok = best < np.inf
    return np.where(ok, idx, -1), np.where(ok, best, np.float32(np.inf))


@pytest.mark.parametrize("case", ["duplicates", "mask", "all_masked",
                                  "prefix", "nonfinite"])
def test_torch_nn_search_plain_contract(rng, case, monkeypatch):
    """`nn_search` on CPU tensors (`nn_search_plain`) against an exact
    numpy reference bit for bit, and against the JAX package where the
    winner is untied: the least index among exact duplicates of the
    winner, a scattered mask, every point masked (-1 / inf), prefix
    counts that skip the padding of a padded cloud, and NaN or inf
    coordinates, which never win. Chunks of at most 128 queries."""
    from cupoch_tpu_torch.utility import trace
    n, m = 2000, 600
    monkeypatch.setattr(tbf, "_PLAIN_CHUNK_BYTES", 4 * n * 128)
    data = rng.uniform(size=(n, 3)).astype(np.float32)
    q = rng.uniform(size=(m, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    nq, nd = m, n
    if case == "duplicates":
        # the first 100 queries' winners copied to three later slots each;
        # 20 queries sit exactly on a data point (d2 = 0)
        win = _exact_nn(q[:100], data[:n - 300], mask[:n - 300])[0]
        for k, w in enumerate(win):
            data[n - 3 * (k + 1):n - 3 * k] = data[w]
        q[200:220] = data[20:40]
    elif case == "mask":
        mask = rng.uniform(size=n) > 0.5
    elif case == "all_masked":
        mask = np.zeros(n, bool)
    elif case == "nonfinite":
        # NaN and inf never win: a NaN query finds nothing, a query at
        # inf finds nothing, a NaN or inf point is never picked
        q[5], q[6, 1] = np.nan, np.inf
        data[7], data[8, 0] = np.inf, np.nan
        q[9], q[10] = data[7], data[8]
    else:
        nq, nd = 437, 1313
        # beyond the counts: padding that must not be scored
        q[nq:] = 0.0
        data[nd:] = q[0]
        mask = np.arange(n) < nd
    want_i, want_d = _exact_nn(q[:nq], data[:nd], mask[:nd])
    qt, dt, mt = (torch.as_tensor(x) for x in (q, data, mask))
    counts = {} if case != "prefix" else {"n_queries": nq, "n_data": nd}
    tbf.launches = 0
    trace.enable(reset=True)
    try:
        it, d2t = tbf.nn_search(qt, dt, data_mask=mt, **counts)
    finally:
        trace.disable()
    assert tbf.launches == 0      # the CPU runs the plain version
    assert trace.counters()["bruteforce.pairs"] == nq * nd
    it, d2t = it.numpy(), d2t.numpy()
    assert it.dtype == np.int32 and d2t.dtype == np.float32
    assert it.shape == d2t.shape == (m,)
    np.testing.assert_array_equal(it[:nq], want_i)
    np.testing.assert_array_equal(d2t[:nq], want_d)
    if case == "duplicates":
        np.testing.assert_array_equal(it[:100], win)   # never a later copy
        assert (it[200:220] == np.arange(20, 40)).all()
        assert (d2t[200:220] == 0.0).all()
    if case == "all_masked":
        assert (it == -1).all() and np.isinf(d2t).all()
        return
    if case == "nonfinite":
        assert (it[[5, 6, 9, 10]] == -1).all()
        assert (it[:nq] != 7).all() and (it[:nq] != 8).all()
        return
    if case == "prefix":
        # the padded call over the masked padding agrees on the prefix;
        # queries past the count get -1 / inf
        ip, dp = tbf.nn_search(qt, dt, data_mask=mt)
        np.testing.assert_array_equal(it[:nq], ip.numpy()[:nq])
        np.testing.assert_array_equal(d2t[:nq], dp.numpy()[:nq])
        assert (it[nq:] == -1).all() and np.isinf(d2t[nq:]).all()
    ij, d2j = jbf.nn_search(jnp.asarray(q[:nq]), jnp.asarray(data),
                            data_mask=jnp.asarray(mask), tile=256)
    bi, bd = jbf.knn_search(jnp.asarray(q[:nq]), jnp.asarray(data), 2,
                            data_mask=jnp.asarray(mask))
    untied = _untied(np.asarray(bd))
    assert untied.mean() > (0.6 if case == "duplicates" else 0.95)
    np.testing.assert_array_equal(it[:nq][untied], np.asarray(ij)[untied])
    np.testing.assert_allclose(d2t[:nq], np.asarray(d2j), rtol=0, atol=1e-6)


def test_torch_nn_search_checks_its_inputs():
    """The wrapper refuses what the kernel does not take, on any
    device: another dtype or shape, a mask of another length, counts
    outside the clouds, non-contiguous tensors."""
    q, d = torch.zeros(4, 3), torch.zeros(6, 3)
    with pytest.raises(TypeError):
        tbf.nn_search(q.double(), d)
    with pytest.raises(ValueError):
        tbf.nn_search(torch.zeros(4, 2), d)
    with pytest.raises(ValueError):
        tbf.nn_search(q, d, data_mask=torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError):
        tbf.nn_search(q, d, n_data=7)
    with pytest.raises(ValueError):
        tbf.nn_search(q, torch.zeros(3, 6).T)
