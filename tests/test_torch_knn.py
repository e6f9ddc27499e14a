"""PyTorch port of the k-NN search (cupoch_tpu_torch.knn: the run-grid
k-NN, the hash grid, `search_neighbors`, `KDTreeFlann`) against the JAX
package on the CPU.

k-NN lists are compared as sets per query, since `torch.topk` and XLA's
`top_k` may order equal distances differently; distances within 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import cupoch_tpu.knn as jknn
from cupoch_tpu.knn import gridhash as jgh
from cupoch_tpu.knn import rungrid as jrg
import cupoch_tpu_torch.knn as tknn
from cupoch_tpu_torch.knn import gridhash as tgh
from cupoch_tpu_torch.knn import rungrid as trg

N_BIG = 25000   # above the 20k brute-force limit
N_CACHE = 6000  # a cloud of the grid-cache tests


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(rng, n):
    return rng.uniform(size=(n, 3)).astype(np.float32)


def _from_jax(g):
    return trg.RunGrid.from_numpy(
        *(np.asarray(x) for x in (g.cand, g.attrp, g.negidx, g.bounds,
                                  g.pack_lohi, g.origin, g.cell_size)),
        g.dims, g.cap, g.kc, g.est, device="cpu")


def _assert_same_lists(ij, dj, it, dt, min_rows=0.999):
    """Equal neighbour sets on >= `min_rows` of the rows, distances of
    the sorted lists within 1e-6."""
    ij, dj = np.asarray(ij), np.asarray(dj)
    it, dt = np.asarray(it), np.asarray(dt)
    assert ij.shape == it.shape
    same = np.asarray([set(a[a >= 0]) == set(b[b >= 0])
                       for a, b in zip(ij, it)])
    assert same.mean() >= min_rows
    fin = np.isfinite(dj)
    assert (fin == np.isfinite(dt)).all()
    np.testing.assert_allclose(dt[fin], dj[fin], atol=1e-6)


@pytest.mark.parametrize("k", [1, 30])
def test_torch_knn_rungrid_matches_jax(rng, k):
    """knn_rungrid on the same (JAX-built) grid and queries."""
    data = _cloud(rng, N_BIG)
    q = _cloud(rng, 6000)
    plan = jrg.plan_rungrid(data, 0.04, margin=0.0, query_points=q,
                            cap_percentile=100.0, cap_limit=256)
    gj = jrg.make_rungrid(jnp.asarray(data), jnp.zeros((N_BIG, 0)),
                          plan["origin"], plan["cell_size"], plan["dims"],
                          plan["cap"])
    r = jnp.float32(0.04)
    ij, dj = jrg.knn_rungrid(gj, jnp.asarray(q), k, plan["qcap"], r)
    it, dt = trg.knn_rungrid(_from_jax(gj), torch.as_tensor(q), k,
                             plan["qcap"], np.float32(0.04))
    assert it.dtype == torch.int32 and it.shape == (6000, k)
    _assert_same_lists(ij, dj, it, dt)


@pytest.mark.parametrize("radius", [None, 0.05])
def test_torch_knn_search_grid_matches_jax(rng, radius):
    """knn_search_grid end to end (sizing, acceptance, regrow), pure
    k-NN and radius-bounded, with the port building its own grid."""
    trg.clear_grid_cache()
    jrg.clear_grid_cache()
    data = _cloud(rng, N_BIG)
    q = data[::5] + np.float32(0.001)
    k = 20 if radius is None else 30
    oj = jrg.knn_search_grid(q, data, k, radius=radius)
    ot = trg.knn_search_grid(q, data, k, radius=radius)
    assert oj is not None and ot is not None
    _assert_same_lists(*oj, *ot)


def test_torch_knn_search_grid_cache_sees_edits(rng):
    """The grid cache keys the whole buffer: an edit to one row that the
    JAX key's 64-row sample skips still rebuilds the port's grid, and
    the result matches a search on the edited cloud from scratch."""
    trg.clear_grid_cache()
    data = _cloud(rng, N_BIG)
    q = _cloud(rng, 2000)
    trg.knn_search_grid(q, data, 8)
    assert len(trg._grid_cache) == 1
    step = max(1, N_BIG // 64)
    row = step // 2                    # between two sampled rows
    edited = data.copy()
    edited[row] = q[0]                 # now the nearest point to q[0]
    assert jrg._data_fingerprint(edited, None) == \
        jrg._data_fingerprint(data, None)
    idx, d2 = trg.knn_search_grid(q, edited, 8)
    assert len(trg._grid_cache) == 2
    assert int(idx[0, 0]) == row and float(d2[0, 0]) == 0.0
    trg.clear_grid_cache()
    fresh = trg.knn_search_grid(q, edited, 8)
    assert torch.equal(idx, fresh[0]) and torch.equal(d2, fresh[1])


def test_torch_knn_grid_cache_evicts_by_bytes(rng, monkeypatch, one_thread):
    """Under a byte budget that holds one grid, two large grids evict
    each other (the oldest goes first), a repeated search on the kept
    cloud reuses its grid, and every result equals an uncached search."""
    a, b = _cloud(rng, N_CACHE), _cloud(rng, N_CACHE)
    q = _cloud(rng, 1000)
    trg.clear_grid_cache()
    want = {}
    for name, data in (("a", a), ("b", b)):
        want[name] = trg.knn_search_grid(q, data, 8)
        trg.clear_grid_cache()
    trg.knn_search_grid(q, a, 8)
    (grid_a, _, _), = trg._grid_cache.values()
    monkeypatch.setattr(trg, "_GRID_CACHE_BYTES", grid_a.nbytes * 3 // 2)
    trg.reset_grid_cache_stats()
    kept = [grid_a]
    for name, data in (("b", b), ("a", a), ("a", a), ("b", b)):
        idx, d2 = trg.knn_search_grid(q, data, 8)
        assert torch.equal(idx, want[name][0])
        assert torch.equal(d2, want[name][1])
        assert len(trg._grid_cache) == 1
        (grid, _, _), = trg._grid_cache.values()
        assert grid.nbytes <= trg._GRID_CACHE_BYTES < 2 * grid.nbytes
        kept.append(grid)
    # each new cloud's grid evicted the other's; the repeat was a hit
    assert kept[1] is not kept[0] and kept[2] is not kept[1]
    assert kept[3] is kept[2] and kept[4] is not kept[3]
    stats = dict(trg.grid_cache_stats)
    # a grid over the budget alone is not kept and evicts nothing
    monkeypatch.setattr(trg, "_GRID_CACHE_BYTES", grid_a.nbytes // 2)
    idx, d2 = trg.knn_search_grid(q, a, 8)
    assert torch.equal(idx, want["a"][0]) and torch.equal(d2, want["a"][1])
    assert list(trg._grid_cache.values())[0][0] is kept[4]
    assert trg.grid_cache_stats["refused"] == 1
    assert stats == {"hits": 1, "oldest_hit": 0, "stored": 3,
                     "evicted": 3, "refused": 0, "max_grids": 1,
                     "max_bytes": stats["max_grid_bytes"],
                     "max_grid_bytes": max(g.nbytes for g in kept)}
    trg.clear_grid_cache()


def test_torch_knn_grid_cache_has_no_count_cap(rng, one_thread):
    """Within the byte budget the cache keeps every grid, more than the
    JAX package's four, and each cloud's repeat search is a hit."""
    clouds = [_cloud(rng, N_CACHE) for _ in range(6)]
    q = _cloud(rng, 500)
    trg.clear_grid_cache()
    trg.reset_grid_cache_stats()
    first = [trg.knn_search_grid(q, c, 8) for c in clouds]
    assert len(trg._grid_cache) == 6
    for c, (idx, d2) in zip(clouds, first):
        again = trg.knn_search_grid(q, c, 8)
        assert torch.equal(idx, again[0]) and torch.equal(d2, again[1])
    s = trg.grid_cache_stats
    assert (s["hits"], s["oldest_hit"], s["stored"], s["evicted"],
            s["max_grids"]) == (6, 5, 6, 0, 6)
    assert s["max_bytes"] <= trg._GRID_CACHE_BYTES
    trg.clear_grid_cache()


def test_torch_gridhash_matches_jax(rng):
    """Hash grid build, 1-NN, hybrid k-NN and radius counts, on the
    same points and queries (with a query mask)."""
    data = _cloud(rng, 5000)
    q = _cloud(rng, 1500)
    mask = np.ones(1500, bool)
    mask[::4] = False
    r = 0.06
    gj = jgh.build_grid(jnp.asarray(data), r)
    gt = tgh.build_grid(torch.as_tensor(data), r)
    np.testing.assert_array_equal(gt.bucket_count.numpy(),
                                  np.asarray(gj.bucket_count))
    np.testing.assert_array_equal(gt.bucket_start.numpy(),
                                  np.asarray(gj.bucket_start))
    np.testing.assert_array_equal(gt.sorted_indices.numpy(),
                                  np.asarray(gj.sorted_indices))
    ij, dj = jgh.query_nn(gj, jnp.asarray(q), r,
                          query_mask=jnp.asarray(mask))
    it, dt = tgh.query_nn(gt, torch.as_tensor(q), r,
                          query_mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-7)
    hj = jgh.query_hybrid(gj, jnp.asarray(q), r, 12)
    ht = tgh.query_hybrid(gt, torch.as_tensor(q), r, 12)
    _assert_same_lists(hj[0], hj[1], ht[0], ht[1], min_rows=1.0)
    np.testing.assert_array_equal(ht[2].numpy(), np.asarray(hj[2]))
    np.testing.assert_array_equal(
        tgh.query_radius_count(gt, torch.as_tensor(q), r).numpy(),
        np.asarray(jgh.query_radius_count(gj, jnp.asarray(q), r)))


@pytest.mark.parametrize("n", [3000, N_BIG])
@pytest.mark.parametrize("kind", ["knn", "hybrid"])
def test_torch_search_neighbors_dispatch_matches_jax(rng, n, kind):
    """search_neighbors on both sides of the 20k brute-force limit, for
    k-NN and hybrid parameters, with a padded and masked data side."""
    trg.clear_grid_cache()
    jrg.clear_grid_cache()
    data = _cloud(rng, n)
    cap = 1 << (n - 1).bit_length()
    padded = np.zeros((cap, 3), np.float32)
    padded[:n] = data
    mask = np.arange(cap) < n
    q = data[::3]
    pj = jknn.KDTreeSearchParamKNN(10) if kind == "knn" \
        else jknn.KDTreeSearchParamHybrid(0.05, 16)
    pt = tknn.KDTreeSearchParamKNN(10) if kind == "knn" \
        else tknn.KDTreeSearchParamHybrid(0.05, 16)
    ij, dj = jknn.search_neighbors(jnp.asarray(q), jnp.asarray(padded), pj,
                                   data_mask=jnp.asarray(mask))
    it, dt = tknn.search_neighbors(torch.as_tensor(q),
                                   torch.as_tensor(padded), pt,
                                   data_mask=torch.as_tensor(mask))
    assert it.device.type == "cpu"
    # brute force: the JAX package's split-bf16 ranking may reorder
    # near-equal distances at 2^-24 relative; grids rank in f32 alike
    _assert_same_lists(ij, dj, it, dt, min_rows=0.999)
    assert (it.numpy() < n).all()


def test_torch_kdtreeflann_api(rng):
    """KDTreeFlann's search_knn / search_radius / search_hybrid against
    the JAX class."""
    data = _cloud(rng, 2000)
    tj = jknn.KDTreeFlann(jnp.asarray(data))
    tt = tknn.KDTreeFlann(data, device="cpu")
    q = data[7] + np.float32(0.001)
    for name, args in (("search_knn", (5,)),
                       ("search_radius", (0.08, 20)),
                       ("search_hybrid", (0.08, 10))):
        kj, ij, dj = getattr(tj, name)(q, *args)
        kt, it, dt = getattr(tt, name)(q, *args)
        assert kj == kt
        _assert_same_lists(ij, dj, it, dt, min_rows=1.0)
