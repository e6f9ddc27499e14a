"""PyTorch port of the dense roll grid (cupoch_tpu_torch.knn.rollgrid)
and of kernel 4's plain version (knn.rollgrid_nn) against the JAX
package on the CPU.

The same numpy inputs, made from the `rng` seed, go through both
packages. The JAX side runs its XLA mirror of the reduce
(`_nn_reduce_xla`), as tests/test_rollgrid.py runs it on the CPU; the
port's reduce on CPU tensors runs `nn_reduce_plain`, which agrees bit
for bit with the CUDA kernel. XLA contracts the JAX mirror's
d2 = dx dx + dy dy + dz dz into two FMAs on the CPU, which drops two of
its five roundings: measured, 80% of distances agree exactly, the rest
differ by 1 ulp and 0.6% by 2. So distances are held to 2 ulp, and
winners to equality except where the two best distances lie within
those 2 ulp.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cupoch_tpu.knn import bruteforce as jbf
from cupoch_tpu.knn import rollgrid as jrg
from cupoch_tpu_torch.knn import rollgrid as trg
from cupoch_tpu_torch.knn import rollgrid_nn


def _cloud(rng, n):
    return rng.uniform(size=(n, 3)).astype(np.float32)


def _builds(tgt, r, **kw):
    plan = jrg.plan_rollgrid(tgt, r, **kw)
    assert plan is not None
    gj = jrg.build_rollgrid(jnp.asarray(tgt), jnp.asarray(plan["origin"]),
                            plan["cell_size"], plan["dims"], plan["cap"])
    gt = trg.build_rollgrid(torch.as_tensor(tgt), plan["origin"],
                            plan["cell_size"], plan["dims"], plan["cap"])
    return gj, gt


ULPS = 2   # the FMA contraction's reach, see the module note


def _ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return ULPS * (np.nextafter(x, np.float32(np.inf)) - x)


def _query_both(gj, gt, q, r, mask=None):
    ij, dj = jrg.query_nn_rollgrid(
        gj, jnp.asarray(q), r,
        query_mask=None if mask is None else jnp.asarray(mask))
    it, dt = trg.query_nn_rollgrid(
        gt, torch.as_tensor(q), r,
        query_mask=None if mask is None else torch.as_tensor(mask))
    return np.asarray(ij), np.asarray(dj), it.numpy(), dt.numpy()


def _assert_d2_close(dj, dt):
    fin = np.isfinite(dj)
    assert (fin == np.isfinite(dt)).all()
    assert (np.abs(dt[fin] - dj[fin]) <= _ulp(dj[fin])).all()


@pytest.mark.parametrize("cloud", ["cube", "slab", "clump"])
def test_torch_rollgrid_plan_identical(rng, cloud):
    pts = _cloud(rng, 6000)
    if cloud == "slab":
        pts[:, 2] *= 0.05
    elif cloud == "clump":
        pts[:500] = 0.5 + 0.001 * rng.normal(size=(500, 3)).astype(
            np.float32)
    for r in (0.05, 0.08):
        pj = jrg.plan_rollgrid(pts, r)
        pt = trg.plan_rollgrid(pts, r)
        assert (pj is None) == (pt is None)
        if pj is None:
            continue
        assert pj["dims"] == pt["dims"] and pj["cap"] == pt["cap"]
        np.testing.assert_array_equal(pj["origin"], pt["origin"])
        assert pj["cell_size"] == pt["cell_size"]


def test_torch_rollgrid_build_matches_jax(rng):
    """cand / cand_idx equal exactly: the same 27 rolls in the same
    order, the same 3e18 fill and KC = 27 cap rounded up to 128."""
    tgt = _cloud(rng, 4000)
    gj, gt = _builds(tgt, 0.06)
    assert gt.cand.shape == tuple(gj.cand.shape)
    assert gt.cand.shape[2] % 128 == 0
    np.testing.assert_array_equal(gt.cand.numpy(), np.asarray(gj.cand))
    np.testing.assert_array_equal(gt.cand_idx.numpy(),
                                  np.asarray(gj.cand_idx))


def test_torch_nn_reduce_plain_matches_xla(rng):
    """nn_reduce_plain against `_nn_reduce_xla` on the same [C, 3, qcap]
    binned queries and grid."""
    tgt = _cloud(rng, 4000)
    q = _cloud(rng, 2500)
    r = 0.06
    gj, _ = _builds(tgt, r)
    soa, _ = jrg._bin_points(jnp.asarray(q), gj.origin, gj.cell_size,
                             gj.dims, gj.cap)
    q_soa = jnp.moveaxis(jnp.where(jnp.isfinite(soa), soa, 1e18), 0, 1)
    r2 = jnp.float32(r) ** 2
    ij, dj = jrg._nn_reduce_xla(q_soa, gj.cand, gj.cand_idx, r2, 8)
    cand_t = torch.tensor(np.asarray(gj.cand))
    it, dt = rollgrid_nn.nn_reduce_plain(
        torch.as_tensor(np.asarray(q_soa)), cand_t,
        torch.as_tensor(np.asarray(gj.cand_idx)),
        torch.tensor(r, dtype=torch.float32) ** 2)
    ij, dj, it, dt = (np.asarray(x) for x in (ij, dj, it, dt))
    _assert_d2_close(dj, dt)
    # where the winners differ, the two best distances lie within ULPS
    differ = ij != it
    if differ.any():
        qs = np.asarray(q_soa).transpose(0, 2, 1)[differ]        # [n, 3]
        c = np.asarray(gj.cand).transpose(0, 2, 1)               # [C, KC, 3]
        cells = np.nonzero(differ)[0]
        d2 = ((qs[:, None, :] - c[cells]) ** 2).sum(-1)
        best2 = np.sort(d2, -1)[:, :2]
        assert (best2[:, 1] - best2[:, 0] <= _ulp(best2[:, 0])).all()
    assert differ.mean() <= 1e-3


def test_torch_query_nn_rollgrid_matches_jax(rng):
    """tests/test_rollgrid.py's geometry: 4000 targets, 2500 queries,
    r 0.06; winners equal on >= 99.9% of queries and both equal the
    brute-force neighbour within r."""
    tgt = _cloud(rng, 4000)
    q = _cloud(rng, 2500)
    r = 0.06
    gj, gt = _builds(tgt, r)
    ij, dj, it, dt = _query_both(gj, gt, q, r)
    assert (ij == it).mean() >= 0.999
    _assert_d2_close(dj, dt)
    bi, bd = jbf.nn_search(jnp.asarray(q), jnp.asarray(tgt))
    brute = np.where(np.asarray(bd) <= r * r, np.asarray(bi), -1)
    assert (it == brute).mean() >= 0.999


@pytest.mark.parametrize("case", ["outside", "mask", "self", "overflow"])
def test_torch_rollgrid_edge_cases_match_jax(rng, case):
    """Queries outside the grid, the query mask, self-query identity and
    cap overflow, each against JAX."""
    if case == "outside":
        tgt = _cloud(rng, 1000)
        gj, gt = _builds(tgt, 0.1)
        q = _cloud(rng, 100) + 50.0
        ij, dj, it, dt = _query_both(gj, gt, q, 0.1)
        assert (it == -1).all() and np.isinf(dt).all()
    elif case == "mask":
        tgt = _cloud(rng, 1000)
        gj, gt = _builds(tgt, 0.1)
        q = tgt[:50]
        mask = np.zeros(50, bool)
        mask[::2] = True
        ij, dj, it, dt = _query_both(gj, gt, q, 0.1, mask)
        assert (it[::2] >= 0).all() and (it[1::2] == -1).all()
    elif case == "self":
        tgt = _cloud(rng, 3000)
        gj, gt = _builds(tgt, 0.05)
        ij, dj, it, dt = _query_both(gj, gt, tgt, 0.05)
        np.testing.assert_array_equal(it, np.arange(3000))
        np.testing.assert_array_equal(dt, 0.0)
    else:
        tgt = np.concatenate([
            np.full((200, 3), 0.5, np.float32)
            + rng.normal(0, 0.001, (200, 3)).astype(np.float32),
            _cloud(rng, 800)])
        gj, gt = _builds(tgt, 0.05, cap_percentile=50.0)
        q = _cloud(rng, 500)
        ij, dj, it, dt = _query_both(gj, gt, q, 0.05)
        ok = it >= 0
        d = np.linalg.norm(q[ok] - tgt[it[ok]], axis=1)
        assert (d <= 0.05 + 1e-6).all()
    np.testing.assert_array_equal(it, ij)
    _assert_d2_close(dj, dt)


def test_torch_rollgrid_state_conversion(rng):
    """`RollGrid.from_numpy` of a JAX grid answers queries as the
    port's own build does."""
    tgt = _cloud(rng, 3000)
    q = _cloud(rng, 1000)
    gj, gt = _builds(tgt, 0.07)
    gc = trg.RollGrid.from_numpy(
        np.asarray(gj.cand), np.asarray(gj.cand_idx), np.asarray(gj.origin),
        np.asarray(gj.cell_size), gj.dims, gj.cap, device="cpu")
    a = trg.query_nn_rollgrid(gc, torch.as_tensor(q), 0.07)
    b = trg.query_nn_rollgrid(gt, torch.as_tensor(q), 0.07)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _assert_rank_orders_rows(grid):
    """cand_rank puts each row in the order kernel 4 stages it: a
    permutation of the row's lanes, the real lanes (index >= 0) first in
    ascending candidate index, the empty lanes after them."""
    ci = grid.cand_idx.numpy()
    rank = grid.cand_rank.numpy().astype(np.int64)
    assert grid.cand_rank.dtype == torch.int16 and rank.shape == ci.shape
    C, KC = ci.shape
    np.testing.assert_array_equal(np.sort(rank, 1),
                                  np.broadcast_to(np.arange(KC), (C, KC)))
    ordered = np.empty_like(ci)
    np.put_along_axis(ordered, rank, ci, 1)
    n_real = (ci >= 0).sum(1)
    real = np.arange(KC)[None, :] < n_real[:, None]
    np.testing.assert_array_equal(ordered >= 0, real)
    step = np.diff(ordered, axis=1)
    assert (step[real[:, 1:]] > 0).all()


@pytest.mark.parametrize("source", ["build", "from_numpy"])
def test_torch_rollgrid_lane_rank_orders_rows(rng, source):
    """The lane rank kept beside the grid, for the port's build and for
    a JAX grid converted with `from_numpy`; the grid still answers
    queries as the JAX package does (winners on >= 99.9%, distances
    within 2 ulp, as test_torch_query_nn_rollgrid_matches_jax)."""
    tgt = _cloud(rng, 3000)
    q = _cloud(rng, 1000)
    gj, gt = _builds(tgt, 0.07)
    if source == "from_numpy":
        gt = trg.RollGrid.from_numpy(
            np.asarray(gj.cand), np.asarray(gj.cand_idx),
            np.asarray(gj.origin), np.asarray(gj.cell_size), gj.dims,
            gj.cap, device="cpu")
    _assert_rank_orders_rows(gt)
    ij, dj, it, dt = _query_both(gj, gt, q, 0.07)
    assert (ij == it).mean() >= 0.999
    _assert_d2_close(dj, dt)


def test_torch_lane_rank_chunks_and_waits_off_the_card(rng, monkeypatch):
    """A grid on the CPU ranks its lanes only when asked (the plain
    reduce never reads the rank), and a rank sorted a few rows at a time
    equals one sorted at once."""
    gt = _builds(_cloud(rng, 3000), 0.07)[1]
    assert gt._cand_rank is None
    whole = gt.cand_rank
    assert gt.cand_rank is whole
    monkeypatch.setattr(rollgrid_nn, "_RANK_CHUNK_LANES",
                        3 * gt.cand_idx.shape[1] + 5)
    assert torch.equal(rollgrid_nn.lane_rank(gt.cand_idx), whole)


@pytest.mark.parametrize("lane_bytes, port_accepts", [(17, False),
                                                     (18, True)])
def test_torch_rollgrid_plan_budget_counts_lane_rank(rng, lane_bytes,
                                                     port_accepts):
    """The plan's memory budget counts the port's 18 bytes a lane (the
    JAX package counts 16): a budget of 17 bytes a lane passes there
    and not here; at 18 both plans agree."""
    pts = _cloud(rng, 6000)
    pj = jrg.plan_rollgrid(pts, 0.07)
    kc = -(-27 * pj["cap"] // 128) * 128
    budget = int(np.prod(pj["dims"])) * kc * lane_bytes
    assert jrg.plan_rollgrid(pts, 0.07, mem_budget_bytes=budget) is not None
    pt = trg.plan_rollgrid(pts, 0.07, mem_budget_bytes=budget)
    assert (pt is not None) == port_accepts
    if port_accepts:
        assert pt["dims"] == pj["dims"] and pt["cap"] == pj["cap"]


def test_torch_nn_reduce_checks_inputs(rng):
    """The wrapper refuses what the kernel does not take, runs the plain
    version on CPU tensors and counts no launch there."""
    q = torch.full((4, 3, 8), 1e18)
    c = torch.full((4, 3, 128), 3e18)
    ci = torch.full((4, 128), -1, dtype=torch.int32)
    before = rollgrid_nn.launches
    idx, d2 = rollgrid_nn.nn_reduce(q, c, ci, 0.01)
    assert rollgrid_nn.launches == before
    assert (idx == -1).all() and torch.isinf(d2).all()
    with pytest.raises(TypeError):
        rollgrid_nn.nn_reduce(q.double(), c, ci, 0.01)
    with pytest.raises(ValueError):
        rollgrid_nn.nn_reduce(q, c[:3], ci[:3], 0.01)
    with pytest.raises(ValueError):
        rollgrid_nn.nn_reduce(q, c, ci, 1e31)
    with pytest.raises(ValueError):
        rollgrid_nn.nn_reduce(q.transpose(1, 2).contiguous().transpose(1, 2),
                              c, ci, 0.01)
