"""PyTorch port of the active-cell grid (cupoch_tpu_torch.knn.cellgrid)
against the JAX package on the CPU.

The cloud is two dense 0.1-cubes at opposite corners of a 2.0 box at
r 0.01: the roll plan rejects it (too many cells) and the cell plan
accepts it. Its point count, 2^15, needs no padding, so no masked
target row exists; the port's LUT sends key C (outside the grid) to
-1 where the JAX package's sends it to a padding slot, and the tests
compare query results, not padding rows (with padding, the JAX grid
lists masked rows as candidates: see the last test and the port's
module note). Distances are held to 2 ulp
(XLA contracts the mirror's d2 into FMAs on the CPU, see
tests/test_torch_rollgrid.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cupoch_tpu.knn import cellgrid as jcg
from cupoch_tpu.knn import rollgrid as jrg
from cupoch_tpu_torch.knn import cellgrid as tcg
from test_torch_rollgrid import _assert_rank_orders_rows

R = 0.01
ULPS = 2


def _two_cubes(rng, n_each=16384):
    a = rng.uniform(size=(n_each, 3)).astype(np.float32) * 0.1
    b = rng.uniform(size=(n_each, 3)).astype(np.float32) * 0.1 + 1.9
    return np.concatenate([a, b])


def _builds(pts):
    plan = jcg.plan_cellgrid(pts, R)
    gj = jcg.build_cellgrid(
        jnp.asarray(pts), jnp.asarray(plan["origin"]), plan["cell_size"],
        jnp.asarray(plan["active"]), plan["dims"], plan["cap"],
        plan["n_active"])
    gt = tcg.build_cellgrid(
        torch.as_tensor(pts), plan["origin"], plan["cell_size"],
        plan["active"], plan["dims"], plan["cap"], plan["n_active"])
    return plan, gj, gt


def _assert_d2_close(dj, dt):
    fin = np.isfinite(dj)
    assert (fin == np.isfinite(dt)).all()
    x = np.abs(dj[fin])
    ulp = np.nextafter(x, np.float32(np.inf)) - x
    assert (np.abs(dt[fin] - dj[fin]) <= ULPS * ulp).all()


def test_torch_cellgrid_plan_identical(rng):
    pts = _two_cubes(rng)
    assert jrg.plan_rollgrid(pts, R) is None
    pj = jcg.plan_cellgrid(pts, R)
    pt = tcg.plan_cellgrid(pts, R)
    assert pj["dims"] == pt["dims"] and pj["cap"] == pt["cap"]
    assert pj["n_active"] == pt["n_active"]
    np.testing.assert_array_equal(pj["active"], pt["active"])
    np.testing.assert_array_equal(pj["origin"], pt["origin"])
    # the active list is padded to a multiple of 8 with the value C
    C = int(np.prod(pt["dims"]))
    assert pt["n_active"] % 8 == 0 and (pt["active"] <= C).all()


@pytest.mark.parametrize("lane_bytes, port_accepts", [(17, False),
                                                     (18, True)])
def test_torch_cellgrid_plan_budget_counts_lane_rank(rng, lane_bytes,
                                                     port_accepts):
    """The cell plan's budget counts the port's 18 bytes a lane (the
    JAX package counts 16), as the roll plan's does."""
    pts = _two_cubes(rng)
    pj = jcg.plan_cellgrid(pts, R)
    kc = -(-27 * pj["cap"] // 128) * 128
    budget = pj["n_active"] * kc * lane_bytes + int(np.prod(pj["dims"])) * 4
    assert jcg.plan_cellgrid(pts, R, mem_budget_bytes=budget) is not None
    pt = tcg.plan_cellgrid(pts, R, mem_budget_bytes=budget)
    assert (pt is not None) == port_accepts
    if port_accepts:
        np.testing.assert_array_equal(pt["active"], pj["active"])


def test_torch_cellgrid_build_matches_jax(rng):
    """Every real active slot's neighbourhood (coordinates and indices)
    equals the JAX build's."""
    pts = _two_cubes(rng)
    plan, gj, gt = _builds(pts)
    C = int(np.prod(plan["dims"]))
    real = plan["active"] < C
    np.testing.assert_array_equal(gt.cand.numpy()[real],
                                  np.asarray(gj.cand)[real])
    np.testing.assert_array_equal(gt.cand_idx.numpy()[real],
                                  np.asarray(gj.cand_idx)[real])
    lut_j = np.asarray(gj.lut)
    np.testing.assert_array_equal(gt.lut.numpy()[:C], lut_j[:C])
    assert (gt.lut.numpy()[C:] == -1).all()


@pytest.mark.parametrize("case", ["shifted", "masked_and_outside"])
def test_torch_query_nn_cellgrid_matches_jax(rng, case):
    pts = _two_cubes(rng)
    plan, gj, gt = _builds(pts)
    q = pts + np.float32([0.002, -0.001, 0.001])
    mask = None
    if case == "masked_and_outside":
        q = np.concatenate([q[:4000], _two_cubes(rng, 500) + 5.0])
        mask = np.ones(q.shape[0], bool)
        mask[::3] = False
    ij, dj = jcg.query_nn_cellgrid(
        gj, jnp.asarray(q), R,
        query_mask=None if mask is None else jnp.asarray(mask))
    it, dt = tcg.query_nn_cellgrid(
        gt, torch.as_tensor(q), R,
        query_mask=None if mask is None else torch.as_tensor(mask))
    ij, dj, it, dt = np.asarray(ij), np.asarray(dj), it.numpy(), dt.numpy()
    assert (ij == it).mean() >= 0.999
    _assert_d2_close(dj, dt)
    if mask is not None:
        assert (it[~mask] == -1).all() and (it[4000:] == -1).all()
    else:
        assert (it >= 0).mean() > 0.99


def test_torch_cellgrid_state_conversion(rng):
    """`CellGrid.from_numpy` of a JAX grid answers queries as the port's
    own build does."""
    pts = _two_cubes(rng, 4096)
    plan, gj, gt = _builds(pts)
    gc = tcg.CellGrid.from_numpy(
        np.asarray(gj.cand), np.asarray(gj.cand_idx), np.asarray(gj.lut),
        np.asarray(gj.origin), np.asarray(gj.cell_size), gj.dims, gj.cap,
        gj.n_active, device="cpu")
    q = torch.as_tensor(pts[::7] + np.float32(0.003))
    for x, y in zip(tcg.query_nn_cellgrid(gc, q, R),
                    tcg.query_nn_cellgrid(gt, q, R)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("source", ["build", "from_numpy"])
def test_torch_cellgrid_lane_rank_orders_rows(rng, source):
    """The lane rank kept beside the cell grid (kernel 4's staging
    order: real lanes first, ascending candidate index) for the port's
    build and for a JAX grid converted with `from_numpy`; queries still
    agree with the JAX package (winners on >= 99.9%, distances within 2
    ulp)."""
    pts = _two_cubes(rng, 4096)
    plan, gj, gt = _builds(pts)
    if source == "from_numpy":
        gt = tcg.CellGrid.from_numpy(
            np.asarray(gj.cand), np.asarray(gj.cand_idx),
            np.asarray(gj.lut), np.asarray(gj.origin),
            np.asarray(gj.cell_size), gj.dims, gj.cap, gj.n_active,
            device="cpu")
    _assert_rank_orders_rows(gt)
    q = pts[::5] + np.float32(0.002)
    ij, dj = jcg.query_nn_cellgrid(gj, jnp.asarray(q), R)
    it, dt = tcg.query_nn_cellgrid(gt, torch.as_tensor(q), R)
    ij, dj, it, dt = np.asarray(ij), np.asarray(dj), it.numpy(), dt.numpy()
    assert (ij == it).mean() >= 0.999
    _assert_d2_close(dj, dt)


def test_torch_cellgrid_masked_rows_never_match(rng):
    """A target padded to its bucket size with masked zero rows: no
    masked row is a candidate of the port's grid, and a query just
    outside the cloud, near the zero rows, finds the real nearest
    target. (The JAX grid lists the masked rows as candidates of the
    boundary cells and matches such a query to a padding row.)"""
    pts = _two_cubes(rng, 15000)
    n = pts.shape[0]
    padded = np.concatenate([pts, np.zeros((32768 - n, 3), np.float32)])
    mask = np.arange(32768) < n
    plan = tcg.plan_cellgrid(pts, R)
    gt = tcg.build_cellgrid(
        torch.as_tensor(padded), plan["origin"], plan["cell_size"],
        plan["active"], plan["dims"], plan["cap"], plan["n_active"],
        mask=torch.as_tensor(mask))
    assert (gt.cand_idx.numpy() < n).all()
    q = np.float32([[-0.001, 0.001, -0.0005]])
    it, dt = tcg.query_nn_cellgrid(gt, torch.as_tensor(q), R)
    d2 = ((pts - q) ** 2).sum(-1)
    assert int(it[0]) == int(np.argmin(d2)) and d2.min() <= R * R
