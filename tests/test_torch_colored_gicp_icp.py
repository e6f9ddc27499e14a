"""Colored ICP and Generalized ICP end to end: the port's
`registration_colored_icp` / `registration_generalized_icp` against the
JAX package's on the CPU, on each branch `registration_icp` takes for
them:
- brute force (targets of at most 20k points): the 800-point wavy
  surface of tests/test_icp_variants.py;
- the pooled grid: 25k points in the unit cube, as in
  tests/test_poolgrid.py;
- the dense roll grid (kernel 4 on the card): 30k points in
  [0, 0.42]^3 at r 0.05, whose pool plan is rejected;
- the active-cell grid (kernel 4 too): 15k + 15k points in two 0.1
  cubes at opposite corners of a 2.0 box, at r 0.01.

Both packages get the same numpy clouds. Colored ICP gets the same
normals and colours; GICP gets only points on the brute-force surface
(both packages estimate its normals) and the same normals elsewhere
(normal estimation at full width is in tests/test_torch_normals.py).
The source is an exact rigid copy of the target, so each side must
reach the true pose; poses within 1e-3 of JAX's and of the truth,
fitness within 5e-3 of JAX's. The roll and cell branches run from
tests/test_torch_colored_gicp_roll.py and test_torch_colored_gicp_cell.py
(one file a branch keeps each file near a minute on one worker).
"""
import numpy as np
import jax.numpy as jnp
import pytest

import cupoch_tpu.registration as jreg
from cupoch_tpu.geometry import PointCloud as JPointCloud
import cupoch_tpu_torch.registration as treg
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.knn import cellgrid as tcg
from cupoch_tpu_torch.knn import poolgrid as tpg
from cupoch_tpu_torch.knn import rollgrid as trg
from cupoch_tpu_torch.registration import registration as treg_mod


def _motion(ang, t):
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _colors(pts):
    c = 0.5 + 0.4 * np.sin(4.0 * pts[:, :1]) * np.cos(3.0 * pts[:, 1:2])
    return np.repeat(c, 3, axis=1).astype(np.float32)


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _branch_cloud(rng, branch):
    """(target points, target normals, search radius, true pose)."""
    if branch == "brute":
        xy = rng.uniform(-1, 1, size=(800, 2)).astype(np.float32)
        z = 0.25 * np.sin(2.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
        pts = np.column_stack([xy, z]).astype(np.float32)
        fx = 0.625 * np.cos(2.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
        fy = -0.375 * np.sin(2.5 * xy[:, 0]) * np.sin(1.5 * xy[:, 1])
        nrm = _unit(np.column_stack([-fx, -fy, np.ones_like(fx)]))
        return pts, nrm, 0.2, _motion(0.03, [0.01, -0.015, 0.02])
    if branch == "pool":
        pts = rng.uniform(size=(25000, 3)).astype(np.float32)
        r = 0.04
    elif branch == "roll":
        pts = rng.uniform(0, 0.42, size=(30000, 3)).astype(np.float32)
        r = 0.05
    else:
        a = rng.uniform(0, 0.1, size=(15000, 3))
        b = rng.uniform(1.9, 2.0, size=(15000, 3))
        pts = np.concatenate([a, b]).astype(np.float32)
        return pts, _unit(rng.normal(size=pts.shape)), 0.01, \
            _motion(0.002, [0.001, -0.001, 0.0005])
    return pts, _unit(rng.normal(size=pts.shape)), r, \
        _motion(0.01, [0.003, -0.004, 0.002])


def _taken_branch(pts, r, src):
    """The branch the port's `registration_icp` takes for Colored/GICP."""
    if len(pts) <= treg_mod._GRID_THRESHOLD:
        return "brute"
    if tpg.plan_poolgrid(pts, r, query_points=src,
                         est=tpg.EST_COLORED) is not None:
        return "pool"
    if trg.plan_rollgrid(pts, r) is not None:
        return "roll"
    assert tcg.plan_cellgrid(pts, r) is not None
    return "cell"


def check_branch(rng, branch, est):
    """Both packages' registration on `branch`'s cloud, held to the
    module's limits."""
    tgt, nrm, r, Tgt = _branch_cloud(rng, branch)
    # the source maps onto the target under Tgt: src = R^T (tgt - t)
    src = ((tgt - Tgt[:3, 3]) @ Tgt[:3, :3]).astype(np.float32)
    assert _taken_branch(tgt, r, src) == branch
    jt, js = JPointCloud(jnp.asarray(tgt)), JPointCloud(jnp.asarray(src))
    tt, ts = TPointCloud(tgt, device="cpu"), TPointCloud(src, device="cpu")
    crit = dict(max_iteration=30 if branch == "brute" else 20)
    if est == "colored":
        cols = _colors(tgt)
        jt.normals, jt.colors, js.colors = (jnp.asarray(nrm),
                                            jnp.asarray(cols),
                                            jnp.asarray(cols))
        tt.normals, tt.colors, ts.colors = nrm, cols, cols
        rj = jreg.registration_colored_icp(
            js, jt, r, criteria=jreg.ICPConvergenceCriteria(**crit))
        rt = treg.registration_colored_icp(
            ts, tt, r, criteria=treg.ICPConvergenceCriteria(**crit))
    else:
        if branch != "brute":
            src_n = (nrm @ Tgt[:3, :3]).astype(np.float32)
            jt.normals, js.normals = jnp.asarray(nrm), jnp.asarray(src_n)
            tt.normals, ts.normals = nrm, src_n
        rj = jreg.registration_generalized_icp(
            js, jt, r, criteria=jreg.ICPConvergenceCriteria(**crit))
        rt = treg.registration_generalized_icp(
            ts, tt, r, criteria=treg.ICPConvergenceCriteria(**crit))
    assert np.isfinite(rt.transformation).all()
    assert np.abs(rt.transformation - Tgt).max() < 1e-3
    assert np.abs(rt.transformation - rj.transformation).max() < 1e-3
    assert abs(rt.fitness - rj.fitness) < 5e-3
    assert rt.fitness > 0.99


@pytest.mark.parametrize("branch", ["brute", "pool"])
@pytest.mark.parametrize("est", ["colored", "gicp"])
def test_torch_colored_gicp_icp_matches_jax(rng, branch, est):
    check_branch(rng, branch, est)
