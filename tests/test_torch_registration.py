"""PyTorch port of the pooled-grid ICP path (cupoch_tpu_torch
.registration) against the JAX package on the CPU, plus the port's
import hygiene.

The JAX GN passes score in one bf16 pass and flip about 2% of winners
(cupoch_tpu/knn/poolgrid.py:133-141); the port's score in f32. So the
loops are compared by their converged pose and fitness, never by
per-iteration sums.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import cupoch_tpu.registration as jreg
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.knn import poolgrid as jpg
from cupoch_tpu.knn import rungrid as jrg
from cupoch_tpu.registration import estimation as jest
from cupoch_tpu.registration.kabsch import kabsch as jkabsch
from cupoch_tpu.registration.registration import _icp_core as j_icp_core
from cupoch_tpu.registration import fused_icp as jicp
from cupoch_tpu.registration.estimation import (
    TransformationEstimationType as JET,
)
import cupoch_tpu_torch.registration as treg
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.knn import cellgrid as tcellg
from cupoch_tpu_torch.knn import poolgrid as tpg
from cupoch_tpu_torch.knn import rollgrid as trollg
from cupoch_tpu_torch.knn import rungrid as trg
from cupoch_tpu_torch.registration import estimation as test_
from cupoch_tpu_torch.registration import fused_icp as ticp
from cupoch_tpu_torch.registration.estimation import (
    TransformationEstimationType as TET,
)
from cupoch_tpu_torch.utility import eigen as teigen
from cupoch_tpu_torch.utility import transforms as ttf
from cupoch_tpu_torch.visualization import color_map as tcolor_map
from cupoch_tpu.utility import eigen as jeigen
from cupoch_tpu.utility import transforms as jtf

# the module: the package exports the function `kabsch` under its name
tkabsch = importlib.import_module("cupoch_tpu_torch.registration.kabsch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ESTS = ["PointToPoint", "PointToPlane", "SymmetricMethod"]


def _cloud(rng, n):
    return rng.uniform(size=(n, 3)).astype(np.float32)


def _normals(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _rigid_pair(rng, m, ang, t):
    tgt = _cloud(rng, m)
    tn = _normals(rng, m)
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.float32(t)
    # with row-vector sources src = (tgt - t) @ R, the aligning
    # transform is [R | t]
    src = (tgt - t) @ R
    Tgt = np.eye(4, dtype=np.float32)
    Tgt[:3, :3] = R
    Tgt[:3, 3] = t
    return tgt, tn, src, Tgt


# ---------------------------------------------------------------------------
# utility
# ---------------------------------------------------------------------------

def test_torch_solve_jacobian_system_matches_jax(rng):
    J = rng.normal(size=(50, 6)).astype(np.float32)
    r = rng.normal(size=50).astype(np.float32) * 0.01
    JTJ = (J.T @ J).astype(np.float32)
    JTr = (J.T @ r).astype(np.float32)
    okj, Tj = jeigen.solve_jacobian_system(jnp.asarray(JTJ),
                                           jnp.asarray(JTr))
    okt, Tt = teigen.solve_jacobian_system(torch.as_tensor(JTJ),
                                           torch.as_tensor(JTr))
    assert bool(okj) and bool(okt)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6)
    # a singular system falls back to the identity in both
    okj, Tj = jeigen.solve_jacobian_system(jnp.zeros((6, 6)),
                                           jnp.asarray(JTr))
    okt, Tt = teigen.solve_jacobian_system(torch.zeros(6, 6),
                                           torch.as_tensor(JTr))
    assert not bool(okj) and not bool(okt)
    np.testing.assert_array_equal(Tt.numpy(), np.asarray(Tj))


def test_torch_transforms_match_jax(rng):
    x = (rng.normal(size=6) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        ttf.transform_vector6_to_matrix4(torch.as_tensor(x)).numpy(),
        np.asarray(jtf.transform_vector6_to_matrix4(jnp.asarray(x))),
        atol=1e-6)
    T = np.array(jtf.transform_vector6_to_matrix4(jnp.asarray(x)))
    p = _cloud(rng, 100)
    np.testing.assert_allclose(
        ttf.transform_points(torch.as_tensor(T), torch.as_tensor(p)).numpy(),
        np.asarray(jtf.transform_points(jnp.asarray(T), jnp.asarray(p))),
        atol=1e-6)


@pytest.mark.parametrize("est_name", ESTS)
def test_torch_update_from_sums_matches_jax(rng, est_name):
    """The host-side Kabsch / GN updates from reduced sums."""
    tgt, tn, src, _ = _rigid_pair(rng, 500, 0.01, [0.002, -0.001, 0.003])
    s = np.zeros(32, np.float32)
    if est_name == "PointToPoint":
        s[0] = 500
        s[1:4] = src.sum(0)
        s[4:7] = tgt.sum(0)
        s[7:16] = (src.T @ tgt).reshape(-1)
    else:
        J = np.concatenate([np.cross(src, tn), tn], -1)
        r = ((src - tgt) * tn).sum(-1)
        s[:21] = (J.T @ J)[np.triu_indices(6)]
        s[21:27] = J.T @ r
    Uj = jicp._update_from_sums(JET[est_name], jnp.asarray(s))
    Ut = ticp._update_from_sums(TET[est_name], torch.as_tensor(s))
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=2e-5)


# ---------------------------------------------------------------------------
# the ICP loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("est_name", ESTS)
def test_torch_icp_core_pool_matches_jax(rng, est_name):
    m = 6000
    tgt, tn, src, Tgt = _rigid_pair(rng, m, 0.015, [0.004, -0.006, 0.002])
    radius = 0.05
    mask = np.ones(m, bool)
    attrs_j, code = jicp.make_target_attrs(JET[est_name], jnp.asarray(tgt),
                                           jnp.asarray(tn))
    plan = jpg.plan_poolgrid(tgt, radius, query_points=src, est=code)
    gj = jpg.make_poolgrid(
        jnp.asarray(tgt), attrs_j, plan["origin"], plan["cell_size"],
        plan["dims"], plan["cap"], plan["kc"], est=code,
        tile=plan["tile"], mask=jnp.asarray(mask))
    Tj, idxj, fitj, rmsej, itj, _ = jicp.icp_core_pool(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(tn), gj,
        jnp.eye(4, dtype=jnp.float32), jnp.float32(radius),
        plan["rebin_margin"], jnp.float32(1e-6), jnp.float32(1e-6),
        plan["qp"], JET[est_name], 20, use_pallas=False)

    attrs_t, _ = ticp.make_target_attrs(TET[est_name], torch.as_tensor(tgt),
                                        torch.as_tensor(tn))
    gt = tpg.make_poolgrid(
        torch.as_tensor(tgt), attrs_t, plan["origin"], plan["cell_size"],
        plan["dims"], plan["cap"], plan["kc"], est=code,
        tile=plan["tile"], mask=torch.as_tensor(mask))
    Tt, idxt, fitt, rmset, itt, nqt = ticp.icp_core_pool(
        torch.as_tensor(src), torch.as_tensor(mask), torch.as_tensor(tn),
        gt, torch.eye(4), radius, plan["rebin_margin"], 1e-6, 1e-6,
        plan["qp"], TET[est_name], 20)

    Tt = Tt.numpy()
    assert np.abs(Tt - Tgt).max() < 5e-4
    assert np.abs(Tt - np.asarray(Tj)).max() < 1e-3
    assert abs(float(fitt) - float(fitj)) < 5e-3
    assert float(fitt) > 0.99
    assert 0 < itt <= 20
    assert idxt.shape == (m,) and idxt.dtype == torch.int32


def test_torch_registration_icp_matches_jax(rng):
    """The public entry on a target above the brute-force threshold, so
    both packages take the pooled-grid branch."""
    m = 24000
    tgt, tn, src, Tgt = _rigid_pair(rng, m, 0.01, [0.003, -0.004, 0.002])
    radius = 0.05
    jt, js = JPointCloud(jnp.asarray(tgt)), JPointCloud(jnp.asarray(src))
    jt.normals = jnp.asarray(tn)
    tt = TPointCloud(tgt, device="cpu")
    ts = TPointCloud(src, device="cpu")
    tt.normals = tn
    assert m > jreg.registration._GRID_THRESHOLD
    rj = jreg.registration_icp(
        js, jt, radius,
        estimation=jreg.TransformationEstimationPointToPlane(),
        criteria=jreg.ICPConvergenceCriteria(max_iteration=20))
    rt = treg.registration_icp(
        ts, tt, radius,
        estimation=treg.TransformationEstimationPointToPlane(),
        criteria=treg.ICPConvergenceCriteria(max_iteration=20))
    assert np.abs(rt.transformation - Tgt).max() < 5e-4
    assert np.abs(rt.transformation - rj.transformation).max() < 1e-3
    assert abs(rt.fitness - rj.fitness) < 5e-3
    assert abs(rt.inlier_rmse - rj.inlier_rmse) < 1e-4
    assert rt.n_dropped_target == rj.n_dropped_target
    assert rt.n_dropped_queries == rj.n_dropped_queries
    assert 0 < rt.iterations <= 20
    cj = {tuple(r) for r in rj.correspondence_set}
    ct = {tuple(r) for r in rt.correspondence_set}
    assert len(cj & ct) >= 0.995 * max(len(cj), len(ct))


@pytest.mark.parametrize("branch", ["ColoredICP", "GeneralizedICP",
                                    "grids_reject"])
def test_torch_registration_icp_former_unported_branches_match_jax(
        rng, branch):
    """The branches earlier slices left raising, against the JAX
    package: Colored and Generalized ICP through `registration_icp` on a
    1000-point wavy surface (brute force), and a 21k-point target that
    every grid plan rejects, which takes the brute-force fallback (at
    most 200k points). Poses within 1e-3 of JAX's and of the truth,
    fitness within 5e-3 of JAX's."""
    if branch == "grids_reject":
        # 21k points in a 0.15 cube: every grid cell would need a cap
        # above 128
        tgt, tn, src, Tgt = _rigid_pair(rng, 21000, 0.01,
                                        [0.002, -0.001, 0.0015])
        tgt, src = tgt * 0.15, src * 0.15
        Tgt[:3, 3] *= 0.15
        r = 0.05
        assert tpg.plan_poolgrid(tgt, r, query_points=src) is None
        assert trg.plan_rungrid(tgt, r, query_points=src) is None
        assert trollg.plan_rollgrid(tgt, r) is None
        assert tcellg.plan_cellgrid(tgt, r) is None
        jest_, test_est = None, None
    else:
        xy = rng.uniform(-1, 1, size=(1000, 2)).astype(np.float32)
        z = 0.25 * np.sin(2.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
        tgt = np.column_stack([xy, z]).astype(np.float32)
        Tgt = np.eye(4, dtype=np.float32)
        ang = 0.03
        Tgt[:2, :2] = [[np.cos(ang), -np.sin(ang)],
                       [np.sin(ang), np.cos(ang)]]
        Tgt[:3, 3] = [0.01, -0.015, 0.02]
        src = ((tgt - Tgt[:3, 3]) @ Tgt[:3, :3]).astype(np.float32)
        tn = _normals(rng, 1000)
        r = 0.2
        jest_ = getattr(jreg, "TransformationEstimationFor" + branch)()
        test_est = getattr(treg, "TransformationEstimationFor" + branch)()
    jt, js = JPointCloud(jnp.asarray(tgt)), JPointCloud(jnp.asarray(src))
    tt, ts = TPointCloud(tgt, device="cpu"), TPointCloud(src, device="cpu")
    if branch == "ColoredICP":
        c = 0.5 + 0.4 * np.sin(4.0 * tgt[:, :1]) * np.cos(3.0 * tgt[:, 1:2])
        cols = np.repeat(c, 3, axis=1).astype(np.float32)
        jt.normals, jt.colors, js.colors = (jnp.asarray(tn),
                                            jnp.asarray(cols),
                                            jnp.asarray(cols))
        tt.normals, tt.colors, ts.colors = tn, cols, cols
    rj = jreg.registration_icp(
        js, jt, r, estimation=jest_,
        criteria=jreg.ICPConvergenceCriteria(max_iteration=30))
    rt = treg.registration_icp(
        ts, tt, r, estimation=test_est,
        criteria=treg.ICPConvergenceCriteria(max_iteration=30))
    assert np.abs(rt.transformation - Tgt).max() < 1e-3
    assert np.abs(rt.transformation - rj.transformation).max() < 1e-3
    assert abs(rt.fitness - rj.fitness) < 5e-3
    assert rt.fitness > 0.99


@pytest.mark.parametrize("est_name", ESTS)
def test_torch_kabsch_and_gn_updates_match_jax(rng, est_name):
    """The per-pair updates of the generic loop, and the Kabsch entry
    with a correspondence list, on the same pairs (tolerance 2e-5)."""
    tgt, tn, src, _ = _rigid_pair(rng, 400, 0.02, [0.004, -0.002, 0.003])
    sn = _normals(rng, 400)
    w = (rng.uniform(size=400) > 0.2).astype(np.float32)
    fn = {"PointToPoint": "update_point_to_point",
          "PointToPlane": "update_point_to_plane",
          "SymmetricMethod": "update_symmetric"}[est_name]
    Uj = getattr(jest, fn)(*(jnp.asarray(x) for x in (src, tgt, tn, sn, w)))
    Ut = getattr(test_, fn)(*(torch.as_tensor(x)
                              for x in (src, tgt, tn, sn, w)))
    assert Ut.device.type == "cpu" and Ut.dtype == torch.float32
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=2e-5)
    if est_name == "PointToPoint":
        corres = np.stack([np.arange(400), np.arange(400)], -1)
        corres[w == 0] = -1
        Kj = jkabsch(jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(corres))
        Kt = tkabsch.kabsch(torch.as_tensor(src), torch.as_tensor(tgt),
                            torch.as_tensor(corres))
        np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), atol=2e-5)
        np.testing.assert_allclose(Kt.numpy(), Ut.numpy(), atol=2e-5)
    else:
        J = np.concatenate([np.cross(src, tn), tn], -1)
        r = ((src - tgt) * tn).sum(-1)
        Gj = jest._gn_update(*(jnp.asarray(x) for x in (J, r, w)))
        Gt = test_._gn_update(*(torch.as_tensor(x) for x in (J, r, w)))
        np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), atol=2e-5)


@pytest.mark.parametrize("est_name", ESTS)
def test_torch_icp_core_rungrid_matches_jax(rng, est_name):
    """The run-grid loop called directly on grids built by each package
    from the same cloud (pose 1e-4, fitness 1e-3)."""
    n = 4000
    tgt, tn, src, Tgt = _rigid_pair(rng, n, 0.03, [0.012, -0.008, 0.004])
    src_n = tn @ Tgt[:3, :3] if est_name == "SymmetricMethod" \
        else _normals(rng, n)
    r = 0.07
    mask = np.ones(n, bool)
    aj, code = jicp.make_target_attrs(JET[est_name], jnp.asarray(tgt),
                                      jnp.asarray(tn))
    plan = jrg.plan_rungrid(tgt, r, margin=0.25, query_points=src)
    gj = jrg.make_rungrid(jnp.asarray(tgt), aj, plan["origin"],
                          plan["cell_size"], plan["dims"], plan["cap"],
                          est=code)
    Tj, idxj, fitj, rmsej, itj = jicp.icp_core_rungrid(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(src_n), gj,
        jnp.eye(4, dtype=jnp.float32), jnp.float32(r),
        plan["rebin_margin"], jnp.float32(1e-6), jnp.float32(1e-6),
        plan["qcap"], JET[est_name], 30)
    at, _ = ticp.make_target_attrs(TET[est_name], torch.as_tensor(tgt),
                                   torch.as_tensor(tn))
    gt = trg.make_rungrid(torch.as_tensor(tgt), at, plan["origin"],
                          plan["cell_size"], plan["dims"], plan["cap"],
                          est=code)
    Tt, idxt, fitt, rmset, itt = ticp.icp_core_rungrid(
        torch.as_tensor(src), torch.as_tensor(mask),
        torch.as_tensor(src_n.astype(np.float32)), gt, torch.eye(4), r,
        plan["rebin_margin"], 1e-6, 1e-6, plan["qcap"], TET[est_name], 30)
    Tt = Tt.numpy()
    assert np.abs(Tt - np.asarray(Tj)).max() < 1e-4
    assert np.abs(Tt - Tgt).max() < 2e-3
    assert abs(float(fitt) - float(fitj)) < 1e-3 and float(fitt) > 0.97
    assert abs(float(rmset) - float(rmsej)) < 1e-4
    assert 0 < itt <= 30 and abs(itt - int(itj)) <= 2
    assert idxt.shape == (n,) and idxt.dtype == torch.int32
    same = (idxt.numpy() == np.asarray(idxj)).mean()
    assert same >= 0.995


def test_torch_registration_icp_fallback_matches_jax(rng):
    """The public entry on a target above the grid threshold whose pool
    plan is rejected (cells would need a cap above 128), so both
    packages take the run-grid fallback: 30k points in [0, 0.43]^3
    (pose 1e-4, correspondences >= 99.5% equal)."""
    m = 30000
    tgt, tn, src, Tgt = _rigid_pair(rng, m, 0.01, [0.003, -0.004, 0.002])
    tgt, src = tgt * 0.43, src * 0.43
    Tgt[:3, 3] *= 0.43
    radius = 0.05
    assert tpg.plan_poolgrid(tgt, radius, query_points=src,
                             est=tpg.EST_PT2PL) is None
    assert trg.plan_rungrid(tgt, radius, query_points=src) is not None
    crit = dict(max_iteration=4)
    jt, js = JPointCloud(jnp.asarray(tgt)), JPointCloud(jnp.asarray(src))
    jt.normals = jnp.asarray(tn)
    tt, ts = TPointCloud(tgt, device="cpu"), TPointCloud(src, device="cpu")
    tt.normals = tn
    rj = jreg.registration_icp(
        js, jt, radius,
        estimation=jreg.TransformationEstimationPointToPlane(),
        criteria=jreg.ICPConvergenceCriteria(**crit))
    rt = treg.registration_icp(
        ts, tt, radius,
        estimation=treg.TransformationEstimationPointToPlane(),
        criteria=treg.ICPConvergenceCriteria(**crit))
    assert np.abs(rt.transformation - rj.transformation).max() < 1e-4
    assert np.abs(rt.transformation - Tgt).max() < 1e-3
    assert abs(rt.fitness - rj.fitness) < 1e-3 and rt.fitness > 0.99
    assert abs(rt.inlier_rmse - rj.inlier_rmse) < 1e-5
    assert 0 < rt.iterations <= 4
    cj = {tuple(r) for r in rj.correspondence_set}
    ct = {tuple(r) for r in rt.correspondence_set}
    assert len(cj & ct) >= 0.995 * max(len(cj), len(ct))


@pytest.mark.parametrize("est_name", ESTS)
def test_torch_registration_icp_bruteforce_matches_jax(rng, est_name):
    """The public entry on a target of 20k points or fewer: both take
    the brute-force branch of the generic loop (pose 1e-4)."""
    m = 3000
    tgt, tn, src, Tgt = _rigid_pair(rng, m, 0.02, [0.006, -0.004, 0.003])
    sn = tn @ Tgt[:3, :3]
    radius = 0.08
    jt, js = JPointCloud(jnp.asarray(tgt)), JPointCloud(jnp.asarray(src))
    jt.normals, js.normals = jnp.asarray(tn), jnp.asarray(sn)
    tt, ts = TPointCloud(tgt, device="cpu"), TPointCloud(src, device="cpu")
    tt.normals, ts.normals = tn, sn
    est = "TransformationEstimation" + est_name
    rj = jreg.registration_icp(js, jt, radius,
                               estimation=getattr(jreg, est)(),
                               criteria=jreg.ICPConvergenceCriteria(
                                   max_iteration=30))
    rt = treg.registration_icp(ts, tt, radius,
                               estimation=getattr(treg, est)(),
                               criteria=treg.ICPConvergenceCriteria(
                                   max_iteration=30))
    assert np.abs(rt.transformation - rj.transformation).max() < 1e-4
    assert np.abs(rt.transformation - Tgt).max() < 1e-3
    assert abs(rt.fitness - rj.fitness) < 1e-3 and rt.fitness > 0.99
    assert abs(rt.inlier_rmse - rj.inlier_rmse) < 1e-5
    assert 0 < rt.iterations <= 30
    cj = {tuple(r) for r in rj.correspondence_set}
    ct = {tuple(r) for r in rt.correspondence_set}
    assert len(cj & ct) >= 0.999 * max(len(cj), len(ct))


def test_torch_icp_core_generic_loop_matches_jax(rng):
    """The generic loop called directly: the same iteration count and
    pose as the JAX while_loop, and max_iteration=0 evaluates only."""
    m = 2000
    tgt, tn, src, _ = _rigid_pair(rng, m, 0.02, [0.006, -0.004, 0.003])
    mask = np.ones(m, bool)
    z = np.zeros_like(tgt)
    args_j = [jnp.asarray(x) for x in (src, mask, z, tgt, mask, tn)]
    args_t = [torch.as_tensor(x) for x in (src, mask, z, tgt, mask, tn)]
    for iters in (0, 25):
        Tj, idxj, fitj, rmsej, itj = j_icp_core(
            *args_j, jnp.eye(4, dtype=jnp.float32), jnp.float32(0.08),
            jnp.float32(1e-6), jnp.float32(1e-6), JET.PointToPlane, iters,
            False)
        Tt, idxt, fitt, rmset, itt = treg.registration._icp_core(
            *args_t, torch.eye(4), 0.08, 1e-6, 1e-6, TET.PointToPlane, iters)
        assert itt == int(itj)
        assert np.abs(Tt.numpy() - np.asarray(Tj)).max() < 1e-4
        assert abs(float(fitt) - float(fitj)) < 1e-3
        assert abs(float(rmset) - float(rmsej)) < 1e-5
        assert (idxt.numpy() == np.asarray(idxj)).mean() >= 0.999


@pytest.mark.parametrize("branch", ["grid", "bruteforce"])
def test_torch_evaluate_registration_matches_jax(rng, branch):
    """One correspondence pass at a given pose: the run grid above the
    grid threshold, brute force below it (fitness and rmse 1e-5,
    correspondences >= 99.9% equal)."""
    m = 24000 if branch == "grid" else 5000
    tgt, _, src, Tgt = _rigid_pair(rng, m, 0.01, [0.002, -0.003, 0.001])
    # a third of the source moved far off: those points find no match
    src[::3] += np.float32(5.0)
    T = Tgt.copy()
    T[:3, 3] += np.float32([0.003, 0.0, -0.002])
    radius = 0.04
    assert (m > jreg.registration._GRID_THRESHOLD) == (branch == "grid")
    if branch == "grid":
        assert trg.plan_rungrid(tgt, radius, margin=0.0,
                                query_points=src) is not None
    rj = jreg.evaluate_registration(JPointCloud(jnp.asarray(src)),
                                    JPointCloud(jnp.asarray(tgt)), radius,
                                    T)
    rt = treg.evaluate_registration(TPointCloud(src, device="cpu"),
                                    TPointCloud(tgt, device="cpu"), radius, T)
    assert 0.6 < rt.fitness < 0.7
    assert abs(rt.fitness - rj.fitness) < 1e-5
    assert abs(rt.inlier_rmse - rj.inlier_rmse) < 1e-5
    np.testing.assert_array_equal(rt.transformation, T)
    cj = {tuple(r) for r in rj.correspondence_set}
    ct = {tuple(r) for r in rt.correspondence_set}
    assert len(cj & ct) >= 0.999 * max(len(cj), len(ct))


def test_torch_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPointCloud(np.zeros((4, 3), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcolor_map.get_color_map_color(np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcolor_map.color_map_hot([0.5])


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_torch_port_imports_no_jax():
    """Every module of the port (also those imported only lazily) and
    chip_smoke.py import neither jax nor the JAX package (the ranks that
    `parallel.launch` spawns: test_torch_sharded.py), nor matplotlib,
    which only a render imports."""
    code = ("import importlib, pkgutil, sys; import cupoch_tpu_torch, "
            "chip_smoke; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "cupoch_tpu_torch.__path__, 'cupoch_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert len(mods) >= 100, mods; "
            "assert {'cupoch_tpu_torch.' + p for p in ('camera', "
            "'odometry', 'integration', 'kinfu', 'collision', 'planning', "
            "'kinematics', 'imageproc', 'io', 'bench', 'bench.scaling', "
            "'parallel', 'parallel.collectives', 'parallel.launch', "
            "'parallel.sharded', 'slam', 'slam.pose_graph', "
            "'slam.bundle_adjustment', 'slam.checkpoint', 'slam.slam', "
            "'bench.harness', 'visualization', 'visualization.color_map', "
            "'visualization.render_option', 'visualization.view_trajectory', "
            "'visualization.html_viewer', 'visualization.visualizer')} "
            "<= set(mods), mods; "
            "bad = [m for m in sys.modules if m in ('jax', 'cupoch_tpu', "
            "'matplotlib') or m.startswith(('jax.', 'cupoch_tpu.', "
            "'matplotlib.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
