"""The port's features and global registration
(cupoch_tpu_torch.registration.{feature,fast_global_registration,shot},
cupoch_tpu_torch.geometry.keypoint) against the JAX package on the same
numpy inputs, on the CPU (brute-force branches, at most 600 points).

Tolerances, each stated where it is used:
- FPFH: f0 comes from `atan2`, every bin from `floor` and the roles of
  a pair's two points from a comparison, and XLA on the CPU contracts
  products into fused multiply-adds, so one pair can land in another
  bin in one package only. Per point, the SPFH is equal within 1e-4
  relative or differs by one pair's weight moved between bins
  (`chip_smoke.fpfh_moved_pairs`); the FPFH is equal within 1e-4
  relative wherever no such moved pair reaches it;
- feature-space nearest neighbours and correspondences: equal, except
  where the reference's pick is an f32 near-tie: the port ranks in
  f64, and a differing pick is never more than 4 f32 ulps of
  |q|^2 + |d|^2 farther (in f64) than the port's;
- FGR on the reference's own tuple draws (`PRNGKey(0)`) and feature
  matches, injected: pose within 1e-4; FGR with the port's own draws:
  within 0.05 of the true pose, as tests/test_feature.py holds the
  reference;
- SHOT: within 1e-4 of the reference's unit descriptors;
- ISS: keep masks equal where the saliency is above f32 noise (see
  the test).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import cupoch_tpu as cph
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.geometry import compute_iss_keypoints as j_iss
from cupoch_tpu.knn import KDTreeSearchParamHybrid as JHybrid
from cupoch_tpu.knn import KDTreeSearchParamKNN as JKNN
from cupoch_tpu.knn import search_neighbors as j_search
from cupoch_tpu.registration import feature as jfeat
from cupoch_tpu.registration import (FastGlobalRegistrationOption as JOpt,
                                     compute_shot_feature as j_shot,
                                     correspondences_from_features as j_cff,
                                     fast_global_registration as j_fgr)
import cupoch_tpu_torch.registration as treg
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.geometry import compute_iss_keypoints as t_iss
from cupoch_tpu_torch.knn import KDTreeSearchParamHybrid as THybrid
from cupoch_tpu_torch.knn import KDTreeSearchParamKNN as TKNN
tfgr = importlib.import_module(
    "cupoch_tpu_torch.registration.fast_global_registration")
from cupoch_tpu_torch.registration import feature as tfeat
from torch_port_bridge import cloud as to_port
from torch_port_bridge import feature as to_port_feature
from torch_port_bridge import fgr_option, inject_jax_fgr_choices

CPU = "cpu"


def _make_cloud(n=400, seed=3):
    """tests/test_feature.py's bumpy surface, normals by the JAX
    package (KNN 12)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    z = 0.3 * np.sin(3.0 * xy[:, 0]) * np.cos(2.0 * xy[:, 1])
    pcd = JPointCloud(np.column_stack([xy, z]).astype(np.float32))
    pcd.estimate_normals(JKNN(12))
    return pcd


def _rot_z(ang):
    return np.asarray([[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("param", ["hybrid", "knn"])
def test_torch_fpfh_matches_jax(param):
    jp = _make_cloud()
    tp = to_port(jp)
    jparam, tparam = (JHybrid(0.5, 30), THybrid(0.5, 30)) \
        if param == "hybrid" else (JKNN(20), TKNN(20))
    idx_j, d2_j = j_search(jp.points, jp.points, jparam)
    idx_t, d2_t = treg.feature.search_neighbors(tp.points, tp.points, tparam)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    spfh_j = np.asarray(jfeat._spfh(jp.points, jp.normals, idx_j))
    spfh_t = tfeat._spfh(tp.points, tp.normals, idx_t).numpy()
    cnt = (np.asarray(idx_j) >= 0).sum(-1)
    close, moved = cs.fpfh_moved_pairs(np, spfh_j, spfh_t,
                                       100.0 / np.maximum(cnt - 1.0, 1.0))
    assert (close | moved).all()
    assert moved.sum() <= 0.01 * len(spfh_j)
    # the weighting stage alone, on the reference's SPFH
    fj = np.asarray(jfeat._fpfh(jnp.asarray(spfh_j), idx_j, d2_j))
    ft = tfeat._fpfh(torch.as_tensor(np.array(spfh_j)), idx_t, d2_t).numpy()
    np.testing.assert_allclose(ft, fj, rtol=1e-4,
                               atol=1e-4 * np.abs(fj).max())
    # end to end, wherever no moved pair reaches the point
    fj = np.asarray(jfeat.compute_fpfh_feature(jp, jparam).data).T
    ft = treg.compute_fpfh_feature(tp, tparam).data.numpy().T
    idx = np.asarray(idx_j)
    reached = moved[np.where(idx >= 0, idx, 0)].any(-1) & (idx >= 0).any(-1)
    reached |= moved
    np.testing.assert_allclose(ft[~reached], fj[~reached], rtol=1e-4,
                               atol=1e-4 * np.abs(fj).max())


def test_torch_fpfh_requires_normals():
    pcd = TPointCloud(np.random.rand(10, 3).astype(np.float32), device=CPU)
    with pytest.raises(RuntimeError):
        treg.compute_fpfh_feature(pcd)
    f = treg.Feature(np.zeros((33, 7), np.float32), device=CPU)
    assert (f.dimension(), f.num(), f.is_empty()) == (33, 7, False)
    assert treg.Feature(device=CPU).is_empty()


def near_tie_only(q, d, want, got):
    """Rows where the reference's pick differs are f32 near-ties: in
    f64 its target lies at most 4 f32 ulps of |q|^2 + |d|^2 farther
    than the port's. Returns the share of differing rows."""
    rows = np.nonzero(want != got)[0]
    q, d = q.astype(np.float64), d.astype(np.float64)
    dw = ((q[rows] - d[want[rows]]) ** 2).sum(-1)
    dg = ((q[rows] - d[got[rows]]) ** 2).sum(-1)
    scale = (q[rows] ** 2).sum(-1) + (d[want[rows]] ** 2).sum(-1)
    assert (dg <= dw).all()
    assert (dw - dg <= 4 * 2.0 ** -23 * scale).all()
    return len(rows) / max(len(want), 1)


@pytest.mark.parametrize("mutual", [False, True])
def test_torch_feature_correspondences_match_jax(rng, mutual):
    """Feature-space 1-NN and the correspondence sets, on random
    features (equal) and on FPFH of a cloud and its moved copy (equal
    but for f32 near-ties of the reference, at most 5% of rows)."""
    a = rng.normal(size=(33, 300)).astype(np.float32)
    b = (a[:, rng.permutation(300)] + rng.normal(size=(33, 300)) * 0.3) \
        .astype(np.float32)
    nn_j = np.asarray(jfeat._feature_nn(jnp.asarray(a.T), jnp.asarray(b.T)))
    nn_t = tfeat._feature_nn(torch.as_tensor(a.T), torch.as_tensor(b.T))
    np.testing.assert_array_equal(nn_t.numpy(), nn_j)
    src = _make_cloud(n=300, seed=5)
    tgt = JPointCloud(np.asarray(src.points))
    tgt.normals = np.asarray(src.normals)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = _rot_z(0.4), [0.5, -0.3, 0.2]
    tgt.transform(T)
    fs = jfeat.compute_fpfh_feature(src, JKNN(25))
    ft = jfeat.compute_fpfh_feature(tgt, JKNN(25))
    want = j_cff(cph.registration.Feature(a), cph.registration.Feature(b),
                 mutual_filter=mutual)
    got = treg.correspondences_from_features(
        treg.Feature(a, device=CPU), treg.Feature(b, device=CPU),
        mutual_filter=mutual)
    np.testing.assert_array_equal(got, want)
    q, d = np.asarray(fs.data).T, np.asarray(ft.data).T
    for x, y in ((q, d), (d, q)):
        share = near_tie_only(
            x, y, np.asarray(jfeat._feature_nn(jnp.asarray(x),
                                               jnp.asarray(y))),
            tfeat._feature_nn(torch.as_tensor(x), torch.as_tensor(y))
            .numpy())
        assert share <= 0.05
    if not mutual:
        got = treg.correspondences_from_features(to_port_feature(fs),
                                                 to_port_feature(ft))
        np.testing.assert_array_equal(got[:, 0], np.arange(len(q)))


def _fgr_case():
    """tests/test_feature.py's FGR case: a 600-point surface moved by
    0.4 rad about z and (0.5, -0.3, 0.2)."""
    src = _make_cloud(n=600, seed=5)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3], T_true[:3, 3] = _rot_z(0.4), [0.5, -0.3, 0.2]
    tgt = JPointCloud(np.asarray(src.points))
    tgt.normals = np.asarray(src.normals)
    tgt.transform(T_true)
    return src, tgt, T_true


def test_torch_fgr_on_jax_draws_matches_jax(monkeypatch):
    """On the reference's clouds, features, tuple draws and feature
    matches, the pose within 1e-4 and the fitness within 1e-3 of the
    reference's."""
    src, tgt, _ = _fgr_case()
    fs, ft = (jfeat.compute_fpfh_feature(c, JKNN(25)) for c in (src, tgt))
    opt = JOpt(maximum_correspondence_distance=0.1)
    want = j_fgr(src, tgt, fs, ft, opt)
    inject_jax_fgr_choices(monkeypatch)
    got = treg.fast_global_registration(
        to_port(src), to_port(tgt), to_port_feature(fs), to_port_feature(ft),
        fgr_option(opt))
    np.testing.assert_allclose(got.transformation, want.transformation,
                               atol=1e-4)
    assert got.fitness == pytest.approx(want.fitness, abs=1e-3)


def test_torch_fgr_own_draws_recovers_transform():
    """The port end to end (its normals, features and draws) recovers
    the motion within 0.05, fitness > 0.9; empty input raises."""
    src, tgt, T_true = _fgr_case()
    s, t = to_port(src), to_port(tgt)
    s.normals = t.normals = None
    s.estimate_normals(TKNN(12))
    t.estimate_normals(TKNN(12))
    fs = treg.compute_fpfh_feature(s, TKNN(25))
    ft = treg.compute_fpfh_feature(t, TKNN(25))
    res = treg.fast_global_registration(
        s, t, fs, ft, treg.FastGlobalRegistrationOption(
            maximum_correspondence_distance=0.1))
    assert res.fitness > 0.9
    assert np.abs(res.transformation - T_true).max() < 0.05
    draws = tfgr.tuple_draws(50, 1000)
    np.testing.assert_array_equal(draws.numpy(),
                                  tfgr.tuple_draws(50, 1000).numpy())
    assert 0 <= int(draws.min()) and int(draws.max()) < 50
    empty = TPointCloud(device=CPU)
    with pytest.raises(RuntimeError):
        treg.fast_global_registration(empty, empty, treg.Feature(device=CPU),
                                      treg.Feature(device=CPU))


def _shot_surface(rng, n):
    """tests/test_shot.py's wavy surface, normals by the JAX package."""
    xy = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    z = 0.3 * np.sin(3 * xy[:, 0]) * np.cos(2 * xy[:, 1])
    pcd = JPointCloud(np.column_stack([xy, z]).astype(np.float32))
    pcd.estimate_normals()
    return pcd


@pytest.mark.parametrize("n,radius", [(500, 0.3), (400, 0.4)])
def test_torch_shot_matches_jax(rng, n, radius):
    jp = _shot_surface(rng, n)
    want = np.asarray(j_shot(jp, radius=radius).data)
    got = treg.compute_shot_feature(to_port(jp), radius=radius).data.numpy()
    assert got.shape == want.shape == (352, n)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_torch_shot_requires_normals(rng):
    pcd = TPointCloud(rng.uniform(size=(50, 3)).astype(np.float32),
                      device=CPU)
    with pytest.raises(RuntimeError):
        treg.compute_shot_feature(pcd, radius=0.3)


def test_torch_iss_keypoints_match_jax(rng):
    """Keep masks equal on tests/test_laserscan_keypoints.py's 20x20
    grid lifted into a bumpy sheet, and on 300 and 1000 points in a
    cube with radii derived from the model resolution.

    On the flat grid itself (z = 0) every saliency is the least
    eigenvalue of an exactly planar covariance: f32 rounding noise of
    about 2e-10 in both packages, which round differently, so the
    suppression keeps other points. There both are held to the
    reference test's property (every keypoint within 0.2 of the
    border)."""
    g = 20
    xx, yy = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    x, y = xx.ravel(), yy.ravel()
    flat = np.stack([x, y, np.zeros(g * g)], -1).astype(np.float32)
    bump = np.stack([x, y, 0.05 * np.sin(6 * x) * np.cos(5 * y)],
                    -1).astype(np.float32)
    radii = dict(salient_radius=0.15, non_max_radius=0.1)
    cases = [(bump, radii)] + [
        (rng.uniform(size=(n, 3)).astype(np.float32), {}) for n in (300, 1000)]
    for pts, kw in cases:
        kj, mj = j_iss(JPointCloud(pts), **kw)
        kt, mt = t_iss(TPointCloud(pts, device=CPU), **kw)
        assert mj.any()
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(kt.points.numpy(),
                                      np.asarray(kj.points))
    for kp, _ in (j_iss(JPointCloud(flat), **radii),
                  t_iss(TPointCloud(flat, device=CPU), **radii)):
        p = np.asarray(kp.points)
        border = np.minimum.reduce([p[:, 0], 1 - p[:, 0], p[:, 1],
                                    1 - p[:, 1]])
        assert len(p) >= 1 and (border < 0.2).all()
    kt, mt = t_iss(TPointCloud(device=CPU))
    assert len(kt) == 0 and mt.shape == (0,)
