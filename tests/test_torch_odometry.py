"""The port's RGB-D odometry (cupoch_tpu_torch.odometry and
`utility.eigen.compute_jtj_jtr`) against the JAX package on the same
numpy inputs, on the CPU: chip_smoke.py's room (`render_room`) at 80x60
with scaled PrimeSense intrinsics, a pair 1 cm and 0.3 deg apart, and
tests/test_odometry.py's textured plane.

Tolerances: correspondence masks and pixels equal; JTJ and JTr within
1e-4 of their largest entry; poses within 1e-4 per entry; information
matrices within 1e-4 of their largest entry. Two calls are
ill-conditioned in the reference itself and held to 1e-4 where they are
not, as their tests say: the photometric-only call over two iterations
a level (its Gauss-Newton steps do not contract on the room, so a
difference in the last bit grows with every step: the reference's own
pose moves by 1.4e-5 at two iterations a level and by up to 9.4e-4 at
[10, 5] when its source depth moves by one ulp; at [10, 5] the port is
also held to lie within that spread) and the weighted variant on the
plane, held one level call at a time from the same state (over its
three levels the t-distribution weights follow the residuals from step
to step, and a difference in the last bit grows to 1e-2 in both
packages alike, each about 8e-3 from the true motion).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import cupoch_tpu_torch as ctt
import test_odometry as plane
from cupoch_tpu.camera import PinholeCameraIntrinsic as JIntrinsic
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import RGBDImage as JRGBDImage
from cupoch_tpu.odometry import (OdometryOption as JOption,
                                 RGBDOdometryJacobianFromColorTerm as JColor,
                                 RGBDOdometryJacobianFromHybridTerm as
                                 JHybrid,
                                 compute_rgbd_odometry as j_odometry,
                                 compute_weighted_rgbd_odometry as
                                 j_weighted)
from cupoch_tpu.odometry import odometry as jodo
from cupoch_tpu.odometry import odometry_core as jcore
from cupoch_tpu.utility import eigen as jeigen
from cupoch_tpu_torch.odometry import (
    OdometryOption as TOption,
    RGBDOdometryJacobianFromColorTerm as TColor,
    RGBDOdometryJacobianFromHybridTerm as THybrid,
    compute_rgbd_odometry as t_odometry,
    compute_weighted_rgbd_odometry as t_weighted)
from cupoch_tpu_torch.odometry import odometry as todo
from cupoch_tpu_torch.odometry import odometry_core as tcore
from cupoch_tpu_torch.utility import eigen as teigen
from torch_port_bridge import rgbd as to_port_rgbd

SCALE = 0.25                     # 640x480 -> 160x120
LEVELS = [10, 5]
JAC = {"hybrid": (JHybrid(), THybrid()), "color": (JColor(), TColor())}


def _rel_close(a, b, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-30)


def _intrinsic():
    PS = ctt.camera.PinholeCameraIntrinsicParameters.PrimeSenseDefault
    t = ctt.camera.PinholeCameraIntrinsic(PS).scale(SCALE)
    return JIntrinsic.from_dict(t.to_dict()), t


def _room_rgbd(k):
    """Frame k of chip_smoke's trajectory as both packages' RGBDImage
    (intensity, depth in metres)."""
    _, tin = _intrinsic()
    c, d = cs.room_frame(np, ctt, k, tin, "cpu")
    j = JRGBDImage.create_from_color_and_depth(JImage(c.data.numpy()),
                                               JImage(d.data.numpy()))
    return j, to_port_rgbd(j)


@pytest.fixture(scope="module")
def room_pair():
    (js, ts), (jt, tt) = _room_rgbd(3), _room_rgbd(4)
    T_true = np.linalg.inv(cs.rgbd_pose(np, 4)) @ cs.rgbd_pose(np, 3)
    return js, ts, jt, tt, T_true.astype(np.float32)


@pytest.fixture(scope="module")
def room_levels(room_pair):
    """Both packages' initialised level-0 images of the room pair."""
    js, ts, jt, tt, _ = room_pair
    jin, tin = _intrinsic()
    opt_j, opt_t = JOption(LEVELS), TOption(LEVELS)
    eye = np.eye(4, dtype=np.float32)
    jl = jodo._initialize(js, jt, jin, eye, opt_j)
    pyr, _, _ = todo._prepare(ts, tt, tin, eye, opt_t)
    return jl, [p[0] for p in pyr], jin.intrinsic_matrix


def test_torch_initialised_images_match_jax(room_levels):
    jl, tl, _ = room_levels
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("jac_type", ["hybrid", "color"])
def test_torch_correspondence_and_system_match_jax(room_levels, room_pair,
                                                   jac_type):
    (sc, sd, tc, td), tl, K = room_levels
    T = room_pair[4]
    jK = jnp.asarray(K)
    tK, tK_inv = tcore.camera_tensors(K, "cpu")
    uj, vj, zj, okj = jcore.compute_correspondence(sd, td, jK,
                                                   jnp.asarray(T), 0.03)
    ut, vt, zt, okt = tcore.compute_correspondence(
        tl[1], tl[3], tK, tK_inv, torch.from_numpy(T), 0.03)
    ok = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), ok)
    assert ok.sum() > 1000
    np.testing.assert_array_equal(ut.numpy()[ok], np.asarray(uj)[ok])
    np.testing.assert_array_equal(vt.numpy()[ok], np.asarray(vj)[ok])
    np.testing.assert_allclose(zt.numpy()[ok], np.asarray(zj)[ok],
                               rtol=1e-6)
    dj = (jcore.jnp_filter_sobel_dx(tc), jcore.jnp_filter_sobel_dx(td),
          jcore.jnp_filter_sobel_dy(tc), jcore.jnp_filter_sobel_dy(td))
    dt = (tcore.filter_sobel_dx(tl[2]), tcore.filter_sobel_dx(tl[3]),
          tcore.filter_sobel_dy(tl[2]), tcore.filter_sobel_dy(tl[3]))
    xyz_j = jcore.depth_to_xyz(jnp.where(jnp.isfinite(sd), sd, 0.0), jK)
    xyz_t = tcore._src_xyz(tl[1], tK)
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), rtol=1e-6,
                               atol=1e-6)
    sj = jcore._reduce_system(*jcore._jacobians(
        jac_type, sc, sd, tc, td, xyz_j, *dj, jK, jnp.asarray(T), uj, vj,
        okj))
    st = tcore._reduce_system(*tcore._jacobians(
        jac_type, tl[0], tl[2], tl[3], xyz_t, *dt, tK, torch.from_numpy(T),
        ut, vt, okt))
    for a, b in zip(sj, st):
        _rel_close(a, b.numpy())


@pytest.mark.parametrize("jac_type, levels", [("hybrid", LEVELS),
                                               ("color", [2, 2])],
                         ids=["hybrid", "color"])
def test_torch_rgbd_odometry_matches_jax(room_pair, jac_type, levels):
    js, ts, jt, tt, _ = room_pair
    jin, tin = _intrinsic()
    jj, tj = JAC[jac_type]
    okj, Tj, infoj = j_odometry(js, jt, jin, None, jj, JOption(levels))
    okt, Tt, infot = t_odometry(ts, tt, tin, None, tj, TOption(levels))
    assert okj and okt
    _rel_close(infoj, infot)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)


def test_torch_color_odometry_within_reference_spread(room_pair):
    """The photometric-only call at LEVELS, where a change of one ulp in
    the source depth moves the reference's own pose by up to 9.4e-4: the
    port's pose lies within the reference's own spread over the source
    depth one ulp up and one ulp down."""
    js, ts, jt, tt, _ = room_pair
    jin, tin = _intrinsic()
    jj, tj = JAC["color"]
    okj, Tj, _ = j_odometry(js, jt, jin, None, jj, JOption(LEVELS))
    okt, Tt, _ = t_odometry(ts, tt, tin, None, tj, TOption(LEVELS))
    assert okj and okt
    d = np.asarray(js.depth.data)
    own = max(np.abs(j_odometry(
        JRGBDImage(js.color, JImage(np.nextafter(d, np.float32(to)))),
        jt, jin, None, jj, JOption(LEVELS))[1] - Tj).max()
        for to in (np.inf, -np.inf))
    assert np.abs(Tt - Tj).max() <= own


def test_torch_weighted_odometry_matches_jax(room_pair):
    js, ts, jt, tt, _ = room_pair
    jin, tin = _intrinsic()
    prev = np.asarray([1e-3, -2e-3, 0.0, 5e-3, 0.0, -1e-3], np.float32)
    inv_sigma = np.full(6, 50.0, np.float32)
    okj, Tj, twj, infoj = j_weighted(
        js, jt, jin, None, prev, JHybrid(),
        JOption(LEVELS, inv_sigma_mat_diag=inv_sigma))
    okt, Tt, twt, infot = t_weighted(
        ts, tt, tin, None, prev, THybrid(),
        TOption(LEVELS, inv_sigma_mat_diag=inv_sigma))
    assert okj and okt
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    np.testing.assert_allclose(twt, twj, atol=1e-4)
    _rel_close(infoj, infot)


def test_torch_rgbd_odometry_on_plane_matches_jax():
    T_true = plane.small_motion()
    si, sd = plane.render(np.eye(4))
    ti, td = plane.render(T_true)
    js, jt = plane.make_rgbd(si, sd), plane.make_rgbd(ti, td)
    jin = plane.intrinsic()
    opt = dict(max_depth_diff=0.1)
    okj, Tj, infoj = j_odometry(js, jt, jin, np.eye(4, dtype=np.float32),
                                JHybrid(), JOption(**opt))
    okt, Tt, infot = t_odometry(
        to_port_rgbd(js), to_port_rgbd(jt),
        ctt.camera.PinholeCameraIntrinsic.from_dict(jin.to_dict()),
        np.eye(4, dtype=np.float32), THybrid(), TOption(**opt))
    assert okj and okt
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    _rel_close(infoj, infot)


@pytest.mark.parametrize("level, n_iter", [(2, 20), (1, 10), (0, 5)])
def test_torch_weighted_level_on_plane_matches_jax(level, n_iter):
    """One weighted level call from the same state (the JAX package's
    state after the coarser levels)."""
    T_true = plane.small_motion()
    si, sd = plane.render(np.eye(4))
    ti, td = plane.render(T_true)
    js, jt = plane.make_rgbd(si, sd), plane.make_rgbd(ti, td)
    jin = plane.intrinsic()
    tin = ctt.camera.PinholeCameraIntrinsic.from_dict(jin.to_dict())
    eye = np.eye(4, dtype=np.float32)
    jl = jodo._initialize(js, jt, jin, eye, JOption(max_depth_diff=0.1))
    jp = [jodo._pyramid(x, 3, s) for x, s in zip(jl, (True, False) * 2)]
    Kp = jodo._camera_matrix_pyramid(jin, 3)
    tp, tKp, _ = todo._prepare(to_port_rgbd(js), to_port_rgbd(jt), tin, eye,
                               TOption(max_depth_diff=0.1))
    state = (jnp.eye(4), jnp.eye(4), jnp.float32(1.0))
    for lv, n in ((2, 20), (1, 10), (0, 5)):
        args = (jp[0][lv], jp[1][lv], jp[2][lv], jp[3][lv],
                jcore.jnp_filter_sobel_dx(jp[2][lv]),
                jcore.jnp_filter_sobel_dx(jp[3][lv]),
                jcore.jnp_filter_sobel_dy(jp[2][lv]),
                jcore.jnp_filter_sobel_dy(jp[3][lv]), jnp.asarray(Kp[lv]))
        if lv == level:
            break
        state = jcore.level_odometry_weighted(
            *args, state[0], jnp.float32(0.1), jnp.float32(5.0), state[2],
            jnp.zeros(6), jnp.zeros(6), state[1], jac_type="hybrid",
            n_iter=n)
    Tj, vj, _ = jcore.level_odometry_weighted(
        *args, state[0], jnp.float32(0.1), jnp.float32(5.0), state[2],
        jnp.zeros(6), jnp.zeros(6), state[1], jac_type="hybrid",
        n_iter=n_iter)
    Tt, vt, _ = tcore.level_odometry_weighted(
        *todo._level_inputs(tp, tKp, level, "cpu"),
        torch.from_numpy(np.array(state[0])), 0.1, 5.0, float(state[2]),
        torch.zeros(6), torch.zeros(6),
        torch.from_numpy(np.array(state[1])), "hybrid", n_iter)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)


def test_torch_information_and_intensity_scales_match_jax(room_levels,
                                                          room_pair):
    (sc, sd, tc, td), tl, K = room_levels
    T = room_pair[4]
    tK, tK_inv = tcore.camera_tensors(K, "cpu")
    _rel_close(jcore.information_matrix(sd, td, jnp.asarray(K),
                                        jnp.asarray(T), 0.03),
               tcore.information_matrix(tl[1], tl[3], tK, tK_inv,
                                        torch.from_numpy(T), 0.03).numpy())
    sj = jcore.normalize_intensity_scales(sc, tc, sd, td, jnp.asarray(K),
                                          jnp.asarray(T), 0.03)
    st = tcore.normalize_intensity_scales(tl[0], tl[2], tl[1], tl[3], tK,
                                          tK_inv, torch.from_numpy(T), 0.03)
    for a, b in zip(sj, st):
        assert float(b) == pytest.approx(float(a), rel=1e-5)


def test_torch_odometry_refuses_mismatched_sizes(room_pair):
    _, ts, _, _, _ = room_pair
    _, tin = _intrinsic()
    half = ctt.geometry.RGBDImage(
        ctt.geometry.Image(ts.color.data[:30]),
        ctt.geometry.Image(ts.depth.data[:30]))
    ok, T, info = t_odometry(ts, half, tin)
    assert not ok
    np.testing.assert_array_equal(T, np.eye(4))
    np.testing.assert_array_equal(info, np.zeros((6, 6)))


def test_torch_compute_jtj_jtr_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3)).astype(np.float32)
    m = rng.random(200) > 0.3

    def fj(row):
        return (jnp.stack([row * 2.0, row ** 2]),
                jnp.stack([row.sum(), row[0] * row[1]]))

    def ft(row):
        return (torch.stack([row * 2.0, row ** 2]),
                torch.stack([row.sum(), row[0] * row[1]]))

    for mask in (None, m):
        a = jeigen.compute_jtj_jtr(fj, jnp.asarray(X),
                                   None if mask is None else
                                   jnp.asarray(mask))
        b = teigen.compute_jtj_jtr(ft, torch.from_numpy(X),
                                   None if mask is None else
                                   torch.from_numpy(mask))
        for x, y in zip(a[:3], b[:3]):
            _rel_close(x, y.numpy() if isinstance(y, torch.Tensor) else y,
                       1e-6)
        assert int(a[3]) == int(b[3])
