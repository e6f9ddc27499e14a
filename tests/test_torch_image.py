"""The port's images and RGB-D factories (cupoch_tpu_torch.geometry:
`image_ops`, `Image`, `RGBDImage`, `pointcloud_factory`; the camera
intrinsics) against the JAX package on the same numpy inputs, on the
CPU, at 48x64.

Tolerances: every image function, pyramid and conversion within 1e-6
(absolute, and relative on depths in metres); the factories give the
same points in the same order within 1e-6 (the disparity factory's
within 1e-5 relative, where its denominator cancels); the intrinsics
are equal.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cupoch_tpu.camera import (PinholeCameraIntrinsic as JIntrinsic,
                               PinholeCameraIntrinsicParameters as JPreset,
                               PinholeCameraParameters as JParams)
from cupoch_tpu.geometry import FilterType as JFilterType
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.geometry import RGBDImage as JRGBDImage
from cupoch_tpu.geometry import image_ops as jops
from cupoch_tpu_torch.camera import (PinholeCameraIntrinsic as TIntrinsic,
                                     PinholeCameraIntrinsicParameters as
                                     TPreset,
                                     PinholeCameraParameters as TParams)
from cupoch_tpu_torch.geometry import FilterType
from cupoch_tpu_torch.geometry import Image as TImage
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.geometry import RGBDImage as TRGBDImage
from cupoch_tpu_torch.geometry import image_ops as tops
from torch_port_bridge import intrinsic as to_port_intrinsic
from torch_port_bridge import rgbd as to_port_rgbd

H, W = 48, 64
TOL = dict(rtol=1e-6, atol=1e-6)


def _close(a, b, **tol):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(b, a, **(tol or TOL))


def _gray(seed=0, channels=1, nan_at=None):
    rng = np.random.default_rng(seed)
    x = rng.random((H, W, channels), dtype=np.float32)
    if nan_at is not None:
        x[nan_at] = np.nan
    return x


def _depth(seed=1):
    """Metres in [0.5, 3.5] with a hole of zeros."""
    rng = np.random.default_rng(seed)
    d = (0.5 + 3.0 * rng.random((H, W))).astype(np.float32)
    d[10:14, 20:30] = 0.0
    return d


def _intrinsic():
    return JIntrinsic(W, H, 50.0, 52.0, 31.5, 23.5)


@pytest.mark.parametrize("name", [
    "filter_gaussian3", "filter_gaussian5", "filter_gaussian7",
    "filter_sobel_dx", "filter_sobel_dy", "downsample2", "dilate",
    "flip_horizontal", "flip_vertical", "transpose"])
@pytest.mark.parametrize("channels", [1, 3])
def test_torch_image_op_matches_jax(name, channels):
    # a NaN (invalid depth) reaches every pixel its window covers
    x = _gray(channels=channels, nan_at=(5, 7, 0))
    want = getattr(jops, name)(jnp.asarray(x))
    got = getattr(tops, name)(torch.from_numpy(x))
    _close(want, got, equal_nan=True, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("diameter", [1, 5])
def test_torch_bilateral_matches_jax(diameter):
    x = 3.0 * _gray(seed=2)
    want = jops.filter_bilateral(jnp.asarray(x), diameter, jnp.float32(0.05),
                                 jnp.float32(10.0))
    got = tops.filter_bilateral(torch.from_numpy(x), diameter, 0.05, 10.0)
    _close(want, got)
    if diameter == 1:               # r = 0: the identity
        np.testing.assert_array_equal(got.numpy(), x)


def test_torch_pointwise_image_ops_match_jax():
    x = _gray(seed=3, channels=3)
    _close(jops.linear_transform(jnp.asarray(x), jnp.float32(1.7),
                                 jnp.float32(-0.3)),
           tops.linear_transform(torch.from_numpy(x), 1.7, -0.3))
    _close(jops.clip_intensity(jnp.asarray(x), jnp.float32(0.2),
                               jnp.float32(0.8)),
           tops.clip_intensity(torch.from_numpy(x), 0.2, 0.8))
    _close(jops.color_to_intensity(jnp.asarray(x)),
           tops.color_to_intensity(torch.from_numpy(x)))
    rng = np.random.default_rng(4)
    u = (rng.random(50) * (W + 4) - 2).astype(np.float32)
    v = (rng.random(50) * (H + 4) - 2).astype(np.float32)
    _close(jops.float_value_at(jnp.asarray(x), jnp.asarray(u),
                               jnp.asarray(v)),
           tops.float_value_at(torch.from_numpy(x), u, v))


def test_torch_depth_helpers_match_jax():
    K = _intrinsic().intrinsic_matrix
    _close(jops.depth_to_camera_distance_multiplier(W, H, K),
           tops.depth_to_camera_distance_multiplier(W, H, K, "cpu"))
    d = _depth()
    d[0, 0] = np.nan
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.2, 0.3]
    for extrinsic in (None, T):
        pj, mj = jops.depth_to_points(jnp.asarray(d), K, extrinsic)
        pt, mt = tops.depth_to_points(torch.from_numpy(d), K, extrinsic)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        m = np.asarray(mj)
        _close(np.asarray(pj)[m], pt.numpy()[m])


def test_torch_image_container_matches_jax():
    rgb8 = (np.random.default_rng(5).random((H, W, 3)) * 255).astype(
        np.uint8)
    depth16 = (_depth() * 1000).astype(np.uint16)
    for data in (rgb8, depth16, _gray(), _gray(channels=3)):
        ji, ti = JImage(data), TImage(data, device="cpu")
        assert (ti.width, ti.height, ti.num_of_channels,
                ti.bytes_per_channel) == (ji.width, ji.height,
                                          ji.num_of_channels,
                                          ji.bytes_per_channel)
        _close(ji.create_float_image().data, ti.create_float_image().data)
        _close(ji.create_gray_image().data, ti.create_gray_image().data)
    t2 = TImage(_gray()[..., 0], device="cpu")
    assert t2.data.shape == (H, W, 1) and t2.has_data()
    assert TImage(device="cpu").is_empty()
    ji, ti = JImage(_gray()), TImage(_gray(), device="cpu")
    for ft, tft in zip(JFilterType, FilterType):
        _close(ji.filter(ft).data, ti.filter(tft).data)
    _close(ji.filter_bilateral(5, 0.1, 3.0).data,
           ti.filter_bilateral(5, 0.1, 3.0).data)
    _close(ji.linear_transform(2.0, 0.5).data,
           ti.linear_transform(2.0, 0.5).data)
    _close(ji.dilate(2).data, ti.dilate(2).data)
    assert ji.float_value_at(10.3, 20.7) == pytest.approx(
        ti.float_value_at(10.3, 20.7), abs=1e-6)
    assert ti.float_value_at(-1.0, 3.0)[0] is False
    for smooth in (True, False):
        pj = ji.create_pyramid(4, smooth)
        pt = ti.create_pyramid(4, smooth)
        assert [p.width for p in pt] == [64, 32, 16, 8]
        for a, b in zip(pj, pt):
            _close(a.data, b.data)
    intr = _intrinsic()
    _close(ji.create_depth_to_camera_distance_multiplier_float_image(
        intr).data,
        ti.create_depth_to_camera_distance_multiplier_float_image(
            to_port_intrinsic(intr)).data)


@pytest.mark.parametrize("factory", [
    "create_from_color_and_depth", "create_from_tum_format",
    "create_from_redwood_format", "create_from_nyu_format"])
@pytest.mark.parametrize("to_intensity", [True, False])
def test_torch_rgbd_factories_match_jax(factory, to_intensity):
    rgb8 = (np.random.default_rng(6).random((H, W, 3)) * 255).astype(
        np.uint8)
    depth16 = (np.clip(_depth(), 0.0, 6.0) * 1500).astype(np.uint16)
    j = getattr(JRGBDImage, factory)(JImage(rgb8), JImage(depth16),
                                     convert_rgb_to_intensity=to_intensity)
    t = getattr(TRGBDImage, factory)(TImage(rgb8, device="cpu"),
                                     TImage(depth16, device="cpu"),
                                     convert_rgb_to_intensity=to_intensity)
    _close(j.color.data, t.color.data)
    _close(j.depth.data, t.depth.data)
    for a, b in zip(j.create_pyramid(3), t.create_pyramid(3)):
        _close(a.color.data, b.color.data)
        _close(a.depth.data, b.depth.data)


def _cloud_close(jp, tp):
    for name in ("points", "colors", "normals"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b, equal_nan=True, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_torch_create_from_depth_image_matches_jax(stride):
    intr = _intrinsic()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                            [0.0, 0.0, 1.0]])
    T[:3, 3] = [0.2, 0.1, -0.4]
    d16 = (_depth() * 1000).astype(np.uint16)
    for depth, extrinsic in ((_depth()[..., None], None), (d16, T)):
        jp = JPointCloud.create_from_depth_image(
            JImage(depth), intr, extrinsic, depth_trunc=3.0, stride=stride)
        tp = TPointCloud.create_from_depth_image(
            TImage(depth, device="cpu"), to_port_intrinsic(intr), extrinsic,
            depth_trunc=3.0, stride=stride)
        assert len(tp) == len(jp) > 0
        _cloud_close(jp, tp)


@pytest.mark.parametrize("normals", [True, False])
def test_torch_create_from_rgbd_image_matches_jax(normals):
    intr = _intrinsic()
    rgb8 = (np.random.default_rng(7).random((H, W, 3)) * 255).astype(
        np.uint8)
    d = _depth()
    d[3, 4] = np.nan
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.5, 0.0, -0.1]
    for color in (rgb8, _gray()):
        jr = JRGBDImage(JImage(color), JImage(d[..., None]))
        jp = JPointCloud.create_from_rgbd_image(jr, intr, T, True, 2.5,
                                                normals)
        tp = TPointCloud.create_from_rgbd_image(
            to_port_rgbd(jr), to_port_intrinsic(intr), T, True, 2.5, normals)
        assert len(tp) == len(jp)
        _cloud_close(jp, tp)
        # every pixel, NaN where the depth is invalid: the reference
        # raises there (it writes into a read-only array), so its valid
        # rows are the ones held
        every = TPointCloud.create_from_rgbd_image(
            to_port_rgbd(jr), to_port_intrinsic(intr), T, False, 2.5,
            normals)
        assert len(every) == H * W
        valid = ((d > 0) & (d <= 2.5)).reshape(-1)
        assert np.isnan(every.points.numpy()[~valid]).all()
        _close(jp.points, every.points[torch.from_numpy(valid)])
        _close(jp.colors, every.colors[torch.from_numpy(valid)])
        if normals:
            _close(jp.normals, every.normals[torch.from_numpy(valid)])


def test_torch_create_from_disparity_matches_jax():
    rng = np.random.default_rng(8)
    disp = (rng.random((H, W)) * 40).astype(np.float32)
    disp[:5] = 0.0
    rgb8 = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    left = _intrinsic()
    right = JIntrinsic(W, H, 50.0, 52.0, 30.0, 23.5)
    jp = JPointCloud.create_from_disparity(JImage(disp), JImage(rgb8), left,
                                           right, 0.12)
    tp = TPointCloud.create_from_disparity(
        TImage(disp, device="cpu"), TImage(rgb8, device="cpu"),
        to_port_intrinsic(left), to_port_intrinsic(right), 0.12)
    assert len(tp) == len(jp) > 0
    # 1 / (Q32 d + Q33) cancels where d nears (cxl - cxr): there the
    # reference's contracted multiply-add and the port's two roundings
    # differ by a few parts in a million
    _close(jp.points, tp.points, rtol=1e-5, atol=1e-6)
    _close(jp.colors, tp.colors)


@pytest.mark.parametrize("preset", list(JPreset))
def test_torch_intrinsic_matches_jax(preset):
    j = JIntrinsic(preset)
    t = TIntrinsic(TPreset(int(preset)))
    np.testing.assert_array_equal(t.intrinsic_matrix, j.intrinsic_matrix)
    assert (t.width, t.height) == (j.width, j.height)
    for f in (0.5, 0.25, 0.125):
        np.testing.assert_array_equal(t.scale(f).intrinsic_matrix,
                                      j.scale(f).intrinsic_matrix)
        assert t.scale(f).width == j.scale(f).width
    assert TIntrinsic.from_dict(j.to_dict()).to_dict() == j.to_dict()
    jp, tp = JParams(), TParams()
    jp.intrinsic, tp.intrinsic = j, t
    jp.extrinsic[:3, 3] = tp.extrinsic[:3, 3] = [1.0, 2.0, 3.0]
    assert tp.to_dict() == jp.to_dict()
    assert TParams.from_dict(jp.to_dict()).to_dict() == jp.to_dict()
