"""The port's scalable TSDF volume (cupoch_tpu_torch.integration.
ScalableTSDFVolume) against the JAX package's on the same numpy inputs,
on the CPU: chip_smoke.py's rendered room at 80x60 (PrimeSense
intrinsics scaled by 1/8) along frames 0, 2, 4 and 6 of its trajectory,
into 0.05 m voxels with sdf_trunc 0.15 and an initial capacity of 16
blocks, so the table grows.

Tolerances: the block table (keys and slots, in order) and the
capacity equal after every frame; tsdf, weight and colour within 1e-6
(the port takes the reference's fused multiply-adds as float64 sums
rounded once); the extracted cloud's points within 1e-6 and colours
within 1e-6, the mesh's triangles equal and vertices within 1e-6; a
JAX volume carried over by `from_numpy` integrates and extracts as the
JAX volume does. Vertex normals within 1e-3: each is the unit sum of
its triangles' cross products, which nearly cancel at a few vertices.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import cupoch_tpu_torch as ctt
from cupoch_tpu.camera import PinholeCameraIntrinsic as JIntrinsic
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import RGBDImage as JRGBDImage
from cupoch_tpu.integration import ScalableTSDFVolume as JVolume
from cupoch_tpu.integration import TSDFVolumeColorType as JColorType
from cupoch_tpu_torch.integration import ScalableTSDFVolume as TVolume
from cupoch_tpu_torch.integration import TSDFVolumeColorType as TColorType
from torch_port_bridge import intrinsic as to_port_intrinsic
from torch_port_bridge import rgbd as to_port_rgbd
from torch_port_bridge import scalable_volume

STATE_TOL = dict(rtol=0.0, atol=1e-6)
VOXEL, TRUNC = 0.05, 0.15
STEPS = (0, 2, 4, 6)


def _intrinsics():
    cam = ctt.camera
    tin = cam.PinholeCameraIntrinsic(
        cam.PinholeCameraIntrinsicParameters.PrimeSenseDefault).scale(0.125)
    fx, fy = tin.get_focal_length()
    cx, cy = tin.get_principal_point()
    return JIntrinsic(tin.width, tin.height, fx, fy, cx, cy), tin


JIN, TIN = _intrinsics()


def _frame(k):
    """(JAX RGBDImage of the room's frame k as a sensor gives it,
    world-to-camera extrinsic)."""
    rgb, depth = cs.room_depth(np, cs.rgbd_pose(np, k), TIN)
    mm = np.round(depth * cs.RGBD_DEPTH_SCALE).astype(np.uint16)
    rgbd = JRGBDImage.create_from_color_and_depth(
        JImage(rgb), JImage(mm[..., None]), convert_rgb_to_intensity=False)
    return rgbd, np.linalg.inv(cs.rgbd_pose(np, k)).astype(np.float32)


FRAMES = [_frame(k) for k in STEPS]


def _close(want, got, **tol):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                               **(tol or STATE_TOL))


def _state_equal(jv, tv):
    assert list(tv._slots.items()) == list(jv._slots.items())
    assert tv.capacity == jv._capacity == tv.tsdf.shape[0]
    for name in ("tsdf", "weight", "color"):
        _close(getattr(jv, name), getattr(tv, name))


@pytest.fixture(scope="module")
def runs():
    """Both volumes after each frame: [(JAX state, port state)]."""
    jv = JVolume(VOXEL, TRUNC, JColorType.RGB8, initial_capacity=16)
    tv = TVolume(VOXEL, TRUNC, TColorType.RGB8, initial_capacity=16,
                 device="cpu")
    out = []
    for rgbd, ext in FRAMES:
        jv.integrate(rgbd, JIN, ext)
        tv.integrate(to_port_rgbd(rgbd), TIN, ext)
        out.append(((dict(jv._slots), jv._capacity, np.asarray(jv.tsdf),
                     np.asarray(jv.weight), np.asarray(jv.color)),
                    (dict(tv._slots), tv.capacity, tv.tsdf.clone(),
                     tv.weight.clone(), tv.color.clone())))
    return jv, tv, out


@pytest.mark.parametrize("frame", range(len(STEPS)))
def test_torch_scalable_state_after_each_frame(runs, frame):
    (jslots, jcap, *jstate), (tslots, tcap, *tstate) = runs[2][frame]
    assert list(tslots.items()) == list(jslots.items())
    assert tcap == jcap
    for want, got in zip(jstate, tstate):
        _close(want, got)
    assert float(tstate[1].max()) == frame + 1


def test_torch_scalable_capacity_grows(runs):
    jv, tv, out = runs
    assert out[0][1][1] == 32 and len(tv) > 16   # doubled from 16
    assert tv.tsdf.shape == (tv.capacity, 16, 16, 16)
    assert tv.color.shape == (tv.capacity, 16, 16, 16, 3)
    # the grown slots stay unobserved
    assert float(tv.weight[len(tv):].abs().sum()) == 0.0


def test_torch_scalable_extracted_cloud_matches_jax(runs):
    jv, tv, _ = runs
    jp, tp = jv.extract_point_cloud(), tv.extract_point_cloud()
    assert len(tp) == len(jp) > 1000
    _close(jp.points, tp.points)
    _close(jp.colors, tp.colors)
    # the crossings lie on the room's surfaces
    assert np.quantile(cs.room_distance(np, tp.points.numpy()), 0.99) \
        < VOXEL


def test_torch_scalable_mesh_matches_jax(runs):
    jv, tv, _ = runs
    jm, tm = jv.extract_triangle_mesh(), tv.extract_triangle_mesh()
    assert tm.vertices.shape[0] == np.asarray(jm.vertices).shape[0] > 1000
    np.testing.assert_array_equal(tm.triangles.numpy(),
                                  np.asarray(jm.triangles))
    _close(jm.vertices, tm.vertices)
    _close(jm.vertex_colors, tm.vertex_colors)
    _close(jm.vertex_normals, tm.vertex_normals, rtol=0.0, atol=1e-3)


def test_torch_scalable_from_numpy_carries_a_jax_volume(runs):
    jv, _, _ = runs
    tv = scalable_volume(jv)
    _state_equal(jv, tv)
    rgbd, ext = _frame(8)
    jv2 = JVolume(VOXEL, TRUNC, JColorType.RGB8)
    jv2._slots, jv2._capacity = dict(jv._slots), jv._capacity
    jv2.tsdf, jv2.weight, jv2.color = jv.tsdf, jv.weight, jv.color
    jv2.integrate(rgbd, JIN, ext)
    tv.integrate(to_port_rgbd(rgbd), TIN, ext)
    _state_equal(jv2, tv)
    with pytest.raises(ValueError):
        TVolume.from_numpy({(0, 0, 0): 1}, np.zeros((2, 16, 16, 16)),
                           np.zeros((2, 16, 16, 16)),
                           np.zeros((2, 16, 16, 16, 3)), VOXEL, TRUNC,
                           device="cpu")


def test_torch_scalable_distant_blocks_bounded():
    """tests/test_integration.py's two patches 100 block lengths apart:
    the table stays sparse and the mesh holds both, as the JAX
    package's does."""
    intr = JIntrinsic(64, 48, 60.0, 60.0, 31.5, 23.5)
    depth = np.full((48, 64, 1), 1.2, np.float32)
    rgbd = JRGBDImage(JImage(np.ones((48, 64, 1), np.float32)),
                      JImage(depth))
    jv = JVolume(0.05, 0.15, JColorType.NoColor, depth_sampling_stride=2)
    tv = TVolume(0.05, 0.15, TColorType.NoColor, depth_sampling_stride=2,
                 device="cpu")
    T2 = np.eye(4, dtype=np.float32)
    T2[0, 3] = 100 * tv.volume_unit_length
    for T in (np.eye(4, dtype=np.float32), T2):
        jv.integrate(rgbd, intr, T)
        tv.integrate(to_port_rgbd(rgbd), to_port_intrinsic(intr), T)
    assert len(tv) == len(jv) < 400
    _state_equal(jv, tv)
    v = tv.extract_triangle_mesh().vertices.numpy()
    np.testing.assert_allclose(
        v, np.asarray(jv.extract_triangle_mesh().vertices), atol=1e-6)
    assert (v[:, 0] < 50 * tv.volume_unit_length).any()
    assert (v[:, 0] < -50 * tv.volume_unit_length).any()


def test_torch_scalable_mesh_welds_across_blocks():
    """A sphere's SDF written into 4x4x4 blocks through `from_numpy`:
    every edge inside the blocks' box is shared by exactly two
    triangles, and the mesh is the JAX package's."""
    keys = [(bx, by, bz) for bx in range(-2, 2) for by in range(-2, 2)
            for bz in range(-2, 2)]
    slots = {k: i for i, k in enumerate(keys)}
    r = (np.arange(16) + 0.5) * 0.05
    local = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1)
    f = np.zeros((64, 16, 16, 16), np.float32)
    for k, s in slots.items():
        p = local + np.asarray(k, np.float32) * 0.8
        f[s] = np.clip((np.linalg.norm(p, axis=-1) - 1.0) / 0.2, -1, 1)
    w = np.ones_like(f)
    tv = TVolume.from_numpy(slots, f, w, np.zeros(f.shape + (3,)), 0.05,
                            0.2, TColorType.NoColor, device="cpu")
    jv = JVolume(0.05, 0.2, JColorType.NoColor, initial_capacity=64)
    jv._slots = dict(slots)
    jv.tsdf, jv.weight = f, w
    tm, jm = tv.extract_triangle_mesh(), jv.extract_triangle_mesh()
    t = tm.triangles.numpy()
    np.testing.assert_array_equal(t, np.asarray(jm.triangles))
    _close(jm.vertices, tm.vertices)
    edges = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]],
                                    t[:, [2, 0]]], 0), 1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert len(t) > 100 and (counts == 2).all()


def test_torch_scalable_empty_and_metadata():
    tv = TVolume(0.02, 0.06, device="cpu")
    assert len(tv) == 0 and tv.capacity == 1024
    assert tv.volume_unit_length == pytest.approx(0.32)
    assert len(tv.extract_point_cloud()) == 0
    assert tv.extract_triangle_mesh().vertices.shape[0] == 0
    with pytest.raises(ValueError):
        TVolume(0.02, 0.06, volume_unit_resolution=8, device="cpu")
    # a frame with no depth opens and updates nothing
    empty = ctt.geometry.RGBDImage(
        ctt.geometry.Image(np.zeros((60, 80, 3), np.float32), device="cpu"),
        ctt.geometry.Image(np.zeros((60, 80, 1), np.float32), device="cpu"))
    tv.integrate(empty, TIN)
    assert len(tv) == 0 and float(tv.weight.sum()) == 0.0
    assert tv.device == torch.device("cpu")
