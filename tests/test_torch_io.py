"""The port's file and message IO (cupoch_tpu_torch.io, utility.lzf,
utility.dl_converter, bench.ate) against the JAX package's on the CPU.

Every format round-trips through the port; files written by one
package are read by the other; the PCD (binary, binary_compressed) and
STL writers write the same bytes as the JAX package's; the LZF codec's
C decoder equals its Python plain version and the JAX package's native
codec; the PNG codec, which needs no PIL, equals PIL on files either
writes. Floats that go through text (ASCII PLY / PCD, XYZ, OBJ) within
1e-6 relative; binary formats bit-equal; colours through uint8 within
half a level.
"""
import json
import os
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cupoch_tpu.io as jio
import cupoch_tpu_torch as ctt
import cupoch_tpu_torch.io as tio
from cupoch_tpu import native as jnative
from cupoch_tpu.bench import ate as jate
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.geometry import TriangleMesh as JMesh
from cupoch_tpu_torch.bench import ate as tate
from cupoch_tpu_torch.geometry import Image as TImage
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.geometry import TriangleMesh as TMesh
from cupoch_tpu_torch.geometry import VoxelGrid as TVoxelGrid
from cupoch_tpu_torch.io import image_io as timage_io
from cupoch_tpu_torch.io import ros as tros
from cupoch_tpu_torch.utility import dl_converter, lzf
from PIL import Image as PILImage
from torch_port_bridge import cloud as to_port_cloud
from torch_port_bridge import textured_mesh

TEXT = dict(rtol=1e-6, atol=1e-7)


def _cloud(n=500, seed=0, colors=True, normals=True):
    rng = np.random.default_rng(seed)
    p = TPointCloud(rng.normal(size=(n, 3)).astype(np.float32),
                    device="cpu")
    if normals:
        nrm = rng.normal(size=(n, 3))
        p.normals = (nrm / np.linalg.norm(nrm, axis=-1,
                                          keepdims=True)).astype(np.float32)
    if colors:
        p.colors = (rng.integers(0, 256, (n, 3)) / 255.0).astype(np.float32)
    return p


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_cloud(a, b, tol=None):
    for name in ("points", "normals", "colors"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None or not len(y)
            continue
        if tol is None:
            np.testing.assert_array_equal(_np(y), _np(x))
        else:
            np.testing.assert_allclose(_np(y), _np(x), **tol)


# ---------------------------------------------------------------------------
# point clouds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext,kw,tol", [
    ("ply", {}, None), ("ply", {"write_ascii": True}, TEXT),
    ("pcd", {}, None), ("pcd", {"compressed": True}, None),
    ("pcd", {"write_ascii": True}, TEXT)])
def test_torch_point_cloud_round_trip(tmp_path, ext, kw, tol):
    p = _cloud()
    path = str(tmp_path / f"c.{ext}")
    assert tio.write_point_cloud(path, p, **kw)
    q = tio.read_point_cloud(path, device="cpu")
    assert q.device.type == "cpu"
    _same_cloud(p, q, tol)


def test_torch_point_cloud_xyz_and_errors(tmp_path):
    p = _cloud(colors=False, normals=False)
    tio.write_point_cloud(str(tmp_path / "c.xyz"), p)
    q = tio.read_point_cloud(str(tmp_path / "c.xyz"), device="cpu")
    np.testing.assert_allclose(q.points.numpy(), p.points.numpy(), **TEXT)
    with pytest.raises(RuntimeError):
        tio.write_point_cloud(str(tmp_path / "c.abc"), p)
    with pytest.raises(RuntimeError):
        tio.read_point_cloud(str(tmp_path / "c.abc"), device="cpu")


@pytest.mark.parametrize("ext,kw", [("ply", {}), ("pcd", {}),
                                    ("pcd", {"compressed": True})])
def test_torch_point_cloud_files_cross_packages(tmp_path, ext, kw):
    p = _cloud(seed=1)
    jp = JPointCloud(p.points.numpy())
    jp.normals, jp.colors = p.normals.numpy(), p.colors.numpy()
    a, b = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    tio.write_point_cloud(a, p, **kw)
    jio.write_point_cloud(b, jp, **kw)
    _same_cloud(p, jio.read_point_cloud(a))
    _same_cloud(p, tio.read_point_cloud(b, device="cpu"))
    if ext == "pcd":       # deterministic writers: the same bytes
        assert open(a, "rb").read() == open(b, "rb").read()


def test_torch_pcd_nan_points_are_dropped(tmp_path):
    p = _cloud(20)
    pts = p.points.clone()
    pts[3] = float("nan")
    p.points = pts
    path = str(tmp_path / "n.pcd")
    tio.write_point_cloud(path, p)
    q, j = tio.read_point_cloud(path, device="cpu"), \
        jio.read_point_cloud(path)
    assert len(q) == len(j) == 19
    _same_cloud(to_port_cloud(j), q)


# ---------------------------------------------------------------------------
# LZF
# ---------------------------------------------------------------------------

def _lzf_inputs():
    rng = np.random.default_rng(2)
    floats = np.round(rng.normal(size=20000), 1).astype(np.float32)
    return {"floats": floats.tobytes(),
            "repeats": b"abcabcabcabd" * 3000 + bytes(5000),
            "random": rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
            "short": b"ab"}


@pytest.mark.parametrize("name", list(_lzf_inputs()))
def test_torch_lzf_matches_plain_and_jax(name):
    data = _lzf_inputs()[name]
    comp = lzf.compress(data)
    if name in ("random", "short"):           # incompressible: stored raw
        assert comp is None and jnative.lzf_compress(data) is None
        return
    assert len(comp) < len(data)
    assert comp == jnative.lzf_compress(data)
    assert lzf.decompress(comp, len(data)) == data
    assert lzf.decompress_plain(comp, len(data)) == data
    assert jnative._py_decompress(comp, len(data)) == data
    with pytest.raises(ValueError):
        lzf.decompress(comp[:-3] + b"\xff\xff\xff", len(data))


def test_torch_lzf_build_failure_raises(monkeypatch):
    monkeypatch.setattr(lzf, "_lib", None)
    monkeypatch.setattr(lzf, "_lib_path", lambda: "/nonexistent/dir/x.so")
    monkeypatch.setattr(lzf, "_SRC", "/nonexistent/lzf.c")
    with pytest.raises(RuntimeError, match="lzf.c"):
        lzf.compress(b"abc" * 100)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def _mesh():
    jm = JMesh.create_sphere(1.0, 8)
    jm.compute_vertex_normals()
    n = np.asarray(jm.vertices).shape[0]
    jm.vertex_colors = (np.random.default_rng(3).integers(
        0, 256, (n, 3)) / 255.0).astype(np.float32)
    return jm


@pytest.mark.parametrize("ascii_", [False, True])
def test_torch_mesh_ply_round_trip_and_cross(tmp_path, ascii_):
    jm = _mesh()
    tm = textured_mesh(jm)
    a, b = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tio.write_triangle_mesh(a, tm, write_ascii=ascii_)
    jio.write_triangle_mesh(b, jm, write_ascii=ascii_)
    tol = TEXT if ascii_ else dict(rtol=0, atol=0)
    for path in (a, b):
        got = tio.read_triangle_mesh(path, device="cpu")
        np.testing.assert_array_equal(got.triangles.numpy(),
                                      np.asarray(jm.triangles))
        for name in ("vertices", "vertex_normals", "vertex_colors"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(jm, name)), **tol)
    np.testing.assert_array_equal(
        np.asarray(jio.read_triangle_mesh(a).triangles),
        np.asarray(jm.triangles))
    if not ascii_:
        assert open(a, "rb").read() == open(b, "rb").read()


def test_torch_mesh_stl_bytes_and_round_trip(tmp_path):
    jm = _mesh()
    jm.remove_duplicated_vertices()
    tm = textured_mesh(jm)
    a, b = str(tmp_path / "t.stl"), str(tmp_path / "j.stl")
    tio.write_triangle_mesh(a, tm)
    jio.write_triangle_mesh(b, jm)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, want = tio.read_triangle_mesh(a, device="cpu"), \
        jio.read_triangle_mesh(a)
    np.testing.assert_array_equal(got.vertices.numpy(),
                                  np.asarray(want.vertices))
    np.testing.assert_array_equal(got.triangles.numpy(),
                                  np.asarray(want.triangles))
    # the corners come back bit for bit
    v, t = np.asarray(jm.vertices), np.asarray(jm.triangles)
    np.testing.assert_array_equal(got.vertices.numpy()[got.triangles.numpy()],
                                  v[t])


def test_torch_obj_with_texture_and_uvs(tmp_path):
    jm = _mesh()
    m = np.asarray(jm.triangles).shape[0]
    rng = np.random.default_rng(4)
    jm.triangle_uvs = rng.random((3 * m, 2)).astype(np.float32)
    jm.texture = JImage(rng.integers(0, 256, (8, 12, 3), dtype=np.uint8))
    tm = textured_mesh(jm)
    a = str(tmp_path / "t.obj")
    tio.write_triangle_mesh(a, tm)
    assert os.path.exists(str(tmp_path / "t.mtl"))
    for got in (tio.read_triangle_mesh(a, device="cpu"),
                textured_mesh(jio.read_triangle_mesh(a))):
        np.testing.assert_allclose(got.vertices.numpy(),
                                   np.asarray(jm.vertices), **TEXT)
        np.testing.assert_array_equal(got.triangles.numpy(),
                                      np.asarray(jm.triangles))
        np.testing.assert_allclose(got.triangle_uvs.numpy(),
                                   np.asarray(jm.triangle_uvs), **TEXT)
        np.testing.assert_array_equal(got.texture.to_numpy(),
                                      np.asarray(jm.texture.data))
    b = str(tmp_path / "j.obj")
    jio.write_triangle_mesh(b, jm)
    got = tio.read_triangle_mesh(b, device="cpu")
    np.testing.assert_array_equal(got.texture.to_numpy(),
                                  np.asarray(jm.texture.data))
    np.testing.assert_array_equal(
        got.sample_texture_vertex_colors().numpy(),
        jm.sample_texture_vertex_colors())


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

def _images():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:23, 0:31]
    smooth = (xx * 7 + yy * 3) % 256
    return {
        "gray8": smooth.astype(np.uint8)[..., None],
        "rgb8": np.stack([smooth, 255 - smooth, rng.integers(0, 256,
                          smooth.shape)], -1).astype(np.uint8),
        "rgba8": rng.integers(0, 256, (23, 31, 4), dtype=np.uint8),
        "gray16": (smooth * 251 + rng.integers(0, 200, smooth.shape))
        .astype(np.uint16)[..., None],
        "graya8": rng.integers(0, 256, (23, 31, 2), dtype=np.uint8),
    }


@pytest.mark.parametrize("name", list(_images()))
def test_torch_png_codec_matches_pil(tmp_path, name):
    arr = _images()[name]
    a = str(tmp_path / "t.png")
    tio.write_image(a, TImage(arr, device="cpu"))
    pil = np.asarray(PILImage.open(a))
    np.testing.assert_array_equal(pil.reshape(arr.shape), arr)
    got = tio.read_image(a, device="cpu")
    assert got.data.dtype == torch.from_numpy(arr).dtype
    np.testing.assert_array_equal(got.to_numpy(), arr)
    # PIL's writer uses adaptive row filters; 16-bit goes through I;16
    b = str(tmp_path / "p.png")
    PILImage.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr).save(
        b, optimize=True)
    np.testing.assert_array_equal(tio.read_image(b, device="cpu")
                                  .to_numpy(), arr)
    np.testing.assert_array_equal(jio.read_image(a).to_numpy(), arr)


def test_torch_png_every_filter_type(tmp_path):
    """Rows written with each of the five filters by hand."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (10, 9, 3), dtype=np.uint8)
    bpp, rows, prior = 3, [], np.zeros(27, np.int64)
    for y in range(10):
        ft = y % 5
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ft == 0:
            f = cur
        elif ft == 1:
            f = cur - left
        elif ft == 2:
            f = cur - prior
        elif ft == 3:
            f = cur - (left + prior) // 2
        else:
            f = cur - np.asarray([timage_io._paeth(int(a), int(b), int(c))
                                  for a, b, c in zip(left, prior, ul)])
        rows.append(bytes([ft]) + (f % 256).astype(np.uint8).tobytes())
        prior = cur
    import zlib

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 9, 10, 8, 2, 0, 0, 0)) + chunk(
            b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(np.asarray(PILImage.open(path)), img)
    np.testing.assert_array_equal(timage_io.read_png(path), img)


def test_torch_float_images_and_jpeg(tmp_path, monkeypatch):
    f = np.linspace(0, 1, 12 * 8, dtype=np.float32).reshape(8, 12, 1)
    a = str(tmp_path / "f.png")
    tio.write_image(a, TImage(f, device="cpu"))
    want = np.clip(f * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(tio.read_image(a, device="cpu")
                                  .to_numpy(), want)
    rgb = _images()["rgb8"]
    j = str(tmp_path / "c.jpg")
    tio.write_image(j, TImage(rgb, device="cpu"))
    np.testing.assert_array_equal(tio.read_image(j, device="cpu")
                                  .to_numpy(), jio.read_image(j).to_numpy())
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        tio.read_image(j, device="cpu")
    tio.write_image(a, TImage(rgb, device="cpu"))      # PNG needs no PIL
    np.testing.assert_array_equal(tio.read_image(a, device="cpu")
                                  .to_numpy(), rgb)


# ---------------------------------------------------------------------------
# voxel grids, JSON, trajectories, ROS, DLPack, ATE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ascii_", [False, True])
def test_torch_voxel_grid_ply_cross_packages(tmp_path, ascii_):
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(-20, 20, (300, 3)), axis=0) \
        .astype(np.int32)
    cols = (rng.integers(0, 256, (len(keys), 3)) / 255.0).astype(np.float32)
    vg = TVoxelGrid.from_numpy(keys, cols, 0.05, (0.5, -1.0, 2.0),
                               device="cpu")
    a = str(tmp_path / "v.ply")
    tio.write_voxel_grid(a, vg, write_ascii=ascii_)
    for got in (tio.read_voxel_grid(a, device="cpu"), jio.read_voxel_grid(a)):
        np.testing.assert_array_equal(_np(got.voxels_keys), keys)
        np.testing.assert_allclose(_np(got.voxels_colors), cols, atol=1e-7)
        assert got.voxel_size == pytest.approx(0.05)
        np.testing.assert_array_equal(np.asarray(got.origin, np.float32),
                                      np.float32([0.5, -1.0, 2.0]))
    b = str(tmp_path / "j.ply")
    jio.write_voxel_grid(b, jio.read_voxel_grid(a), write_ascii=ascii_)
    got = tio.read_voxel_grid(b, device="cpu")
    np.testing.assert_array_equal(got.voxels_keys.numpy(), keys)


def test_torch_camera_json_and_trajectory_log(tmp_path):
    cam = ctt.camera
    intr = cam.PinholeCameraIntrinsic(640, 480, 525.0, 524.0, 319.5, 239.5)
    p = str(tmp_path / "i.json")
    tio.write_pinhole_camera_intrinsic(p, intr)
    assert json.load(open(p)) == intr.to_dict()
    for got in (tio.read_pinhole_camera_intrinsic(p),
                jio.read_pinhole_camera_intrinsic(p)):
        np.testing.assert_array_equal(got.intrinsic_matrix,
                                      intr.intrinsic_matrix)
        assert (got.width, got.height) == (640, 480)
    assert tio.read_pinhole_camera_intrinsic(p).intrinsic_matrix \
        .flags.c_contiguous
    params = cam.PinholeCameraParameters()
    params.intrinsic = intr
    params.extrinsic[:3, 3] = (1.0, 2.0, 3.0)
    q = str(tmp_path / "p.json")
    tio.write_pinhole_camera_parameters(q, params)
    got = tio.read_pinhole_camera_parameters(q)
    np.testing.assert_array_equal(got.extrinsic, params.extrinsic)
    assert got.extrinsic.flags.c_contiguous
    np.testing.assert_array_equal(
        jio.read_pinhole_camera_parameters(q).extrinsic, params.extrinsic)
    with pytest.raises(RuntimeError):
        tio.write_ijson_convertible_to_json(q, object())
    rng = np.random.default_rng(8)
    poses = [np.eye(4, dtype=np.float32) for _ in range(5)]
    for T in poses:
        T[:3, 3] = rng.normal(size=3)
    t = str(tmp_path / "trajectory.log")
    tio.write_trajectory_log(t, poses)
    for got in (tio.read_trajectory_log(t), jio.read_trajectory_log(t)):
        np.testing.assert_array_equal(np.stack(got), np.stack(poses))


def test_torch_ros_messages_match_jax():
    p = _cloud(50, colors=True, normals=False)
    data, info = tros.create_to_pointcloud2_msg(p)
    jp = JPointCloud(p.points.numpy())
    jp.colors = p.colors.numpy()
    jdata, _ = jio.ros.create_to_pointcloud2_msg(jp)
    assert data == jdata and info.point_step == 32
    back = tros.create_from_pointcloud2_msg(data, info, device="cpu")
    _same_cloud(p, back)
    bare = _cloud(30, colors=False, normals=False)
    data, info = tros.create_to_pointcloud2_msg(bare)
    np.testing.assert_array_equal(
        tros.create_from_pointcloud2_msg(data, info, device="cpu")
        .points.numpy(), bare.points.numpy())
    for arr, enc in ((_images()["rgb8"], "bgr8"), (_images()["gray16"],
                                                     None)):
        img = TImage(arr, device="cpu")
        info = None if enc is None else tros.ImageMsgInfo(
            arr.shape[1], arr.shape[0], enc)
        data, info = tros.create_to_image_msg(img, info)
        jdata, _ = jio.ros.create_to_image_msg(JImage(arr), info)
        assert data == jdata
        got = tros.create_from_image_msg(data, info, device="cpu")
        np.testing.assert_array_equal(got.to_numpy(), arr)


def test_torch_dlpack_round_trips():
    p = _cloud(40)
    t = torch.from_dlpack(p.to_points_dlpack())
    np.testing.assert_array_equal(t.numpy(), p.points.numpy())
    q = TPointCloud(device="cpu")
    q.from_points_dlpack(jnp.asarray(p.points.numpy()))    # __dlpack__
    q.from_colors_dlpack(dl_converter.to_dlpack(p.colors))  # a capsule
    np.testing.assert_array_equal(q.points.numpy(), p.points.numpy())
    np.testing.assert_array_equal(q.colors.numpy(), p.colors.numpy())
    np.testing.assert_array_equal(
        np.from_dlpack(p.normals), _np(torch.from_dlpack(
            p.to_normals_dlpack())))
    m = TMesh(p.points, np.zeros((0, 3), np.int32), device="cpu")
    m2 = TMesh(device="cpu")
    m2.from_vertices_dlpack(m.to_vertices_dlpack())
    np.testing.assert_array_equal(m2.vertices.numpy(), p.points.numpy())
    c = dl_converter.pointcloud_from_points_dlpack(
        dl_converter.pointcloud_to_points_dlpack(p))
    assert c.device.type == "cpu" and len(c) == 40


def test_torch_compute_ate_matches_jax():
    rng = np.random.default_rng(9)
    gt, est = [], []
    for _ in range(6):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(size=3)
        gt.append(T)
        E = T.copy()
        E[:3, 3] += rng.normal(scale=0.01, size=3)
        est.append(E)
    assert tate.compute_ate(est, gt) == jate.compute_ate(est, gt) > 0
    assert tate.compute_ate(gt, gt) == 0.0


def test_torch_run_sequence_reads_the_testdata_layout(tmp_path):
    """Three frames of chip_smoke's room at 80x60 written as the
    reference's test data (16-bit depth and 8-bit colour PNG, the camera
    JSON, trajectory.log): the poses from disk equal those of the same
    frames in memory, and the ATE is that of `compute_ate`."""
    import chip_smoke as cs

    cam = ctt.camera
    intr = cam.PinholeCameraIntrinsic(
        cam.PinholeCameraIntrinsicParameters.PrimeSenseDefault).scale(0.125)
    frames, gt = cs.write_rgbd_sequence(np, ctt, str(tmp_path), intr, 3)
    create = ctt.geometry.RGBDImage.create_from_color_and_depth
    mem = [create(TImage(c, device="cpu"), TImage(d, device="cpu"))
           for c, d in frames]
    want = tate.odometry_trajectory(mem, intr)
    ate, n, poses = tate.run_sequence(str(tmp_path), device="cpu")
    assert n == 3
    np.testing.assert_array_equal(np.stack(poses), np.stack(want))
    assert ate == tate.compute_ate(poses, gt)
    depth0 = jio.read_image(str(tmp_path / "rgbd" / "depth" / "000000.png"))
    assert depth0.to_numpy().dtype == np.uint16
    np.testing.assert_array_equal(depth0.to_numpy()[..., 0], frames[0][1])
