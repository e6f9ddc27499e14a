"""The port's uniform TSDF volume and triangle mesh (cupoch_tpu_torch.
integration, geometry.trianglemesh) against the JAX package on the same
numpy inputs, on the CPU: tests/test_kinfu.py's room corner at 64x48
seen from two poses, into a 64^3 volume over 4 m, in each colour type.

Tolerances: tsdf, weight and colour within 1e-5 after one and two
frames; with the reference's refinement (`tsdf_ops.REFINE_STEPS` = 1)
the raycast's hit masks equal on >= 99.9% of the pixels, and points,
normals and colours within 1e-5 where both hit; at the port's default
refinement it hits every pixel the reference hits (>= 99.9%), equal
there, and its further hits (the crossings the reference's refinement
misses, ROADMAP Queue 3) lie on the scene's planes within half a voxel,
as the shared ones do; the marching-cubes mesh's sorted vertices within
1e-5 with equal triangle counts; the extracted clouds within 1e-5; a
JAX volume carried over by `UniformTSDFVolume.from_numpy` raycasts as
the JAX volume does (at the reference's refinement).
"""
import numpy as np
import pytest
import torch

import test_kinfu as corner
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import RGBDImage as JRGBDImage
from cupoch_tpu.geometry import TriangleMesh as JMesh
from cupoch_tpu.integration import TSDFVolumeColorType as JColorType
from cupoch_tpu.integration import UniformTSDFVolume as JVolume
from cupoch_tpu_torch.geometry import TriangleMesh as TMesh
from cupoch_tpu_torch.integration import TSDFVolumeColorType as TColorType
from cupoch_tpu_torch.integration import UniformTSDFVolume as TVolume
from cupoch_tpu_torch.integration import tsdf_ops as ttsdf
from torch_port_bridge import intrinsic as to_port_intrinsic
from torch_port_bridge import rgbd as to_port_rgbd

TOL = dict(rtol=0.0, atol=1e-5)
VOLUME = dict(length=4.0, resolution=64, sdf_trunc=0.2)
ORIGIN = (0.0, 0.0, 2.0)


def _close(a, b, **tol):
    b = b.numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(b, np.asarray(a), **(tol or TOL))


def _hit_parity(jp, tp):
    """Both raycasts' hit masks equal on >= 99.9% of the pixels, and
    their points, normals and colours within 1e-5 where both hit."""
    hj = np.isfinite(np.asarray(jp.points)).all(-1)
    ht = torch.isfinite(tp.points).all(-1).numpy()
    assert (hj == ht).mean() >= 0.999 and hj.mean() > 0.5
    for name in ("points", "normals", "colors"):
        _close(np.asarray(getattr(jp, name))[hj & ht],
               getattr(tp, name).numpy()[hj & ht])


def _frames():
    """Two views of the corner with a random colour texture: (JAX
    RGBDImage, world-to-camera extrinsic) each."""
    rng = np.random.default_rng(0)
    out = []
    for t in ((0.0, 0.0, 0.0), (0.05, -0.02, 0.03)):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = t
        depth = corner.render_scene_depth(pose, corner.CORNER)
        color = rng.random((corner.H, corner.W, 3)).astype(np.float32)
        out.append((JRGBDImage(JImage(color), JImage(depth[..., None])),
                    np.linalg.inv(pose).astype(np.float32)))
    return out


FRAMES = _frames()


def _volumes(color_type, n_frames):
    jv = JVolume(color_type=JColorType(int(color_type)), origin=ORIGIN,
                 **VOLUME)
    tv = TVolume(color_type=color_type, origin=ORIGIN, device="cpu",
                 **VOLUME)
    jin = corner.intrinsic()
    for rgbd, extrinsic in FRAMES[:n_frames]:
        jv.integrate(rgbd, jin, extrinsic)
        tv.integrate(to_port_rgbd(rgbd), to_port_intrinsic(jin), extrinsic)
    return jv, tv


@pytest.fixture(scope="module")
def volumes():
    return _volumes(TColorType.RGB8, 2)


@pytest.mark.parametrize("color_type", list(TColorType))
@pytest.mark.parametrize("n_frames", [1, 2])
def test_torch_integrate_matches_jax(color_type, n_frames):
    jv, tv = _volumes(color_type, n_frames)
    _close(jv.tsdf, tv.tsdf)
    _close(jv.weight, tv.weight)
    _close(jv.color, tv.color)
    assert float(tv.weight.max()) == n_frames


@pytest.mark.parametrize("frame", [0, 1])
def test_torch_raycast_matches_jax(volumes, frame):
    jv, tv = volumes
    jin = corner.intrinsic()
    extrinsic = FRAMES[frame][1]
    for intr in (jin, jin.scale(0.5)):
        jp = jv.raycast(intr, extrinsic, project_valid_depth_only=False)
        tp = tv.raycast(to_port_intrinsic(intr), extrinsic,
                        project_valid_depth_only=False)
        hj = np.isfinite(np.asarray(jp.points)).all(-1)
        ht = torch.isfinite(tp.points).all(-1).numpy()
        # every reference hit is a port hit, and equal to it; the port
        # also finds the crossings the reference's three refinement
        # samples miss (ROADMAP Queue 3); all lie on the scene's planes
        # within half a voxel
        assert (ht | ~hj).mean() >= 0.999 and hj.mean() > 0.5
        both = hj & ht
        for name in ("points", "normals", "colors"):
            _close(np.asarray(getattr(jp, name))[both],
                   getattr(tp, name).numpy()[both])
        pts = tp.points.numpy()
        off = np.min([np.abs(pts @ np.asarray(n) - d)
                      for n, d in corner.CORNER], 0)
        assert off[ht].max() <= 0.5 * tv.voxel_length
        compact = tv.raycast(to_port_intrinsic(intr), extrinsic)
        assert len(compact) == int(ht.sum())


@pytest.mark.parametrize("frame", [0, 1])
def test_torch_raycast_with_reference_refinement_matches_jax(
        volumes, frame, monkeypatch):
    monkeypatch.setattr(ttsdf, "REFINE_STEPS", 1)
    jv, tv = volumes
    jin = corner.intrinsic()
    extrinsic = FRAMES[frame][1]
    for intr in (jin, jin.scale(0.5)):
        _hit_parity(jv.raycast(intr, extrinsic,
                               project_valid_depth_only=False),
                    tv.raycast(to_port_intrinsic(intr), extrinsic,
                               project_valid_depth_only=False))

def test_torch_mesh_matches_jax(volumes):
    jv, tv = volumes
    jm, tm = jv.extract_triangle_mesh(), tv.extract_triangle_mesh()
    vj, vt = np.asarray(jm.vertices), tm.vertices.numpy()
    assert len(vt) == len(vj) > 100
    assert tm.triangles.shape[0] == np.asarray(jm.triangles).shape[0]
    order_j = np.lexsort(vj.T[::-1])
    order_t = np.lexsort(vt.T[::-1])
    _close(vj[order_j], vt[order_t])
    # the weld's order follows the integer edge keys, so the meshes
    # match row for row as well
    np.testing.assert_array_equal(tm.triangles.numpy(),
                                  np.asarray(jm.triangles))
    _close(jm.vertex_colors, tm.vertex_colors)
    _close(jm.vertex_normals, tm.vertex_normals, rtol=0.0, atol=1e-4)
    assert tm.get_surface_area() == pytest.approx(jm.get_surface_area(),
                                                  rel=1e-5)


def test_torch_extracted_clouds_match_jax(volumes):
    jv, tv = volumes
    jp, tp = jv.extract_point_cloud(), tv.extract_point_cloud()
    assert len(tp) == len(jp) > 100
    for name in ("points", "normals", "colors"):
        _close(getattr(jp, name), getattr(tp, name))
    jp, tp = jv.extract_voxel_point_cloud(), tv.extract_voxel_point_cloud()
    assert len(tp) == len(jp) > 100
    _close(jp.points, tp.points)
    _close(jp.colors, tp.colors)


def test_torch_from_numpy_carries_a_jax_volume(volumes, monkeypatch):
    monkeypatch.setattr(ttsdf, "REFINE_STEPS", 1)
    jv, _ = volumes
    tv = TVolume.from_numpy(
        np.asarray(jv.tsdf), np.asarray(jv.weight), np.asarray(jv.color),
        color_type=TColorType.RGB8, origin=ORIGIN, device="cpu", **VOLUME)
    jin = corner.intrinsic()
    extrinsic = FRAMES[1][1]
    _hit_parity(jv.raycast(jin, extrinsic, project_valid_depth_only=False),
                tv.raycast(to_port_intrinsic(jin), extrinsic,
                           project_valid_depth_only=False))
    with pytest.raises(ValueError, match="shape"):
        TVolume.from_numpy(np.zeros((8, 8, 8)), np.zeros((8, 8, 8)),
                           np.zeros((8, 8, 8, 3)), device="cpu", **VOLUME)


def test_torch_volume_reset_and_metadata(volumes):
    _, tv = volumes
    fresh = TVolume(color_type=TColorType.RGB8, origin=ORIGIN,
                    device="cpu", **VOLUME)
    fresh.tsdf.copy_(tv.tsdf)
    fresh.weight.fill_(1.0)
    fresh.reset()
    assert float(fresh.weight.abs().max()) == 0.0
    assert float(fresh.tsdf.abs().max()) == 0.0
    assert fresh.voxel_num == 64 ** 3
    np.testing.assert_allclose(fresh.corner, [-2.0, -2.0, 0.0])
    assert fresh.extract_triangle_mesh().is_empty()
    assert fresh.extract_point_cloud().is_empty()


def test_torch_sphere_mesh_matches_jax():
    """A sphere's SDF written into both volumes: the marching-cubes mesh
    is watertight, with the reference's vertices, area and volume."""
    R = 48
    jv = JVolume(2.0, R, 0.5, JColorType.NoColor)
    tv = TVolume(2.0, R, 0.5, TColorType.NoColor, device="cpu")
    r = (np.arange(R) + 0.5) * jv.voxel_length - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    f = np.clip((np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6) / 0.5, -1, 1) \
        .astype(np.float32)
    import jax.numpy as jnp

    jv.tsdf = jnp.asarray(f)
    jv.weight = jnp.ones((R, R, R), jnp.float32)
    tv.tsdf.copy_(torch.from_numpy(f))
    tv.weight.fill_(1.0)
    jm, tm = jv.extract_triangle_mesh(), tv.extract_triangle_mesh()
    t = tm.triangles.numpy()
    edges = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]],
                                    t[:, [2, 0]]]), 1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    _close(jm.vertices, tm.vertices)
    np.testing.assert_array_equal(t, np.asarray(jm.triangles))
    assert tm.get_surface_area() == pytest.approx(jm.get_surface_area(),
                                                  rel=1e-5)
    assert tm.get_volume() == pytest.approx(jm.get_volume(), rel=1e-5)
    assert tm.get_volume() == pytest.approx(4 / 3 * np.pi * 0.6 ** 3,
                                            rel=0.05)


def test_torch_triangle_mesh_ops_match_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    t = rng.integers(0, 30, size=(50, 3)).astype(np.int32)
    t[:3, 1] = t[:3, 0]                       # degenerate triangles
    c = rng.random((30, 3)).astype(np.float32)
    jm, tm = JMesh(v, t), TMesh(v, t, device="cpu")
    jm.vertex_colors, tm.vertex_colors = c, c
    jm.compute_triangle_normals()
    tm.compute_triangle_normals()
    _close(jm.triangle_normals, tm.triangle_normals)
    jm.compute_vertex_normals()
    tm.compute_vertex_normals()
    _close(jm.vertex_normals, tm.vertex_normals)
    assert tm.get_surface_area() == pytest.approx(jm.get_surface_area(),
                                                  rel=1e-5)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    T[:3, 3] = [1.0, 2.0, 3.0]
    for op, args in (("transform", (T,)), ("translate", ([0.5, 0, -1],)),
                     ("translate", ([0.5, 0, -1], False)),
                     ("rotate", (T[:3, :3],)), ("scale", (1.5,)),
                     ("scale", (0.5, False))):
        getattr(jm, op)(*args)
        getattr(tm, op)(*args)
        _close(jm.vertices, tm.vertices)
        _close(jm.vertex_normals, tm.vertex_normals)
    js, ts = jm + jm, tm + tm
    _close(js.vertices, ts.vertices)
    np.testing.assert_array_equal(ts.triangles.numpy(),
                                  np.asarray(js.triangles))
    _close(js.vertex_colors, ts.vertex_colors)
    jm.remove_degenerate_triangles()
    tm.remove_degenerate_triangles()
    np.testing.assert_array_equal(tm.triangles.numpy(),
                                  np.asarray(jm.triangles))
    assert not tm.is_empty() and TMesh(device="cpu").is_empty()


def test_torch_marching_cubes_passes_match_jax(volumes):
    """The classification, compaction and emission passes one by one."""
    import jax.numpy as jnp
    from cupoch_tpu.integration import tsdf_ops as jops
    from cupoch_tpu_torch.integration import tsdf_ops as tops

    jv, tv = volumes
    R = tv.resolution
    cj = np.asarray(jops.mc_classify(jv.tsdf, jv.weight, R))
    ct = tops.mc_classify(tv.tsdf, tv.weight)
    np.testing.assert_array_equal(ct.numpy(), cj)
    flat_j, flat_t = jnp.asarray(cj.reshape(-1)), ct.reshape(-1)
    cap = 4096
    ids_j, n_j = jops.mc_compact(flat_j, cap)
    ids_t, n_t = tops.mc_compact(flat_t, cap)
    assert int(n_t) == int(n_j) > 0
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    origin = np.asarray([tv.corner], np.float32)
    out_j = jops.mc_emit_blocks(
        jv.tsdf[None], jv.color[None], flat_j, ids_j, jnp.asarray(origin),
        jnp.zeros((1, 3), jnp.int32), jnp.float32(tv.voxel_length), R, 3)
    out_t = tops.mc_emit_blocks(
        tv.tsdf[None], tv.color[None], flat_t, ids_t,
        torch.from_numpy(origin), torch.zeros((1, 3), dtype=torch.int64),
        tv.voxel_length, R, 3)
    valid = np.asarray(out_j[3])
    np.testing.assert_array_equal(out_t[3].numpy(), valid)
    rows = np.repeat(valid, 3, axis=1)            # [cap, 15] live vertices
    for a, b in zip(out_j[:3], out_t[:3]):
        _close(np.asarray(a)[rows], b.numpy()[rows])
