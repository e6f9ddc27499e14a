"""The port's mesh factories, collision primitives and
`compute_intersection` (cupoch_tpu_torch.geometry.trianglemesh_factory,
cupoch_tpu_torch.collision) against the JAX package on the same seeded
numpy inputs, on the CPU.

Tolerances: factory meshes' vertices within 1e-6 and equal triangles;
collision pairs as equal sets, where the narrow phase multiplies (the
primitives' frames, a mesh's ray parity) up to FMA_SHARE of the pairs
(numpy's BLAS and XLA fuse products into FMAs the port does not: ROADMAP
Queue 3); voxelizations' keys likewise; the bucket broad phase's pairs
and drop counts equal to the JAX package's and to the dense phase's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_bridge as bridge
from cupoch_tpu import collision as jcol
from cupoch_tpu.collision import collision as jcollision
from cupoch_tpu.geometry import LineSet as JLineSet
from cupoch_tpu.geometry import OccupancyGrid as JOcc
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.geometry import TriangleMesh as JMesh
from cupoch_tpu.geometry import VoxelGrid as JVG
from cupoch_tpu_torch import collision as tcol
from cupoch_tpu_torch.collision import collision as tcollision
from cupoch_tpu_torch.geometry import TriangleMesh as TMesh

FMA_SHARE = 5e-3
CPU = "cpu"


def _pairs(x):
    """The rows of an [N, k] array or tensor as a set of tuples."""
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return set(map(tuple, a.reshape(a.shape[0], -1).tolist()))


def _close_sets(a, b, share=FMA_SHARE):
    a, b = _pairs(a), _pairs(b)
    assert len(a ^ b) <= share * max(len(a), 1), (len(a), len(a ^ b))
    return a


def _pose(seed, t=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = q * np.sign(np.linalg.det(q))
    T[:3, 3] = t
    return T


# ---------------------------------------------------------------------------
# mesh factories
# ---------------------------------------------------------------------------

FACTORIES = {
    "tetrahedron": (0.7,), "octahedron": (0.7,), "icosahedron": (0.7,),
    "box": (0.3, 0.5, 0.7), "sphere": (0.5, 12), "half_sphere": (0.5, 12),
    "cylinder": (0.3, 1.0, 16, 3), "tube": (0.3, 1.0, 16, 3),
    "capsule": (0.2, 0.6, 10, 2), "cone": (0.4, 0.9, 16, 2),
    "torus": (1.0, 0.3, 12, 8), "arrow": (0.1, 0.2, 0.6, 0.3, 12, 2, 1),
    "coordinate_frame": (0.5, (0.1, 0.2, 0.3)), "moebius": (30, 6, 1),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_torch_mesh_factory_matches_jax(name):
    j = getattr(JMesh, "create_" + name)(*FACTORIES[name])
    t = getattr(TMesh, "create_" + name)(*FACTORIES[name], device=CPU)
    np.testing.assert_allclose(t.vertices.numpy(), np.asarray(j.vertices),
                               atol=1e-6)
    np.testing.assert_array_equal(t.triangles.numpy(),
                                  np.asarray(j.triangles))
    if j.has_vertex_colors():
        np.testing.assert_allclose(t.vertex_colors.numpy(),
                                   np.asarray(j.vertex_colors))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _prim_pair(kind, seed=0):
    T = _pose(seed, (0.1, -0.2, 0.05))
    if kind == "box":
        return (jcol.Box((0.6, 0.4, 0.3), T),
                tcol.Box((0.6, 0.4, 0.3), T, device=CPU))
    if kind == "sphere":
        return jcol.Sphere(0.35, (0.1, 0.0, -0.1)), \
            tcol.Sphere(0.35, (0.1, 0.0, -0.1), device=CPU)
    if kind == "capsule":
        return (jcol.Capsule(0.15, 0.5, T),
                tcol.Capsule(0.15, 0.5, T, device=CPU))
    if kind == "cylinder":
        return (jcol.Cylinder(0.2, 0.5, T),
                tcol.Cylinder(0.2, 0.5, T, device=CPU))
    m = JMesh.create_icosahedron(0.4)
    return (jcol.Mesh.from_triangle_mesh(m, T),
            tcol.Mesh(np.asarray(m.vertices), np.asarray(m.triangles), T,
                      device=CPU))


KINDS = ["box", "sphere", "capsule", "cylinder", "mesh"]


@pytest.mark.parametrize("kind", KINDS)
def test_torch_primitive_contains_and_bounds_match_jax(kind):
    jp, tp = _prim_pair(kind)
    for a, b in zip(tp._aabb_bounds(), jp._aabb_bounds()):
        np.testing.assert_allclose(a, b, atol=1e-7)
    pts = np.random.default_rng(1).uniform(-0.7, 0.7, (4000, 3)).astype(
        np.float32)
    for margin in (0.0, 0.05 + 0.1 * np.sqrt(3.0) / 2.0):
        want = jp._contains(pts, margin=margin)
        got = tp._contains(torch.as_tensor(pts), margin=margin).numpy()
        assert 0.01 < want.mean() < 0.9
        assert (want != got).mean() <= FMA_SHARE


@pytest.mark.parametrize("kind", KINDS)
def test_torch_primitive_voxel_grid_matches_jax(kind):
    jp, tp = _prim_pair(kind, seed=2)
    jvg = jp.create_voxel_grid(0.05)
    tvg = tp.create_voxel_grid(0.05)
    np.testing.assert_array_equal(tvg.origin, jvg.origin)
    assert len(jvg) > 50
    _close_sets(jvg.voxels_keys, tvg.voxels_keys)


@pytest.mark.parametrize("kind", ["box", "capsule", "cylinder"])
def test_torch_primitive_sweep_matches_jax(kind):
    jp, tp = _prim_pair(kind, seed=3)
    dst = _pose(4, (0.5, 0.2, -0.1))
    jvg = jp.create_voxel_grid_with_sweeping(0.05, dst, sampling=5)
    tvg = tp.create_voxel_grid_with_sweeping(0.05, dst, sampling=5)
    np.testing.assert_array_equal(tvg.origin, jvg.origin)
    assert len(jvg) > 200
    _close_sets(jvg.voxels_keys, tvg.voxels_keys)


@pytest.mark.parametrize("kind", ["box", "sphere", "capsule", "cylinder"])
def test_torch_primitive_mesh_matches_jax(kind):
    jp, tp = _prim_pair(kind, seed=5)
    jm, tm = jp.create_mesh(), tp.create_mesh()
    np.testing.assert_allclose(tm.vertices.numpy(), np.asarray(jm.vertices),
                               atol=1e-6)
    np.testing.assert_array_equal(tm.triangles.numpy(),
                                  np.asarray(jm.triangles))


# ---------------------------------------------------------------------------
# compute_intersection over every type pair
# ---------------------------------------------------------------------------

def _scene():
    rng = np.random.default_rng(10)
    pts = rng.uniform(-0.8, 0.8, (400, 3)).astype(np.float32)
    jvg1 = JVG.create_from_point_cloud(JPointCloud(pts), 0.1)
    jvg2 = JVG.create_from_point_cloud(
        JPointCloud(pts[::2] + np.float32(0.03)), 0.07)
    jog = JOcc(0.1, 32)
    jog.insert(rng.uniform(-1.0, 1.0, (300, 3)).astype(np.float32),
               np.zeros(3, np.float32))
    lp = rng.uniform(-1.0, 1.0, (80, 3)).astype(np.float32)
    lines = np.stack([np.arange(0, 80, 2), np.arange(1, 80, 2)], -1)
    jls = JLineSet(lp, lines)
    prims = [_prim_pair(k, seed=20 + i) for i, k in enumerate(
        ["box", "sphere", "capsule", "cylinder"])]
    prims2 = [_prim_pair(k, seed=30 + i) for i, k in enumerate(
        ["sphere", "cylinder"])]
    j = dict(v=jvg1, w=jvg2, o=jog, l=jls, p=[a for a, _ in prims],
             q=[a for a, _ in prims2])
    t = dict(v=bridge.voxel_grid(jvg1), w=bridge.voxel_grid(jvg2),
             o=bridge.occupancy_grid(jog), l=bridge.line_set(jls),
             p=[b for _, b in prims], q=[b for _, b in prims2])
    return j, t


PAIRS = ["vw", "vl", "lv", "vo", "ov", "ol", "lo", "pv", "vp", "po", "op",
         "pq"]


@pytest.mark.parametrize("pair", PAIRS)
def test_torch_compute_intersection_matches_jax(pair):
    j, t = _scene()
    margin = 0.02
    jr = jcol.compute_intersection(j[pair[0]], j[pair[1]], margin)
    tr = tcol.compute_intersection(t[pair[0]], t[pair[1]], margin)
    assert (tr.first, tr.second) == (jr.first, jr.second)
    got = _close_sets(jr.get_collision_index_pairs(),
                      tr.get_collision_index_pairs(),
                      FMA_SHARE if "p" in pair else 0.0)
    assert len(got) > 0 and tr.is_collided()
    if "p" not in pair:
        for k in ("first", "second"):
            np.testing.assert_array_equal(
                getattr(tr, f"get_{k}_collision_indices")().numpy(),
                getattr(jr, f"get_{k}_collision_indices")())
    assert tr.route == "dense" and tr.n_dropped == 0


# ---------------------------------------------------------------------------
# the bucket broad phase
# ---------------------------------------------------------------------------

def _boxes(seed, n, size, spread=1.0):
    lo = np.random.default_rng(seed).uniform(size=(n, 3)).astype(
        np.float32) * spread
    return lo, lo + np.float32(size)


@pytest.mark.parametrize("margin", [0.0, 0.03])
def test_torch_bucket_pairs_equal_dense(margin):
    lo1, hi1 = _boxes(40, 400, 0.05)
    lo2, hi2 = _boxes(41, 500, 0.04)
    t = [torch.as_tensor(a) for a in (lo1, hi1, lo2, hi2)]
    dense = tcollision.aabb_overlap_pairs(*t, margin)
    got, dropped = tcollision.bucket_overlap_pairs(*t, margin)
    assert dropped == 0 and len(_pairs(dense)) > 20
    assert _pairs(got) == _pairs(dense)
    want = jcollision._pairs_from_matrix(jcollision._aabb_overlap_pairs(
        *map(jnp.asarray, (lo1, hi1, lo2, hi2)), margin))
    np.testing.assert_array_equal(dense.numpy(), want)


def test_torch_bucket_pairs_and_drops_match_jax():
    lo1, hi1 = _boxes(42, 200, 0.05, 0.5)
    lo2, hi2 = _boxes(43, 200, 0.05, 0.5)
    lo2[:40] = lo2[0]                      # one crowded cell
    hi2[:40] = hi2[0]
    lo1[:40] = lo2[0] + np.float32(0.01)
    hi1[:40] = lo1[:40] + np.float32(0.05)
    t = [torch.as_tensor(a) for a in (lo1, hi1, lo2, hi2)]
    got, dropped = tcollision.bucket_overlap_pairs(*t, 0.0)
    jp, jd = jcollision._bucket_overlap_pairs(lo1, hi1, lo2, hi2, 0.0)
    assert dropped == jd > 0
    assert _pairs(got) == _pairs(jp)


@pytest.mark.parametrize("pair", ["vw", "vo", "ov"])
def test_torch_voxel_sets_take_bucket_route(pair, monkeypatch):
    j, t = _scene()
    jr = jcol.compute_intersection(j[pair[0]], j[pair[1]], 0.01)
    monkeypatch.setattr(tcollision, "_DENSE_LIMIT", 1000)
    tr = tcol.compute_intersection(t[pair[0]], t[pair[1]], 0.01)
    assert tr.route == "bucket" and tr.n_dropped == 0
    assert _pairs(tr.collision_index_pairs) == \
        _pairs(jr.collision_index_pairs)


def test_torch_mesh_primitive_against_voxel_grid_matches_jax():
    T = _pose(50, (0.2, -0.1, 0.3))
    jm = JMesh.create_box(1.0, 0.8, 0.6)
    jp = jcol.Mesh.from_triangle_mesh(jm, T)
    tp = tcol.Mesh.from_triangle_mesh(bridge.mesh(jm), T)
    jvg = jcol.Box((1.0, 1.0, 1.0)).create_voxel_grid(0.1)
    tvg = bridge.voxel_grid(jvg)
    jr = jcol.compute_intersection([jp], jvg, 0.0)
    tr = tcol.compute_intersection([tp], tvg, 0.0)
    assert len(_close_sets(jr.collision_index_pairs,
                           tr.collision_index_pairs)) > 20
    _close_sets(jp.create_voxel_grid(0.1).voxels_keys,
                tp.create_voxel_grid(0.1).voxels_keys)
