"""The rest of the port's TriangleMesh (cupoch_tpu_torch.geometry.
trianglemesh) against the JAX package's on the same numpy inputs, on the
CPU: the cleanups, uniform sampling, the neighbour filters, the boxes,
the self-intersection test on its dense and bucket routes, and texture
colours through the corners' UVs.

Tolerances: cleanups equal (vertices, colours, normals and triangles,
row for row); sampled points, normals and colours within 1e-6 with the
JAX package's draws fed to `sample_uniform`; the filters within 1e-5
after up to 3 iterations (the port sums each vertex's neighbours in
float64 and rounds once, the reference in float32 in index order);
the boxes within 1e-5; the intersecting pairs equal as sets to the JAX
package's dense route (its bucket route drops pairs); texture
colours equal. The adjacency sums within 1e-6 relative.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cupoch_tpu.collision import collision as jcollision
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import TriangleMesh as JMesh
from cupoch_tpu_torch.collision import collision as tcollision
from cupoch_tpu_torch.geometry import TriangleMesh as TMesh
from torch_port_bridge import textured_mesh

tmesh_mod = importlib.import_module("cupoch_tpu_torch.geometry.trianglemesh")


def _sphere(resolution=20, shift=(0.0, 0.0, 0.0), seed=0):
    """A JAX sphere mesh with vertex normals and random colours."""
    m = JMesh.create_sphere(1.0, resolution)
    m.vertices = np.asarray(m.vertices) + np.float32(shift)
    m.compute_vertex_normals()
    m.vertex_colors = np.random.default_rng(seed).random(
        (np.asarray(m.vertices).shape[0], 3)).astype(np.float32)
    return m


def _pair(jm, jfn, tfn):
    """Apply the same cleanup to a JAX mesh and its port copy."""
    tm = textured_mesh(jm)
    jfn(jm)
    tfn(tm)
    return jm, tm


def _same_mesh(jm, tm):
    np.testing.assert_array_equal(tm.triangles.numpy(),
                                  np.asarray(jm.triangles))
    np.testing.assert_array_equal(tm.vertices.numpy(),
                                  np.asarray(jm.vertices))
    for name in ("vertex_normals", "vertex_colors"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))


def _duplicated():
    """The sphere twice (`+`), a third copy moved by 1e-9 (the same
    after rounding to 7 decimals) and a vertex moved by 1e-5 (not)."""
    a = _sphere()
    b = _sphere(shift=(1e-9, 0.0, 0.0), seed=1)
    m = a + a + b
    v = np.asarray(m.vertices).copy()
    v[5] += np.float32(1e-5)
    m.vertices = v
    m.vertex_normals = np.concatenate([np.asarray(a.vertex_normals)] * 2
                                      + [np.asarray(b.vertex_normals)])
    m.vertex_colors = np.concatenate([np.asarray(a.vertex_colors)] * 2
                                     + [np.asarray(b.vertex_colors)])
    return m


def test_torch_remove_duplicated_vertices_matches_jax():
    jm, tm = _pair(_duplicated(), JMesh.remove_duplicated_vertices,
                   TMesh.remove_duplicated_vertices)
    _same_mesh(jm, tm)
    # the sphere's seam and poles merge too; the moved vertex stays
    assert 700 < tm.vertices.shape[0] < 802


def test_torch_remove_duplicated_triangles_matches_jax():
    m = _duplicated()
    m.remove_duplicated_vertices()
    t = np.asarray(m.triangles).copy()
    t[::7] = t[::7][:, [1, 2, 0]]                # the same vertex sets
    m.triangles = t
    jm, tm = _pair(m, JMesh.remove_duplicated_triangles,
                   TMesh.remove_duplicated_triangles)
    _same_mesh(jm, tm)
    assert 1500 <= tm.triangles.shape[0] < 1700


def test_torch_remove_unreferenced_vertices_matches_jax():
    m = _duplicated()
    m.triangles = np.asarray(m.triangles)[600:1400]
    n_before = np.asarray(m.vertices).shape[0]
    jm, tm = _pair(m, JMesh.remove_unreferenced_vertices,
                   TMesh.remove_unreferenced_vertices)
    _same_mesh(jm, tm)
    assert tm.vertices.shape[0] < n_before
    jm, tm = _pair(_sphere(), JMesh.remove_degenerate_triangles,
                   TMesh.remove_degenerate_triangles)
    _same_mesh(jm, tm)


@pytest.mark.parametrize("n,seed", [(2000, 0), (500, 3)])
def test_torch_sample_points_uniformly_with_jax_draws(monkeypatch, n, seed):
    jm = _sphere(10)
    v, t = jnp.asarray(jm.vertices), jm.triangles
    v0 = v[t[:, 0]]
    areas = 0.5 * jnp.linalg.norm(jnp.cross(v[t[:, 1]] - v0,
                                            v[t[:, 2]] - v0), axis=-1)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    idx = jax.random.choice(k1, t.shape[0], (n,),
                            p=areas / jnp.maximum(jnp.sum(areas), 1e-12))
    r = jax.random.uniform(k2, (n, 2))
    monkeypatch.setattr(tmesh_mod, "uniform_draws", lambda a, m, s: (
        torch.from_numpy(np.array(idx)).long(),
        torch.from_numpy(np.array(r))))
    jp = jm.sample_points_uniformly(n, seed=seed)
    tp = textured_mesh(jm).sample_points_uniformly(n, seed=seed)
    assert len(tp) == n
    for name in ("points", "normals", "colors"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=0.0, atol=1e-6)


def test_torch_uniform_draws_follow_the_areas():
    areas = torch.tensor([1.0, 0.0, 3.0])
    idx, r = tmesh_mod.uniform_draws(areas, 40_000, seed=5)
    counts = torch.bincount(idx, minlength=3).numpy() / 40_000
    assert counts[1] == 0 and abs(counts[2] - 0.75) < 0.01
    assert r.shape == (40_000, 2) and 0.0 <= float(r.min()) < 1e-3 \
        and 1 - 1e-3 < float(r.max()) < 1.0
    again = tmesh_mod.uniform_draws(areas, 40_000, seed=5)
    assert torch.equal(again[0], idx) and torch.equal(again[1], r)
    with pytest.raises(RuntimeError):
        TMesh(device="cpu").sample_points_uniformly(10)


@pytest.mark.parametrize("name,args", [
    ("filter_sharpen", (2, 0.5)), ("filter_smooth_simple", (2,)),
    ("filter_smooth_laplacian", (3, 0.5)),
    ("filter_smooth_taubin", (3, 0.5, -0.53))])
def test_torch_filters_match_jax(name, args):
    jm = _sphere(20)
    v = np.asarray(jm.vertices) * np.random.default_rng(2).uniform(
        0.9, 1.1, (np.asarray(jm.vertices).shape[0], 1)).astype(np.float32)
    jm.vertices = v
    jo = getattr(jm, name)(*args)
    to = getattr(textured_mesh(jm), name)(*args)
    np.testing.assert_allclose(to.vertices.numpy(), np.asarray(jo.vertices),
                               rtol=0.0, atol=1e-5)
    np.testing.assert_array_equal(to.vertex_colors.numpy(),
                                  np.asarray(jo.vertex_colors))
    np.testing.assert_array_equal(to.triangles.numpy(),
                                  np.asarray(jo.triangles))


def test_torch_adjacency_sums_match_jax():
    jm = _sphere(10)
    js, jc = jm._adjacency_sums()
    ts, tc = textured_mesh(jm)._adjacency_sums()
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)


def test_torch_mesh_boxes_match_jax():
    jm = _sphere(20, shift=(0.3, -1.0, 2.0))
    R = np.asarray([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]],
                   np.float32)
    jm.vertices = np.asarray(jm.vertices) * np.float32([2.0, 1.0, 0.5]) @ R.T
    tm = textured_mesh(jm)
    ja, ta = jm.get_axis_aligned_bounding_box(), \
        tm.get_axis_aligned_bounding_box()
    for name in ("min_bound", "max_bound"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(getattr(ja, name)), atol=1e-5)
    jo, to = jm.get_oriented_bounding_box(), tm.get_oriented_bounding_box()
    np.testing.assert_allclose(to.center.numpy(), np.asarray(jo.center),
                               atol=1e-5)
    np.testing.assert_allclose(np.sort(to.extent.numpy()),
                               np.sort(np.asarray(jo.extent)), atol=1e-4)
    np.testing.assert_allclose(to.get_box_points().numpy()
                               .mean(0), np.asarray(jo.get_box_points())
                               .mean(0), atol=1e-5)


def _pairs(x):
    return {tuple(map(int, p)) for p in np.asarray(x).reshape(-1, 2)}


def _soup(n, size, seed):
    """A JAX mesh of n triangles with their own vertices, each within
    `size` of a uniform centre in [0, 1]^3: generic positions, so no
    pair is near the coplanar case (which the reference decides by a box
    test, and so by rounding) or a touch."""
    rng = np.random.default_rng(seed)
    c = rng.random((n, 1, 3))
    v = (c + rng.uniform(-size, size, (n, 3, 3))).reshape(-1, 3)
    return JMesh(v.astype(np.float32),
                 np.arange(3 * n, dtype=np.int32).reshape(-1, 3))


@pytest.mark.parametrize("n,route", [(1000, "dense"), (6000, "bucket")])
def test_torch_self_intersections_match_jax(n, route, monkeypatch):
    """A triangle soup: 1000 triangles take the dense route, 6000 the
    bucket route; the intersecting pairs are those of the JAX package's
    dense route, the reference's all pairs (its bucket route loses the
    pairs of the boxes it drops)."""
    jm = _soup(n, 0.06 if route == "dense" else 0.03, seed=n)
    tm = textured_mesh(jm)
    got = tm.get_self_intersecting_triangles()
    assert tm.last_intersection_route == route
    assert got.dtype == torch.int32
    monkeypatch.setattr(jcollision, "_DENSE_LIMIT", 10 ** 9)
    want = jm.get_self_intersecting_triangles()
    assert _pairs(got) == _pairs(want) and len(want) > 10
    assert (got[:, 0] < got[:, 1]).all()
    assert tm.is_self_intersecting()


def test_torch_adjacent_triangles_do_not_count():
    """Triangles that share a vertex never count, and apart ones neither:
    a closed box mesh and a lattice of separate triangles have none."""
    jm = JMesh.create_box(1.0, 2.0, 0.5)
    tm = textured_mesh(jm)
    assert len(tm.get_self_intersecting_triangles()) == 0 \
        == len(jm.get_self_intersecting_triangles())
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"),
                 -1).reshape(-1, 1, 3)
    v = (g + np.asarray([[0, 0, 0], [0.5, 0, 0], [0, 0.5, 0.2]]))
    lattice = TMesh(v.reshape(-1, 3), np.arange(192).reshape(-1, 3),
                    device="cpu")
    assert not lattice.is_self_intersecting()
    assert lattice.last_intersection_route == "dense"


def test_torch_bucket_coarsens_to_fit_and_keeps_pairs():
    """Boxes of 1 cm in eight clusters at the corners of a 10 m cube: the
    bucket grid at the boxes' size would hold 10^9 cells, so the cell
    grows until the grid fits, and the pairs are the dense test's."""
    rng = np.random.default_rng(4)
    corners = np.stack(np.meshgrid(*[[0.0, 10.0]] * 3, indexing="ij"),
                       -1).reshape(-1, 3)
    c = (corners[:, None, :] + rng.uniform(0, 0.05, (8, 40, 3))) \
        .reshape(-1, 3).astype(np.float32)
    lo = torch.from_numpy(c)
    hi = lo + torch.from_numpy(rng.uniform(0.002, 0.01, c.shape)
                               .astype(np.float32))
    got, dropped = tcollision.bucket_overlap_pairs(lo, hi, lo, hi, 0.0)
    want = tcollision.aabb_overlap_pairs(lo, hi, lo, hi, 0.0)
    assert dropped == 0 and _pairs(got.numpy()) == _pairs(want.numpy())


def test_torch_self_intersections_retest_dropped_boxes(monkeypatch):
    """A soup of 6000 triangles with 300 more crowded into one cell: the
    bucket phase drops the crowd's boxes past its slot cap, and those
    rows go through the dense test, so the pairs are the dense route's
    (the crowd's triangles meet far more than 32 others)."""
    jm = _soup(6000, 0.03, seed=7)
    rng = np.random.default_rng(8)
    crowd = (np.float32(0.5) + rng.uniform(-0.01, 0.01, (900, 3))
             ).astype(np.float32)
    v = np.concatenate([np.asarray(jm.vertices), crowd])
    tm = TMesh(v, np.arange(len(v), dtype=np.int32).reshape(-1, 3),
               device="cpu")
    got = tm.get_self_intersecting_triangles()
    assert tm.last_intersection_route == "bucket"
    assert tm.last_intersection_dropped > 100
    monkeypatch.setattr(tcollision, "_DENSE_LIMIT", 10 ** 9)
    want = tm.get_self_intersecting_triangles()
    assert tm.last_intersection_route == "dense"
    assert np.bincount(want[:, 0].numpy()).max() > 32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    monkeypatch.setattr(jcollision, "_DENSE_LIMIT", 10 ** 9)
    jm.vertices, jm.triangles = v, np.asarray(tm.triangles)
    assert _pairs(got) == _pairs(jm.get_self_intersecting_triangles())


@pytest.mark.parametrize("channels,dtype", [(3, np.uint8), (1, np.float32)])
def test_torch_texture_vertex_colors_match_jax(channels, dtype):
    jm = _sphere(10)
    m = np.asarray(jm.triangles).shape[0]
    rng = np.random.default_rng(6)
    jm.triangle_uvs = rng.random((3 * m, 2)).astype(np.float32)
    tex = rng.random((12, 16, channels))
    tex = (tex * 255).astype(np.uint8) if dtype == np.uint8 \
        else tex.astype(np.float32)
    jm.texture = JImage(tex)
    tm = textured_mesh(jm)
    assert tm.has_triangle_uvs() and tm.has_texture()
    np.testing.assert_array_equal(tm.sample_texture_vertex_colors().numpy(),
                                  jm.sample_texture_vertex_colors())
    tm.triangle_uvs = None
    assert tm.sample_texture_vertex_colors() is None
