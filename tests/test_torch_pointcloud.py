"""The port's point-cloud operations (cupoch_tpu_torch.geometry:
`PointCloud` methods, `pointcloud_ops`, bounding boxes) against the
JAX package on the same numpy inputs, on the CPU (brute-force and
hash-grid branches, at most 2k points).

Tolerances, each stated where it is used:
- voxel down-sampling: equal counts and voxel order; means within
  1e-6 relative (the port scatters with `index_add_`, whose summation
  order differs from the reference's segment sums);
- index results (farthest-point picks, outlier masks, DBSCAN labels,
  selections): equal;
- coordinates computed with a few f32 operations (transforms,
  filters, orientations, boxes): within 1e-6 to 1e-5 absolute on unit
  sized values;
- RANSAC plane scoring on the JAX package's own triples (recomputed
  from its `PRNGKey`): the plane within 1e-5, the inlier mask equal
  except where a point lies within 1e-6 of the threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cupoch_tpu.geometry import (AxisAlignedBoundingBox as JAABB,
                                 OrientedBoundingBox as JOBB,
                                 PointCloud as JPointCloud)
from cupoch_tpu.geometry import pointcloud_ops as jops
from cupoch_tpu.geometry.pointcloud import _pad_cloud as j_pad_cloud
from cupoch_tpu_torch.geometry import (AxisAlignedBoundingBox as TAABB,
                                       OrientedBoundingBox as TOBB,
                                       PointCloud as TPointCloud)
from cupoch_tpu_torch.geometry import pointcloud_ops as tops
from torch_port_bridge import cloud as to_port

CPU = "cpu"


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) \
        else x.cpu().numpy()


def _clouds(pts, normals=None, colors=None):
    j = JPointCloud(pts)
    j.normals, j.colors = normals, colors
    return j, to_port(j)


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _blobs(rng, n_each=150, centers=((0, 0, 0), (2, 0, 0), (0, 2, 1))):
    pts = [rng.normal(size=(n_each, 3)) * 0.08 + c for c in centers]
    pts.append(np.array([[10.0, -10.0, 10.0], [-8.0, 9.0, 3.0]]))
    return np.concatenate(pts).astype(np.float32)


# ---------------------------------------------------------------------------
# transforms, +, selection
# ---------------------------------------------------------------------------

def test_torch_pointcloud_transform_ops_match_jax(rng):
    """transform (points, normals, covariances), translate, scale and
    rotate, each with and without centring, within 2e-6 of the
    reference's coordinates."""
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    n = _unit(rng.normal(size=(300, 3)))
    cov = rng.normal(size=(300, 3, 3)).astype(np.float32)
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec([0.3, -0.7, 0.2]).as_matrix().astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, [0.5, -1.0, 2.0]
    j, t = _clouds(pts, n)
    j.covariances, t.covariances = cov, cov
    steps = [("transform", (T,)), ("translate", ([1.0, 2.0, 3.0],)),
             ("translate", ([1.0, 2.0, 3.0], False)), ("scale", (1.7,)),
             ("scale", (0.3, False)), ("rotate", (R,)),
             ("rotate", (R, False))]
    for name, args in steps:
        getattr(j, name)(*args)
        getattr(t, name)(*args)
        scale = max(1.0, np.abs(_np(j.points)).max())
        np.testing.assert_allclose(_np(t.points), _np(j.points),
                                   atol=2e-6 * scale, err_msg=name)
        np.testing.assert_allclose(_np(t.normals), _np(j.normals),
                                   atol=2e-6, err_msg=name)
        np.testing.assert_allclose(_np(t.covariances), _np(j.covariances),
                                   atol=2e-6 * np.abs(cov).max() * 4,
                                   err_msg=name)


def test_torch_pointcloud_add_select_crop_match_jax(rng):
    """`+` and `+=` (which drop covariances, as the reference does),
    select_by_index / select_by_mask with and without invert,
    uniform down-sampling and crop by both boxes: equal."""
    a = rng.uniform(size=(100, 3)).astype(np.float32)
    b = rng.uniform(size=(60, 3)).astype(np.float32)
    ja, ta = _clouds(a, _unit(a - 0.5), a)
    jb, tb = _clouds(b, _unit(b - 0.5), b)
    ja.covariances = ta.covariances = np.ones((100, 3, 3), np.float32)
    jc, tc = ja + jb, ta + tb
    for f in ("points", "normals", "colors"):
        np.testing.assert_array_equal(_np(getattr(tc, f)),
                                      _np(getattr(jc, f)))
    ja += jb
    ta += tb
    assert not ta.has_covariances() and not ja.has_covariances()
    np.testing.assert_array_equal(_np(ta.points), _np(ja.points))
    idx = [0, 5, 17, 99, 150]
    m = rng.uniform(size=160) > 0.5
    for inv in (False, True):
        for jo, to in ((ja.select_by_index(idx, inv),
                        ta.select_by_index(idx, inv)),
                       (ja.select_by_mask(m, inv), ta.select_by_mask(m, inv))):
            np.testing.assert_array_equal(_np(to.points), _np(jo.points))
            np.testing.assert_array_equal(_np(to.colors), _np(jo.colors))
    np.testing.assert_array_equal(_np(ta.uniform_down_sample(7).points),
                                  _np(ja.uniform_down_sample(7).points))
    box_j, box_t = JAABB([0.2, 0.1, 0.3], [0.8, 0.7, 0.9]), \
        TAABB([0.2, 0.1, 0.3], [0.8, 0.7, 0.9], device=CPU)
    np.testing.assert_array_equal(_np(ta.crop(box_t).points),
                                  _np(ja.crop(box_j).points))
    obb_j = JOBB([0.5, 0.5, 0.5], np.eye(3), [0.5, 0.3, 0.4])
    obb_t = TOBB([0.5, 0.5, 0.5], np.eye(3), [0.5, 0.3, 0.4], device=CPU)
    np.testing.assert_array_equal(_np(ta.crop(obb_t).points),
                                  _np(ja.crop(obb_j).points))


def test_torch_pointcloud_bounds_and_boxes_match_jax(rng):
    """Cloud bounds; AABB and OBB from points (OBB axes up to sign
    within 1e-5, centre and extent within 1e-5 of the box's largest
    extent: the axes are eigenvectors of a 3x3 covariance, whose f32
    rounding differs between the packages); box transforms within
    1e-5 of the box size; containment masks equal."""
    from scipy.spatial.transform import Rotation
    pts = rng.uniform(size=(500, 3)).astype(np.float32) - 0.5
    pts[:, 0] *= 6.0
    pts[:, 1] *= 2.5     # distinct extents: well-separated axes
    R = Rotation.from_euler("zy", [0.7, 0.2]).as_matrix().astype(np.float32)
    pts = pts @ R.T + np.float32([1.0, -2.0, 0.5])
    j, t = _clouds(pts)
    for f in ("get_min_bound", "get_max_bound", "get_center"):
        np.testing.assert_allclose(getattr(t, f)(), getattr(j, f)(),
                                   atol=2e-6)
    aj, at = j.get_axis_aligned_bounding_box(), \
        t.get_axis_aligned_bounding_box()
    np.testing.assert_array_equal(at.get_min_bound(), aj.get_min_bound())
    np.testing.assert_array_equal(at.get_max_bound(), aj.get_max_bound())
    assert at.volume() == pytest.approx(aj.volume(), rel=1e-6)
    np.testing.assert_array_equal(_np(at.get_box_points()),
                                  _np(aj.get_box_points()))
    oj, ot = j.get_oriented_bounding_box(), t.get_oriented_bounding_box()
    size = float(np.abs(_np(oj.extent)).max())
    np.testing.assert_allclose(_np(ot.center), _np(oj.center),
                               atol=1e-5 * size)
    np.testing.assert_allclose(_np(ot.extent), _np(oj.extent),
                               atol=1e-5 * size)
    Rj, Rt = _np(oj.R), _np(ot.R)
    sign = np.sign((Rj * Rt).sum(0))
    np.testing.assert_allclose(Rt * sign, Rj, atol=1e-5)
    assert np.linalg.det(Rt) > 0
    probe = (rng.uniform(size=(800, 3)).astype(np.float32) - 0.5) * 4
    probe = probe @ R.T
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, [0.2, 0.1, -0.3]
    for bj, bt in ((aj, at), (JOBB(oj.center, oj.R, oj.extent),
                              TOBB(_np(oj.center), _np(oj.R),
                                   _np(oj.extent), device=CPU))):
        for name, args in (("translate", ([0.1, 0.2, 0.3],)),
                           ("scale", (1.1,)), ("transform", (T,))):
            getattr(bj, name)(*args)
            getattr(bt, name)(*args)
            np.testing.assert_allclose(_np(bt.get_box_points()),
                                       _np(bj.get_box_points()),
                                       atol=1e-5 * size)
        mj = _np(bj.contains_mask(jnp.asarray(probe)))
        mt = _np(bt.contains_mask(torch.as_tensor(probe)))
        np.testing.assert_array_equal(mt, mj)


# ---------------------------------------------------------------------------
# down-sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("voxel", [0.5, 0.1, 0.037])
def test_torch_voxel_down_sample_matches_jax(rng, voxel):
    """Counts and voxel-key order equal; means (points, colours, and
    renormalised normals) within 1e-6 relative."""
    pts = rng.uniform(size=(2000, 3)).astype(np.float32) * [1.0, 2.0, 0.5]
    pts = np.concatenate([pts, pts[:50] + 1e-4]).astype(np.float32)
    j, t = _clouds(pts, _unit(rng.normal(size=pts.shape)),
                   rng.uniform(size=pts.shape).astype(np.float32))
    dj, dt = j.voxel_down_sample(voxel), t.voxel_down_sample(voxel)
    assert len(dt) == len(dj)
    for f in ("points", "normals", "colors"):
        np.testing.assert_allclose(_np(getattr(dt, f)), _np(getattr(dj, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_torch_voxel_down_sample_grid_case():
    """tests/test_pointcloud.py's grid: three points share the origin
    voxel, eight voxels in all."""
    pts = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                    [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1],
                    [0.01, 0.01, 0.01], [0.02, 0, 0]], np.float32)
    j, t = _clouds(pts)
    dj, dt = j.voxel_down_sample(0.5), t.voxel_down_sample(0.5)
    assert len(dt) == len(dj) == 8
    np.testing.assert_allclose(_np(dt.points), _np(dj.points), atol=1e-7)
    assert len(t.voxel_down_sample(0.0)) == 0
    assert len(TPointCloud(device=CPU).voxel_down_sample(0.1)) == 0


@pytest.mark.parametrize("n,k", [(128, 16), (700, 64)])
def test_torch_farthest_point_indices_match_jax(rng, n, k):
    """The picked indices are equal, in order."""
    pts = rng.uniform(size=(n, 3)).astype(np.float32)
    pj, mj = j_pad_cloud(jnp.asarray(pts))
    want = np.asarray(jops.farthest_point_indices(pj, mj, k))
    got = tops.farthest_point_indices(torch.as_tensor(pts), k).numpy()
    np.testing.assert_array_equal(got, want)
    j, t = _clouds(pts)
    np.testing.assert_array_equal(
        _np(t.farthest_point_down_sample(k).points),
        _np(j.farthest_point_down_sample(k).points))


# ---------------------------------------------------------------------------
# outliers, filters, orientations
# ---------------------------------------------------------------------------

def test_torch_outlier_removal_matches_jax(rng):
    """Radius (hash grid) and statistical (brute-force k-NN) outlier
    removal keep the same indices."""
    pts = np.concatenate([
        rng.normal(size=(600, 3)) * 0.1,
        rng.uniform(-1, 1, size=(60, 3)),
        [[5.0, 5, 5], [-4.0, 3.0, 0.0]]]).astype(np.float32)
    j, t = _clouds(pts)
    for args in ((5, 0.05), (12, 0.1), (1, 0.3)):
        (cj, ij), (ct, it) = j.remove_radius_outliers(*args), \
            t.remove_radius_outliers(*args)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(_np(ct.points), _np(cj.points))
    for args in ((10, 2.0), (20, 1.0), (5, 0.5)):
        (cj, ij), (ct, it) = j.remove_statistical_outliers(*args), \
            t.remove_statistical_outliers(*args)
        np.testing.assert_array_equal(it, ij)
    with pytest.raises(RuntimeError):
        t.remove_statistical_outliers(0, 1.0)


def test_torch_filters_match_jax(rng):
    """Gaussian filter within 1e-6 of the reference's coordinates;
    pass-through filter equal."""
    pts = np.concatenate(
        [rng.uniform(size=(400, 2)),
         rng.normal(size=(400, 1)) * 0.01], 1).astype(np.float32)
    j, t = _clouds(pts)
    for r, s2, k in ((0.1, 0.01, 32), (0.2, 0.004, 16)):
        np.testing.assert_allclose(_np(t.gaussian_filter(r, s2, k).points),
                                   _np(j.gaussian_filter(r, s2, k).points),
                                   atol=1e-6)
    for axis, lo, hi in ((0, 0.25, 0.75), (2, -0.005, 0.01)):
        np.testing.assert_array_equal(
            _np(t.pass_through_filter(axis, lo, hi).points),
            _np(j.pass_through_filter(axis, lo, hi).points))


def test_torch_normal_orientations_match_jax(rng):
    """Both orientations, with zero normals among the inputs, within
    1e-6; without normals both raise.

    A zero normal facing a camera becomes the unit vector to the
    camera in the port. The reference divides by
    `jnp.linalg.norm(to_cam, -1, keepdims=True)`, whose -1 is the
    matrix norm's `ord` (the least column sum over all points), not
    an axis, so its vector is not unit length: a reference fault the
    port does not copy."""
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    n = _unit(rng.normal(size=(300, 3)))
    n[:3] = 0.0
    camera = np.float32([1.0, 2.0, -3.0])
    for method, arg in (("orient_normals_to_align_with_direction",
                         [0.3, -0.2, 0.9]),
                        ("orient_normals_towards_camera_location", camera)):
        j, t = _clouds(pts, n)
        getattr(j, method)(arg)
        getattr(t, method)(arg)
        nz = slice(0, None) if "direction" in method else slice(3, None)
        np.testing.assert_allclose(_np(t.normals)[nz], _np(j.normals)[nz],
                                   atol=1e-6)
        with pytest.raises(RuntimeError):
            getattr(TPointCloud(pts, device=CPU), method)(arg)
    to_cam = camera - pts[:3]
    np.testing.assert_allclose(_np(t.normals)[:3], _unit(to_cam), atol=1e-6)
    assert not np.allclose(np.linalg.norm(_np(j.normals)[:3], axis=-1), 1.0)


# ---------------------------------------------------------------------------
# RANSAC plane, DBSCAN
# ---------------------------------------------------------------------------

def _jax_triples(pts, num_iterations, seed):
    """The reference's hypothesis draws, as `segment_plane` makes them
    over the padded cloud."""
    pj, mj = j_pad_cloud(jnp.asarray(pts))
    valid = jnp.where(mj, 0.0, -jnp.inf)
    g = jax.random.gumbel(jax.random.PRNGKey(seed),
                          (num_iterations, pj.shape[0])) + valid[None]
    return np.asarray(jax.lax.top_k(g, 3)[1])


@pytest.mark.parametrize("seed,iters,thr", [(0, 64, 0.01), (3, 100, 0.02),
                                            (7, 16, 0.005)])
def test_torch_plane_scoring_on_jax_triples(rng, seed, iters, thr):
    """The port scores the reference's triples: the plane within 1e-5
    and the inlier mask equal except where a point lies within 1e-6
    of the threshold (the f32 dot products round differently)."""
    plane_pts = np.concatenate(
        [rng.uniform(size=(400, 2)), rng.normal(size=(400, 1)) * 0.003],
        1).astype(np.float32)
    noise = rng.uniform(size=(80, 3)).astype(np.float32) + [0, 0, 0.2]
    pts = np.concatenate([plane_pts, noise])
    j = JPointCloud(pts)
    plane_j, inl_j = j.segment_plane(thr, num_iterations=iters, seed=seed)
    tri = _jax_triples(pts, iters, seed)
    plane_t, inl_t = tops.score_planes(torch.as_tensor(pts),
                                       torch.as_tensor(np.array(tri)), thr)
    np.testing.assert_allclose(plane_t.numpy(), plane_j, atol=1e-5)
    mask_j = np.zeros(len(pts), bool)
    mask_j[inl_j] = True
    dist = np.abs(pts.astype(np.float64) @ plane_j[:3].astype(np.float64)
                  + plane_j[3])
    away = np.abs(dist - thr) > 1e-6
    np.testing.assert_array_equal(inl_t.numpy()[away], mask_j[away])


def test_torch_segment_plane_own_draws():
    """tests/test_pointcloud.py's case through the port's own draws:
    >= 390 of 400 plane points, normal along z; the draws are distinct
    triples and reproducible from the seed."""
    rng = np.random.default_rng(42)
    plane_pts = np.concatenate(
        [rng.uniform(size=(400, 2)).astype(np.float32),
         np.zeros((400, 1), np.float32)], 1)
    noise = rng.uniform(size=(50, 3)).astype(np.float32) + [0, 0, 0.5]
    pcd = TPointCloud(np.concatenate([plane_pts, noise]), device=CPU)
    plane, inliers = pcd.segment_plane(0.01, num_iterations=64)
    assert len(inliers) >= 390 and abs(plane[2]) > 0.99
    tri = tops.plane_triples(450, 5000, seed=4).numpy()
    assert (tri >= 0).all() and (tri < 450).all()
    assert (tri[:, 0] != tri[:, 1]).all() and (tri[:, 1] != tri[:, 2]).all() \
        and (tri[:, 0] != tri[:, 2]).all()
    np.testing.assert_array_equal(tops.plane_triples(450, 5000, 4).numpy(),
                                  tri)
    with pytest.raises(ValueError):
        tops.plane_triples(2, 10)


def test_torch_module_segment_plane_with_a_mask_matches_jax(rng):
    """`pointcloud_ops.segment_plane(points, mask, ...)`, the JAX
    function's form, draws its triples among the rows the mask keeps:
    on a plane with noise, where the masked-out rows form a denser
    second plane, both packages find the kept plane (their draws
    differ: normals within 0.02 of each other, 2 mm of noise over a
    unit square) and no masked-out row is an inlier."""
    plane_pts = np.concatenate(
        [rng.uniform(size=(300, 2)), rng.normal(size=(300, 1)) * 0.002],
        1).astype(np.float32)
    decoy = np.concatenate(
        [rng.uniform(size=(500, 1)) * 0.2 + 0.5, rng.uniform(size=(500, 2))],
        1).astype(np.float32)
    noise = rng.uniform(size=(60, 3)).astype(np.float32) + [0, 0, 0.3]
    pts = np.concatenate([plane_pts, decoy, noise])
    mask = np.ones(len(pts), bool)
    mask[300:800] = False
    plane_j, inl_j = jops.segment_plane(jnp.asarray(pts), jnp.asarray(mask),
                                        0.01, 64, jax.random.PRNGKey(0))
    plane_t, inl_t = tops.segment_plane(torch.as_tensor(pts),
                                        torch.as_tensor(mask), 0.01, 64,
                                        seed=0)
    for plane, inl in ((np.asarray(plane_j), np.asarray(inl_j)),
                       (plane_t.numpy(), inl_t.numpy())):
        assert abs(plane[2]) > 0.999 and abs(plane[3]) < 0.01
        assert not inl[~mask].any() and inl[:300].sum() >= 295
    np.testing.assert_allclose(np.abs(plane_t.numpy()[:3]),
                               np.abs(np.asarray(plane_j)[:3]), atol=0.02)


@pytest.mark.parametrize("eps,min_points", [(0.3, 5), (0.15, 10), (0.05, 3)])
def test_torch_cluster_dbscan_matches_jax(rng, eps, min_points):
    """Densified labels equal, noise -1 included."""
    pts = _blobs(rng)
    j, t = _clouds(pts)
    np.testing.assert_array_equal(t.cluster_dbscan(eps, min_points),
                                  j.cluster_dbscan(eps, min_points))


def test_torch_densify_labels_matches_jax(rng):
    lab = rng.integers(-1, 40, size=500) * 7
    lab[lab < 0] = -1
    np.testing.assert_array_equal(tops.densify_labels(lab),
                                  jops.densify_labels(lab))


def test_torch_box_and_cloud_helpers_match_jax(rng):
    """The boxes' remaining methods (extents, volume, emptiness, index
    queries, translate / scale without centring, OBB rotate and its
    AABB, clear) within 1e-6 of the reference's; the cloud's
    normalize_normals, paint_uniform_color, clear and is_empty; the
    model resolution of ISS (within 1e-6 relative)."""
    from cupoch_tpu.geometry.keypoint import compute_model_resolution as jres
    from cupoch_tpu_torch.geometry.keypoint import \
        compute_model_resolution as tres
    from scipy.spatial.transform import Rotation
    pts = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    R = Rotation.from_rotvec([0.2, 0.4, -0.3]).as_matrix().astype(np.float32)
    aj, at = JAABB([-0.5, -0.2, 0.0], [0.5, 0.4, 0.9]), \
        TAABB([-0.5, -0.2, 0.0], [0.5, 0.4, 0.9], device=CPU)
    oj = JOBB([0.1, 0.2, 0.3], R, [0.8, 0.5, 0.3])
    ot = TOBB([0.1, 0.2, 0.3], R, [0.8, 0.5, 0.3], device=CPU)
    for f in ("get_extent", "get_half_extent", "get_center"):
        np.testing.assert_allclose(getattr(at, f)(), getattr(aj, f)(),
                                   atol=1e-6)
    assert at.get_max_extent() == pytest.approx(aj.get_max_extent())
    for bj, bt in ((aj, at), (oj, ot)):
        assert bt.volume() == pytest.approx(bj.volume(), rel=1e-6)
        assert bt.is_empty() == bj.is_empty()
        np.testing.assert_array_equal(
            bt.get_point_indices_within_bounding_box(pts),
            bj.get_point_indices_within_bounding_box(pts))
        for name, args in (("translate", ([0.3, -0.1, 0.2], False)),
                           ("scale", (1.3, False))):
            getattr(bj, name)(*args)
            getattr(bt, name)(*args)
            np.testing.assert_allclose(_np(bt.get_box_points()),
                                       _np(bj.get_box_points()), atol=1e-6)
    for center in (True, False):
        oj.rotate(R, center)
        ot.rotate(R, center)
        np.testing.assert_allclose(_np(ot.get_box_points()),
                                   _np(oj.get_box_points()), atol=1e-6)
    bj, bt = oj.get_axis_aligned_bounding_box(), \
        ot.get_axis_aligned_bounding_box()
    np.testing.assert_allclose(bt.get_min_bound(), bj.get_min_bound(),
                               atol=1e-6)
    assert at.clear().is_empty() and ot.clear().is_empty()
    n = rng.normal(size=(300, 3)).astype(np.float32) * 3
    j, t = _clouds(pts, n)
    j.normalize_normals()
    t.normalize_normals()
    np.testing.assert_allclose(_np(t.normals), _np(j.normals), atol=1e-6)
    j.paint_uniform_color([0.2, 0.5, 0.7])
    t.paint_uniform_color([0.2, 0.5, 0.7])
    np.testing.assert_array_equal(_np(t.colors), _np(j.colors))
    assert tres(torch.as_tensor(pts)) == pytest.approx(
        jres(jnp.asarray(pts)), rel=1e-6)
    assert t.clear().is_empty() and j.clear().is_empty()
    assert len(t) == 0 and not t.has_normals()
