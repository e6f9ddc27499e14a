"""The port's intersection tests, voxel grid, occupancy grid, laser scan
buffer and distance transform (cupoch_tpu_torch.geometry) against the
JAX package on the same seeded numpy inputs, on the CPU, at R = 16-64.

Tolerances:
- bit-equal: `prob_log` after inserts, EDT distances and nearest-site
  indices, voxel keys, occupancy extractions, segment/box tests (no
  products there to fuse);
- DDA free masks: equal up to DDA_SHARE of the cells (XLA on the CPU may
  fuse a ray's length into FMAs, which can move a tie of the walk's
  crossings: ROADMAP Queue 3); none differed on these inputs;
- the tests made of sums of products (triangle/box, triangle/triangle,
  carving, the shadow filter): equal up to FMA_SHARE of the cases;
- squared distances rtol 1e-5; laser points 1e-5 (the port's beam
  sines and cosines are rounded from float64, XLA's are float32
  polynomials); scans binned from clouds: see `_binned_buffer_close`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_bridge as bridge
from cupoch_tpu.camera import PinholeCameraIntrinsic as JIntrinsic
from cupoch_tpu.camera import PinholeCameraParameters as JParams
from cupoch_tpu.geometry import DistanceTransform as JDT
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import LaserScanBuffer as JScan
from cupoch_tpu.geometry import OccupancyGrid as JOcc
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.geometry import TriangleMesh as JMesh
from cupoch_tpu.geometry import Voxel as JVoxel
from cupoch_tpu.geometry import VoxelGrid as JVG
from cupoch_tpu.geometry import intersection_test as jit_
from cupoch_tpu.geometry.occupancygrid import _dda_free_mask
from cupoch_tpu_torch.camera import PinholeCameraParameters as TParams
from cupoch_tpu_torch.geometry import DistanceTransform as TDT
from cupoch_tpu_torch.geometry import Image as TImage
from cupoch_tpu_torch.geometry import LaserScanBuffer as TScan
from cupoch_tpu_torch.geometry import OccupancyGrid as TOcc
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.geometry import Voxel as TVoxel
from cupoch_tpu_torch.geometry import VoxelGrid as TVG
from cupoch_tpu_torch.geometry import intersection_test as tit
from cupoch_tpu_torch.geometry import occupancygrid as tocc

DDA_SHARE = 1e-3
FMA_SHARE = 5e-3
CPU = "cpu"


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _share_differs(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float((a != b).mean()) if a.size else 0.0


def _same_nan(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and bool(
        ((a == b) | (np.isnan(a) & np.isnan(b))).all())


# ---------------------------------------------------------------------------
# intersection tests
# ---------------------------------------------------------------------------

def _tris(rng, n, scale=1.0):
    return [rng.uniform(-1, 1, (n, 3)).astype(np.float32) * scale
            for _ in range(3)]


def test_torch_triangle_aabb_matches_jax():
    rng = np.random.default_rng(0)
    v0, v1, v2 = _tris(rng, 4000, 0.6)
    c = rng.uniform(-0.5, 0.5, (4000, 3)).astype(np.float32)
    h = rng.uniform(0.02, 0.3, (4000, 3)).astype(np.float32)
    want = np.asarray(jit_.triangle_aabb(c, h, v0, v1, v2))
    got = tit.triangle_aabb(_t(c), _t(h), _t(v0), _t(v1), _t(v2)).numpy()
    assert 0.2 < want.mean() < 0.8
    assert _share_differs(want, got) <= FMA_SHARE


def test_torch_line_segment_aabb_matches_jax():
    rng = np.random.default_rng(1)
    p0 = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    p1 = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    p1[:500, 1] = p0[:500, 1]          # segments parallel to a slab
    lo = rng.uniform(-0.6, 0.4, (5000, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.3, 1.0, (5000, 3)).astype(np.float32)
    want = np.asarray(jit_.line_segment_aabb(p0, p1, lo, hi))
    got = tit.line_segment_aabb(_t(p0), _t(p1), _t(lo), _t(hi)).numpy()
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(got, want)


def test_torch_tri_tri_matches_jax():
    rng = np.random.default_rng(2)
    a = _tris(rng, 3000, 0.8)
    b = _tris(rng, 3000, 0.8)
    b[0][:200] = a[0][:200]            # shared vertices
    want = np.asarray(jit_.tri_tri(*a, *b))
    got = tit.tri_tri(*map(_t, a), *map(_t, b)).numpy()
    assert 0.1 < want.mean() < 0.9
    assert _share_differs(want, got) <= FMA_SHARE


@pytest.mark.parametrize("which", ["segment", "triangle"])
def test_torch_point_distances_match_jax(which):
    rng = np.random.default_rng(3)
    p = rng.uniform(-1.5, 1.5, (3000, 3)).astype(np.float32)
    a, b, c = _tris(rng, 3000)
    if which == "segment":
        want = np.asarray(jit_.point_segment_dist2(p, a, b))
        got = tit.point_segment_dist2(_t(p), _t(a), _t(b)).numpy()
    else:
        want = np.asarray(jit_.point_triangle_dist2(p, a, b, c))
        got = tit.point_triangle_dist2(_t(p), _t(a), _t(b), _t(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# voxel grid
# ---------------------------------------------------------------------------

def _cloud_pair(seed=4, n=2000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    j = JPointCloud(pts)
    j.colors = jnp.asarray(cols)
    t = TPointCloud(pts, device=CPU)
    t.colors = cols
    return j, t


def _same_grid(jvg, tvg, colors=True):
    np.testing.assert_array_equal(_np(tvg.voxels_keys),
                                  np.asarray(jvg.voxels_keys))
    if colors:
        np.testing.assert_allclose(_np(tvg.voxels_colors),
                                   np.asarray(jvg.voxels_colors), atol=1e-6)
    np.testing.assert_array_equal(tvg.origin, np.asarray(jvg.origin))
    assert tvg.voxel_size == jvg.voxel_size


def test_torch_voxelgrid_from_point_cloud_matches_jax():
    j, t = _cloud_pair()
    jvg = JVG.create_from_point_cloud(j, 0.13)
    tvg = TVG.create_from_point_cloud(t, 0.13)
    assert 500 < len(jvg) < 2000
    _same_grid(jvg, tvg)
    for name in ("get_min_bound", "get_max_bound", "get_center"):
        np.testing.assert_allclose(getattr(tvg, name)(),
                                   getattr(jvg, name)(), atol=1e-6)


def test_torch_voxelgrid_create_dense_matches_jax():
    jvg = JVG.create_dense((0.1, -0.2, 0.3), 0.1, 0.5, 0.3, 0.4)
    tvg = TVG.create_dense((0.1, -0.2, 0.3), 0.1, 0.5, 0.3, 0.4, device=CPU)
    _same_grid(jvg, tvg)
    np.testing.assert_allclose(_np(tvg.get_voxel_centers()),
                               np.asarray(jvg.get_voxel_centers()))


def test_torch_voxelgrid_from_triangle_mesh_matches_jax():
    jm = JMesh.create_sphere(0.5, resolution=8)
    tm = bridge.mesh(jm)
    jvg = JVG.create_from_triangle_mesh(jm, 0.07)
    tvg = TVG.create_from_triangle_mesh(tm, 0.07)
    assert len(jvg) > 100
    a = set(map(tuple, np.asarray(jvg.voxels_keys).tolist()))
    b = set(map(tuple, _np(tvg.voxels_keys).tolist()))
    assert len(a ^ b) <= FMA_SHARE * len(a)


def test_torch_voxelgrid_check_if_included_matches_jax():
    j, t = _cloud_pair(5)
    jvg = JVG.create_from_point_cloud(j, 0.2)
    tvg = bridge.voxel_grid(jvg)
    rng = np.random.default_rng(6)
    q = rng.uniform(-1.6, 1.6, (3000, 3)).astype(np.float32)
    want = jvg.check_if_included(q)
    np.testing.assert_array_equal(tvg.check_if_included(q), want)
    assert 0.1 < want.mean() < 0.9


def test_torch_voxelgrid_editing_matches_jax():
    j, _ = _cloud_pair(7, 300)
    jvg = JVG.create_from_point_cloud(j, 0.3)
    tvg = bridge.voxel_grid(jvg)
    for vg, V in ((jvg, JVoxel), (tvg, TVoxel)):
        vg.add_voxel(V((1, 2, 3), (0.5, 0.25, 1.0)))
        vg.add_voxel(V((0, 0, 0), (1.0, 1.0, 0.0)))
    _same_grid(jvg, tvg)
    jo = JVG.create_dense(jvg.origin, 0.3, 0.9, 0.9, 0.6)
    to = bridge.voxel_grid(jo)
    _same_grid(jvg + jo, tvg + to)
    sel = [0, 3, 5]
    _same_grid(jvg.select_by_index(sel), tvg.select_by_index(sel))
    _same_grid(jvg.select_by_index(sel, invert=True),
               tvg.select_by_index(sel, invert=True))
    jvg.paint_indexed_color([1, 2], (0.1, 0.2, 0.3))
    tvg.paint_indexed_color([1, 2], (0.1, 0.2, 0.3))
    _same_grid(jvg, tvg)
    assert [tuple(v.grid_index) for v in tvg.get_voxels()] == \
        [tuple(v.grid_index) for v in jvg.get_voxels()]


def _carve_case(silhouette: bool):
    intr_args = (32, 24, 30.0, 30.0, 15.5, 11.5)
    rng = np.random.default_rng(8)
    d = np.full((24, 32), 1.2, np.float32)
    d[6:14, 8:20] = 0.9
    d[18:, :5] = 0.0
    if silhouette:
        d = (rng.uniform(size=(24, 32)) > 0.3).astype(np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = (0.02, -0.03, 0.1)
    out = []
    for Intr, Params, Img, VG, kw in (
            (JIntrinsic, JParams, JImage, JVG, {}),
            (None, TParams, TImage, TVG, {"device": CPU})):
        p = Params()
        if Intr is not None:
            p.intrinsic = Intr(*intr_args)
        else:
            from cupoch_tpu_torch.camera import PinholeCameraIntrinsic
            p.intrinsic = PinholeCameraIntrinsic(*intr_args)
        p.extrinsic = ext
        vg = VG.create_dense((-0.6, -0.45, 0.6), 0.05, 1.2, 0.9, 0.8, **kw)
        out.append((vg, Img(d, **kw), p))
    return out


@pytest.mark.parametrize("silhouette", [False, True])
@pytest.mark.parametrize("keep_outside", [False, True])
def test_torch_voxelgrid_carve_matches_jax(silhouette, keep_outside):
    (jvg, jimg, jp), (tvg, timg, tp) = _carve_case(silhouette)
    n0 = len(jvg)
    carve = "carve_silhouette" if silhouette else "carve_depth_map"
    getattr(jvg, carve)(jimg, jp, keep_outside)
    keep = tvg.carve_keep_mask(timg, tp, keep_outside).numpy()
    getattr(tvg, carve)(timg, tp, keep_outside)
    assert 0 < len(jvg) < n0
    a = set(map(tuple, np.asarray(jvg.voxels_keys).tolist()))
    b = set(map(tuple, _np(tvg.voxels_keys).tolist()))
    assert len(a ^ b) <= FMA_SHARE * n0 and int(keep.sum()) == len(tvg)


# ---------------------------------------------------------------------------
# occupancy grid
# ---------------------------------------------------------------------------

def _scan_points(seed, n=1500, box=1.4):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-box, box, (n, 3)).astype(np.float32)
    pts[:100, 1] = 0.3              # rays in a plane through the viewpoint
    pts[100:120] = pts[0]           # repeated end points
    return pts


VIEWPOINT = np.asarray([0.03, 0.3, -0.02], np.float32)


@pytest.mark.parametrize("max_range", [-1.0, 1.0])
def test_torch_occupancy_insert_bit_equal(max_range):
    j = JOcc(0.05, 64)
    t = TOcc(0.05, 64, device=CPU)
    for k in range(3):
        pts = _scan_points(10 + k)
        vp = VIEWPOINT + np.float32(0.1 * k)
        j.insert(pts, vp, max_range=max_range)
        t.insert(pts, vp, max_range=max_range)
        assert _same_nan(j.prob_log, t.prob_log)
    np.testing.assert_array_equal(t.min_bound, j.min_bound)
    np.testing.assert_array_equal(t.max_bound, j.max_bound)
    assert t.last_dda_steps > 0


def test_torch_dda_free_mask_matches_jax():
    R = 48
    pts = _scan_points(13, 3000, 1.1)
    want = np.asarray(_dda_free_mask(
        jnp.asarray(pts), jnp.asarray(VIEWPOINT), jnp.float32(0.05),
        jnp.zeros(3, jnp.float32), R, max_steps=200))
    got, steps = tocc.dda_free_mask(_t(pts), _t(VIEWPOINT), 0.05,
                                    torch.zeros(3), R, 200)
    assert want.sum() > 1000 and steps <= 200
    assert _share_differs(want, got.numpy()) <= DDA_SHARE


def test_torch_dda_stop_test_interval_keeps_mask(monkeypatch):
    pts = _scan_points(14)
    masks = []
    for k in (1, 7, 64):
        monkeypatch.setattr(tocc, "STOP_CHECK_STEPS", k)
        masks.append(tocc.dda_free_mask(_t(pts), _t(VIEWPOINT), 0.05,
                                        torch.zeros(3), 64, 300)[0])
    assert torch.equal(masks[0], masks[1]) and torch.equal(masks[0], masks[2])


def _grids_after_inserts():
    j = JOcc(0.1, 32)
    t = TOcc(0.1, 32, device=CPU)
    for k in range(2):
        pts = _scan_points(20 + k, 800)
        j.insert(pts, VIEWPOINT)
        t.insert(pts, VIEWPOINT)
    return j, t


def test_torch_occupancy_defaults_match_jax():
    t = TOcc(device=CPU, resolution=8)
    j = JOcc(resolution=8)
    for name in ("voxel_size", "clamping_thres_min", "clamping_thres_max",
                 "prob_hit_log", "prob_miss_log", "occ_prob_thres_log",
                 "visualize_free_area"):
        assert getattr(t, name) == getattr(j, name)
    import inspect
    assert inspect.signature(TOcc).parameters["resolution"].default == 512
    assert t.is_empty() and j.is_empty()


def test_torch_occupancy_extractors_match_jax():
    j, t = _grids_after_inserts()
    for name in ("extract_known_voxels", "extract_free_voxels",
                 "extract_occupied_voxels"):
        ji, jp, _ = getattr(j, name)()
        ti, tp, _ = getattr(t, name)()
        np.testing.assert_array_equal(_np(ti), ji)
        np.testing.assert_array_equal(_np(tp), jp)
    np.testing.assert_allclose(t.get_min_bound(), j.get_min_bound())
    np.testing.assert_allclose(t.get_max_bound(), j.get_max_bound())
    jc = JPointCloud.create_from_occupancygrid(j)
    tc = TPointCloud.create_from_occupancygrid(t)
    np.testing.assert_array_equal(_np(tc.points), np.asarray(jc.points))


def test_torch_occupancy_point_queries_match_jax():
    j, t = _grids_after_inserts()
    rng = np.random.default_rng(22)
    for p in rng.uniform(-1.8, 1.8, (60, 3)).astype(np.float32):
        assert t.is_occupied(p) == j.is_occupied(p)
        assert t.is_unknown(p) == j.is_unknown(p)
        ok_j, vj = j.get_voxel(p)
        ok_t, vt = t.get_voxel(p)
        assert ok_t == ok_j
        if ok_j:
            np.testing.assert_array_equal(vt.grid_index, vj.grid_index)
            assert (np.isnan(vt.prob_log) and np.isnan(vj.prob_log)) or \
                vt.prob_log == vj.prob_log


def test_torch_occupancy_add_voxels_and_free_area_match_jax():
    j, t = _grids_after_inserts()
    rng = np.random.default_rng(23)
    idx = rng.integers(-2, 34, (200, 3)).astype(np.int32)
    for occupied in (True, False):
        j.add_voxels(idx, occupied)
        t.add_voxels(idx, occupied)
        assert _same_nan(j.prob_log, t.prob_log)
    j.add_voxel([3, 4, 5], True)
    t.add_voxel([3, 4, 5], True)
    j.set_free_area([-0.45, -2.0, 0.1], [0.33, 0.2, 0.85])
    t.set_free_area([-0.45, -2.0, 0.1], [0.33, 0.2, 0.85])
    assert _same_nan(j.prob_log, t.prob_log)
    np.testing.assert_array_equal(t.min_bound, j.min_bound)
    np.testing.assert_array_equal(t.max_bound, j.max_bound)


def test_torch_occupancy_from_numpy_continues_like_jax():
    j, _ = _grids_after_inserts()
    t = bridge.occupancy_grid(j)
    pts = _scan_points(24, 600)
    j.insert(pts, VIEWPOINT + 0.2)
    t.insert(pts, VIEWPOINT + 0.2)
    assert _same_nan(j.prob_log, t.prob_log)
    np.testing.assert_array_equal(t.max_bound, j.max_bound)


def test_torch_voxelgrid_from_occupancy_grid_matches_jax():
    j, t = _grids_after_inserts()
    jvg = JVG.create_from_occupancy_grid(j)
    tvg = TVG.create_from_occupancy_grid(t)
    assert len(jvg) > 100
    _same_grid(jvg, tvg)


# ---------------------------------------------------------------------------
# laser scans
# ---------------------------------------------------------------------------

def _ranges(seed, k, n):
    rng = np.random.default_rng(seed)
    r = (2.0 + 0.3 * np.sin(np.linspace(0, 9, n))[None]
         + rng.normal(0, 0.01, (k, n))).astype(np.float32)
    r[:, n // 3:n // 3 + 4] = 0.8          # a near object: shadows
    r[:, 5] = np.nan
    return r


def _poses(k):
    out = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    for i in range(k):
        a = 0.1 * i
        out[i, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        out[i, :3, 3] = (0.05 * i, -0.02 * i, 0.4)
    return out


def _buffers(k=7, n=181, cap=5, intensities=True):
    r = _ranges(30, k, n)
    T = _poses(k)
    ints = np.random.default_rng(31).uniform(0, 1, (k, n)).astype(np.float32)
    j = JScan(n, cap, -2.0, 2.0)
    t = TScan(n, cap, -2.0, 2.0, device=CPU)
    for i in range(k):
        for b in (j, t):
            b.add_ranges(r[i], T[i], ints[i] if intensities else None)
    return j, t


def _same_buffer(j, t):
    assert (t.top_, t.bottom_) == (j.top_, j.bottom_)
    assert _same_nan(j.get_ranges(), t.get_ranges())
    np.testing.assert_array_equal(t.get_origins(), j.get_origins())
    assert _same_nan(j.get_intensities(), t.get_intensities())


def _binned_buffer_close(j, t):
    """Buffers binned from clouds: the same origins, NaN cells equal up
    to FMA_SHARE (a point on a bearing or slice boundary may fall either
    way: the packages' float32 atan2 differ by an ulp), ranges within
    1e-6 relative where both have one."""
    assert (t.top_, t.bottom_) == (j.top_, j.bottom_)
    np.testing.assert_array_equal(t.get_origins(), j.get_origins())
    a, b = j.get_ranges(), t.get_ranges()
    assert _share_differs(np.isnan(a), np.isnan(b)) <= FMA_SHARE
    ok = ~np.isnan(a) & ~np.isnan(b)
    assert ok.sum() > 50
    np.testing.assert_allclose(b[ok], a[ok], rtol=1e-6)


def test_torch_laserscan_ring_matches_jax():
    j, t = _buffers()
    assert t.is_full() and t.get_num_scans() == j.get_num_scans() == 5
    _same_buffer(j, t)
    assert t.get_angle_increment() == j.get_angle_increment()


def test_torch_laserscan_pop_and_merge_match_jax():
    j, t = _buffers()
    js, ts = j.pop_one_scan(), t.pop_one_scan()
    _same_buffer(js, ts)
    _same_buffer(j, t)
    jr, ji = j.pop_host_one_scan()
    tr, ti = t.pop_host_one_scan()
    assert _same_nan(jr, tr) and _same_nan(ji, ti)
    j2, t2 = _buffers(3, cap=4, intensities=True)
    j2.merge(j)
    t2.merge(t)
    _same_buffer(j2, t2)


def test_torch_laserscan_range_filter_matches_jax():
    j, t = _buffers()
    _same_buffer(j.range_filter(1.9, 2.2), t.range_filter(1.9, 2.2))


@pytest.mark.parametrize("window,neighbors,remove_start",
                         [(1, 0, True), (3, 1, True), (5, 2, False)])
def test_torch_laserscan_shadow_filter_matches_jax(window, neighbors,
                                                   remove_start):
    j, t = _buffers(5, 361, 5)
    jo = j.scan_shadows_filter(10.0, 170.0, window, neighbors, remove_start)
    to = t.scan_shadows_filter(10.0, 170.0, window, neighbors, remove_start)
    a = np.isnan(jo.get_ranges())
    b = np.isnan(to.get_ranges())
    assert a.sum() > np.isnan(j.get_ranges()).sum()
    assert _share_differs(a, b) <= FMA_SHARE
    ok = ~a & ~b
    np.testing.assert_array_equal(to.get_ranges()[ok], jo.get_ranges()[ok])


def test_torch_laserscan_points_match_jax():
    j, t = _buffers()
    jc = JPointCloud.create_from_laserscanbuffer(j, 0.5, 2.2)
    tc = TPointCloud.create_from_laserscanbuffer(t, 0.5, 2.2)
    assert len(jc.points) > 300
    np.testing.assert_allclose(_np(tc.points), np.asarray(jc.points),
                               atol=1e-5)
    np.testing.assert_allclose(_np(tc.colors), np.asarray(jc.colors))
    for name in ("get_min_bound", "get_max_bound", "get_center"):
        np.testing.assert_allclose(getattr(t, name)(), getattr(j, name)(),
                                   atol=1e-5)


def test_torch_laserscan_transforms_match_jax():
    j, t = _buffers()
    T = _poses(4)[3]
    T[:3, :3] = T[:3, :3] @ np.asarray([[1, 0, 0], [0, 0, -1], [0, 1, 0]],
                                       np.float32)
    for b in (j, t):
        b.transform(T)
        b.translate((0.1, 0.2, -0.3))
        b.rotate(_poses(3)[2][:3, :3])
        b.scale(1.5)
    np.testing.assert_allclose(t.get_origins(), j.get_origins(), atol=1e-6)
    assert _same_nan(j.get_ranges(), t.get_ranges())
    for b in (j, t):
        b.translate((1.0, 2.0, 3.0), relative=False)
    np.testing.assert_allclose(t.get_origins(), j.get_origins(), atol=1e-6)


def test_torch_laserscan_from_point_cloud_matches_jax():
    rng = np.random.default_rng(32)
    pts = rng.uniform(-3, 3, (4000, 3)).astype(np.float32)
    j = JScan.create_from_point_cloud(JPointCloud(pts), 0.05, -1.0, 1.0, 4,
                                      0.2, 4.0)
    t = TScan.create_from_point_cloud(TPointCloud(pts, device=CPU), 0.05,
                                      -1.0, 1.0, 4, 0.2, 4.0)
    _binned_buffer_close(j, t)


def test_torch_laserscan_from_depth_image_matches_jax():
    rng = np.random.default_rng(33)
    d = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    args = (0.04, -0.3, 0.3, 3, 0.1, 5.0)
    j = JScan.create_from_depth_image(JImage(d), JIntrinsic(
        32, 24, 30.0, 30.0, 15.5, 11.5), *args)
    from cupoch_tpu_torch.camera import PinholeCameraIntrinsic
    t = TScan.create_from_depth_image(
        TImage(d, device=CPU), PinholeCameraIntrinsic(
            32, 24, 30.0, 30.0, 15.5, 11.5), *args)
    _binned_buffer_close(j, t)


def test_torch_laserscan_from_numpy_carries_state():
    j, _ = _buffers()
    t = bridge.laser_scan(j)
    _same_buffer(j, t)
    r = _ranges(34, 2, 181)
    for b in (j, t):
        b.add_ranges(r)
    _same_buffer(j, t)


# ---------------------------------------------------------------------------
# distance transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,n_sites", [(16, 5), (32, 60), (24, 0), (20, 1),
                                       (64, 40)])
def test_torch_edt_bit_equal(R, n_sites):
    rng = np.random.default_rng(R + n_sites)
    idx = rng.integers(0, R, (n_sites, 3)).astype(np.int32)
    if n_sites > 2:
        idx[0] = (R + 3, 0, 0)               # outside: dropped
    j = JDT(0.05, R).compute_edt(idx)
    t = TDT(0.05, R, device=CPU).compute_edt(idx)
    np.testing.assert_array_equal(t.distance.numpy(), np.asarray(j.distance))
    np.testing.assert_array_equal(t.nearest_index.numpy(),
                                  np.asarray(j.nearest_index))


def test_torch_edt_matches_brute_force():
    R = 24
    rng = np.random.default_rng(40)
    sites = np.unique(rng.integers(0, R, (30, 3)), axis=0)
    t = TDT(0.05, R, device=CPU).compute_edt(sites)
    g = np.stack(np.meshgrid(*[np.arange(R)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    d2 = ((g[:, None, :] - sites[None]) ** 2).sum(-1).min(1)
    np.testing.assert_array_equal(
        np.round((t.distance.numpy().reshape(-1) / 0.05) ** 2).astype(int),
        d2)
    near = t.nearest_index.numpy().reshape(-1, 3)
    np.testing.assert_array_equal(((near - g) ** 2).sum(-1), d2)


def test_torch_edt_queries_and_voxel_grid_match_jax():
    j, t = _cloud_pair(41, 300)
    jvg = JVG.create_from_point_cloud(j, 0.1)
    tvg = bridge.voxel_grid(jvg)
    jd = JDT(0.1, 32, (0.05, 0.0, -0.05)).compute_voronoi_diagram(jvg)
    td = TDT(0.1, 32, (0.05, 0.0, -0.05), device=CPU) \
        .compute_voronoi_diagram(tvg)
    np.testing.assert_array_equal(td.distance.numpy(),
                                  np.asarray(jd.distance))
    np.testing.assert_array_equal(td.nearest_index.numpy(),
                                  np.asarray(jd.nearest_index))
    q = np.random.default_rng(42).uniform(-2, 2, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(td.get_distances(q), jd.get_distances(q))
    assert td.get_distance(q[0]) == jd.get_distance(q[0])
    carried = bridge.distance_transform(jd)
    np.testing.assert_array_equal(carried.get_distances(q),
                                  jd.get_distances(q))


def test_torch_edt_from_occupancy_grid_matches_jax():
    j, t = _grids_after_inserts()
    jd = JDT.create_from_occupancy_grid(j)
    td = TDT.create_from_occupancy_grid(t)
    np.testing.assert_array_equal(td.distance.numpy(),
                                  np.asarray(jd.distance))
    np.testing.assert_array_equal(td.nearest_index.numpy(),
                                  np.asarray(jd.nearest_index))
