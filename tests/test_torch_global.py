"""The global-registration pipeline of chip_smoke.py's phase 4g on a
small version of its scene (2000 points a cloud, brute-force
branches): the JAX package runs the whole pipeline, and the port runs
each step on that step's input from the JAX run (moved over through
numpy), so a tie broken differently upstream does not carry on.

The scene is scaled only in its point count; the voxel v is 0.1 (the
scene's 26 m^2 hold about 2600 voxels of that size), and the ICP
refinement searches 1.5v, since at this density a point's nearest
neighbour in the other cloud lies about 5 cm away.

Tolerances: voxel counts equal and means within 1e-6 relative; the
statistical outlier indices, the DBSCAN labels and the RANSAC plane on
the reference's own draws (within 1e-5) as in test_torch_pointcloud.py;
FPFH per point as in test_torch_feature.py (`fpfh_moved_pairs`); the
FGR pose on the reference's draws and feature matches within 1e-4; the
refined pose within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import cupoch_tpu.registration as jreg
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.geometry.pointcloud import _pad_cloud as j_pad_cloud
from cupoch_tpu.knn import KDTreeSearchParamHybrid as JHybrid
from cupoch_tpu.registration import feature as jfeat
import cupoch_tpu_torch.registration as treg
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.geometry import pointcloud_ops as tops
from cupoch_tpu_torch.knn import KDTreeSearchParamHybrid as THybrid
from cupoch_tpu_torch.registration import feature as tfeat
from torch_port_bridge import cloud as to_port
from torch_port_bridge import feature as to_port_feature
from torch_port_bridge import inject_jax_fgr_choices

N = 2000
V = 0.1
EPS, MIN_POINTS = 0.25, 5
PLANE_ITERS = 50


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's pipeline on the small scene, step by step."""
    tgt, src, T_true = cs.scene_pair(np, N)
    r = {"src": src, "tgt": tgt, "T_true": T_true}
    for name, pts in (("s", src), ("t", tgt)):
        down = JPointCloud(pts).voxel_down_sample(V)
        r[name + "_down"] = down
        normed = JPointCloud(np.asarray(down.points))
        normed.estimate_normals(JHybrid(2 * V, 30))
        r[name + "_normed"] = normed
        sor, idx = normed.remove_statistical_outliers(20, 2.0)
        r[name + "_sor"], r[name + "_sor_idx"] = sor, idx
        r[name + "_fpfh"] = jfeat.compute_fpfh_feature(
            sor, JHybrid(5 * V, 100))
    td = r["t_sor"]
    r["plane"], r["inliers"] = td.segment_plane(0.05, 3, PLANE_ITERS)
    r["rest"] = td.select_by_index(r["inliers"], invert=True)
    r["labels"] = r["rest"].cluster_dbscan(EPS, MIN_POINTS)
    r["fgr_opt"] = jreg.FastGlobalRegistrationOption(
        maximum_correspondence_distance=0.5 * V)
    r["fgr"] = jreg.fast_global_registration(
        r["s_sor"], td, r["s_fpfh"], r["t_fpfh"], r["fgr_opt"])
    t_full = JPointCloud(tgt)
    t_full.estimate_normals(JHybrid(2 * V, 30))
    r["t_full"] = t_full
    r["icp"] = jreg.registration_icp(
        JPointCloud(src), t_full, 1.5 * V, r["fgr"].transformation,
        jreg.TransformationEstimationPointToPlane(),
        jreg.ICPConvergenceCriteria(1e-6, 1e-6, 30))
    return r


def test_torch_global_voxel_and_outliers_match_jax(jax_run):
    """Voxel counts and means; the statistical outlier indices on the
    reference's down-sampled cloud and normals."""
    for name in ("s", "t"):
        down = TPointCloud(jax_run["src" if name == "s" else "tgt"],
                           device="cpu").voxel_down_sample(V)
        want = np.asarray(jax_run[name + "_down"].points)
        assert len(down) == len(want)
        np.testing.assert_allclose(down.points.numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        _, idx = to_port(jax_run[name + "_normed"]) \
            .remove_statistical_outliers(20, 2.0)
        np.testing.assert_array_equal(idx, jax_run[name + "_sor_idx"])


def test_torch_global_normals_match_jax(jax_run):
    """Normals of the down-sampled cloud, up to sign, within 1e-4 on
    99% of the points (the least eigenvector of nearly isotropic
    neighbourhoods is ill-conditioned in f32 in both packages)."""
    for name in ("s", "t"):
        pc = TPointCloud(np.asarray(jax_run[name + "_down"].points),
                         device="cpu")
        pc.estimate_normals(THybrid(2 * V, 30))
        dots = np.abs((pc.normals.numpy()
                       * np.asarray(jax_run[name + "_normed"].normals))
                      .sum(-1))
        assert (dots >= 1 - 1e-4).mean() >= 0.99


def test_torch_global_plane_and_clusters_match_jax(jax_run):
    """The plane on the reference's own draws within 1e-5; the DBSCAN
    labels of what remains, equal."""
    td = jax_run["t_sor"]
    pts = np.asarray(td.points)
    pj, mj = j_pad_cloud(jnp.asarray(pts))
    g = jax.random.gumbel(jax.random.PRNGKey(0),
                          (PLANE_ITERS, pj.shape[0])) \
        + jnp.where(mj, 0.0, -jnp.inf)[None]
    tri = torch.as_tensor(np.array(jax.lax.top_k(g, 3)[1]))
    plane, _ = tops.score_planes(torch.as_tensor(pts), tri, 0.05)
    np.testing.assert_allclose(plane.numpy(), jax_run["plane"], atol=1e-5)
    labels = to_port(jax_run["rest"]).cluster_dbscan(EPS, MIN_POINTS)
    assert labels.max() >= 1
    np.testing.assert_array_equal(labels, jax_run["labels"])


def test_torch_global_fpfh_matches_jax(jax_run):
    for name in ("s", "t"):
        pc = to_port(jax_run[name + "_sor"])
        param = THybrid(5 * V, 100)
        got = treg.compute_fpfh_feature(pc, param).data.numpy().T
        want = np.asarray(jax_run[name + "_fpfh"].data).T
        idx, _ = treg.feature.search_neighbors(pc.points, pc.points, param)
        spfh_t = tfeat._spfh(pc.points, pc.normals, idx).numpy()
        jp = jax_run[name + "_sor"]
        spfh_j = np.asarray(jfeat._spfh(jp.points, jp.normals,
                                        jnp.asarray(idx.numpy())))
        idx = idx.numpy()
        close, moved = cs.fpfh_moved_pairs(
            np, spfh_j, spfh_t,
            100.0 / np.maximum((idx >= 0).sum(-1) - 1.0, 1.0))
        assert (close | moved).all()
        reached = moved | (moved[np.where(idx >= 0, idx, 0)]
                           & (idx >= 0)).any(-1)
        np.testing.assert_allclose(got[~reached], want[~reached], rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_torch_global_fgr_and_refinement_match_jax(jax_run, monkeypatch):
    """FGR on the reference's features, tuple draws and feature matches
    (the FPFH of this scene's flat regions hold many f32 near-ties,
    which the port ranks in f64), then the ICP refinement from the
    reference's FGR pose: both within 1e-4."""
    inject_jax_fgr_choices(monkeypatch)
    opt = treg.FastGlobalRegistrationOption(**vars(jax_run["fgr_opt"]))
    fgr = treg.fast_global_registration(
        to_port(jax_run["s_sor"]), to_port(jax_run["t_sor"]),
        to_port_feature(jax_run["s_fpfh"]),
        to_port_feature(jax_run["t_fpfh"]), opt)
    np.testing.assert_allclose(fgr.transformation,
                               jax_run["fgr"].transformation, atol=1e-4)
    icp = treg.registration_icp(
        TPointCloud(jax_run["src"], device="cpu"), to_port(jax_run["t_full"]),
        1.5 * V, jax_run["fgr"].transformation,
        treg.TransformationEstimationPointToPlane(),
        treg.ICPConvergenceCriteria(1e-6, 1e-6, 30))
    np.testing.assert_allclose(icp.transformation,
                               jax_run["icp"].transformation, atol=1e-4)
    assert icp.fitness == pytest.approx(jax_run["icp"].fitness, abs=1e-3)
