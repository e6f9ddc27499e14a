"""The point-cloud pipeline of pipeline_demo.py through the PyTorch
port: down-sampling, normals, outlier removal, RANSAC plane, DBSCAN,
point-to-point and point-to-plane ICP, then RGB-D odometry and a TSDF
volume on a synthetic frame. The cloud is chip_smoke.py's room scene
unless --testdata names cupoch's test data (fragment.pcd). Runs on the
card unless --device cpu:

    python examples/torch_pipeline_demo.py [--device cpu] [--points N]
        [--testdata DIR]
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import cupoch_tpu_torch as ctt  # noqa: E402


def load_cloud(args, dev):
    if args.testdata:
        return ctt.io.read_point_cloud(
            os.path.join(args.testdata, "fragment.pcd"), device=dev)
    tgt, _, _ = chip_smoke.scene_pair(np, args.points)
    return ctt.geometry.PointCloud(tgt, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--points", type=int, default=200_000,
                    help="points of the room scene")
    ap.add_argument("--testdata", default=None,
                    help="cupoch's test data directory (fragment.pcd)")
    args = ap.parse_args(argv)
    dev = ctt.utility.resolve_device(args.device)
    G, reg = ctt.geometry, ctt.registration
    t_all = time.time()
    pcd = load_cloud(args, dev)
    print(f"loaded: {pcd}")

    t0 = time.time()
    down = pcd.voxel_down_sample(0.02)
    print(f"voxel_down_sample(0.02): {down}  [{time.time() - t0:.2f}s]")
    assert 0 < len(down) < len(pcd)

    t0 = time.time()
    down.estimate_normals(ctt.knn.KDTreeSearchParamKNN(30))
    nn = down.normals.cpu().numpy()
    print(f"estimate_normals: ok  [{time.time() - t0:.2f}s]")
    assert np.allclose(np.linalg.norm(nn, axis=-1), 1.0, atol=1e-3)

    t0 = time.time()
    filt, _ = down.remove_statistical_outliers(20, 2.0)
    print(f"remove_statistical_outliers: kept {len(filt)}/{len(down)}  "
          f"[{time.time() - t0:.2f}s]")

    t0 = time.time()
    plane, inliers = filt.segment_plane(0.05, 3, 50)
    print(f"segment_plane: {np.round(plane, 3)} with {len(inliers)} "
          f"inliers  [{time.time() - t0:.2f}s]")
    assert len(inliers) > 100

    t0 = time.time()
    labels = filt.cluster_dbscan(0.05, 10)
    print(f"cluster_dbscan: {int(labels.max()) + 1} clusters  "
          f"[{time.time() - t0:.2f}s]")

    # a moved copy aligned back
    ang = 0.03
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    T_true[:3, 3] = [0.02, -0.01, 0.01]
    src = G.PointCloud(down.points, device=dev)
    src.normals = down.normals
    tgt = G.PointCloud(down.points, device=dev)
    tgt.normals = down.normals
    tgt.transform(T_true)
    for est, name in ((reg.TransformationEstimationPointToPoint(), "pt2pt"),
                      (reg.TransformationEstimationPointToPlane(),
                       "pt2plane")):
        t0 = time.time()
        res = reg.registration_icp(src, tgt, 0.07,
                                   np.eye(4, dtype=np.float32), est)
        err = np.linalg.norm(res.transformation - T_true)
        print(f"registration_icp[{name}]: fitness={res.fitness:.3f} "
              f"rmse={res.inlier_rmse:.4f} err={err:.4f}  "
              f"[{time.time() - t0:.2f}s]")
        assert res.fitness > 0.95 and err < 0.02, (res.fitness, err)

    # RGB-D odometry and a TSDF volume on a synthetic frame
    H, W = 60, 80
    fx = fy = 60.0
    cx, cy = (W - 1) / 2, (H - 1) / 2
    intr = ctt.camera.PinholeCameraIntrinsic(W, H, fx, fy, cx, cy)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    depth = (1.0 + 0.2 * ((uu - cx) / fx)).astype(np.float32)
    color = (0.5 + 0.3 * np.sin(8 * uu / W)
             * np.cos(6 * vv / H)).astype(np.float32)
    rgbd = G.RGBDImage(G.Image(color[..., None], device=dev),
                       G.Image(depth[..., None], device=dev))
    ok, T_odo, _ = ctt.odometry.compute_rgbd_odometry(
        rgbd, rgbd, intr, np.eye(4, dtype=np.float32),
        ctt.odometry.RGBDOdometryJacobianFromHybridTerm(),
        ctt.odometry.OdometryOption(max_depth_diff=0.1))
    assert ok and np.linalg.norm(T_odo - np.eye(4)) < 1e-3
    print("rgbd odometry identity check: ok")

    vol = ctt.integration.UniformTSDFVolume(
        2.0, 64, 0.08, ctt.integration.TSDFVolumeColorType.Gray32,
        origin=(0.0, 0.0, 1.0), device=dev)
    vol.integrate(rgbd, intr)
    surf = vol.extract_point_cloud()
    mesh = vol.extract_triangle_mesh()
    model = vol.raycast(intr, np.eye(4, dtype=np.float32))
    print(f"tsdf: surface {len(surf)} pts, mesh "
          f"{int(mesh.triangles.shape[0])} tris, raycast {len(model)} pts")
    assert len(surf) > 100 and mesh.has_triangles() and len(model) > 100
    print(f"ALL OK in {time.time() - t_all:.1f}s")
    return res


if __name__ == "__main__":
    main()
