"""Per-op timing harness over cupoch's benchmark surface
(examples/python/basic/benchmarks.py: transform, estimate_normals,
voxel_down_sample, outlier removal, registration_icp, cluster_dbscan;
benchmarks2.py: compute_rgbd_odometry; benchmarks3.py: mesh sampling;
and the FPFH + FGR pipeline and KinectFusion frames).

Each op runs once to build and warm, then `reps` times; the minimum
counts. A CUDA launch returns before the card finishes, so every run
ends in `torch.cuda.synchronize` on the card. Run:

    python -m cupoch_tpu_torch.bench [--pcd PATH] [--reps N]
        [--trace DIR] [--device cpu]

which prints one line an op and then one JSON list. `--trace` writes a
`torch.profiler` trace of every run as Chrome-trace JSON into DIR: on
the card its CUDA activity (kernels, copies and the runtime calls that
launch them), on the CPU the operators. The host's operator events are
left out on the card: recording them for the tens of thousands of
launches of the FGR pipeline took longer than the pipeline.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..utility.device import resolve_device

TRACE_FILE = "harness_trace.json"
# the ops `run_benchmarks` times, in its order (the JAX harness's names)
OPS = ("transform", "estimate_normals", "voxel_down_sample",
       "remove_radius_outlier", "remove_statistical_outlier",
       "registration_icp", "cluster_dbscan", "compute_rgbd_odometry",
       "fpfh_fgr_pipeline", "kinfu_process_frame_x3",
       "sample_points_uniformly")
# (height, width) of the synthetic RGB-D frame of the odometry and KinFu
# ops (benchmarks2.py's QVGA)
RGBD_SHAPE = (240, 320)


@dataclasses.dataclass
class BenchResult:
    name: str
    seconds: float
    detail: str = ""

    def to_dict(self):
        return {"name": self.name, "seconds": round(self.seconds, 6),
                "detail": self.detail}


def _sync(device: torch.device) -> None:
    """Wait for the card's queue (a CPU op has ended on return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_op(name: str, fn: Callable, reps: int = 3, detail: str = "",
            device=None) -> BenchResult:
    """The least of `reps` timed runs of `fn`, after one untimed run;
    each run ends when `device`'s queue (the card's when None) is
    empty."""
    device = resolve_device(device)
    fn()  # build + settle
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return BenchResult(name, best, detail)


def _load_cloud(pcd_path: Optional[str], device):
    from ..geometry import PointCloud

    if pcd_path:
        from .. import io

        return io.read_point_cloud(pcd_path, device=device)
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(120_000, 3)).astype(np.float32)
    pcd = PointCloud(pts, device=device)
    pcd.colors = rng.uniform(size=(120_000, 3)).astype(np.float32)
    return pcd


def run_benchmarks(pcd_path: Optional[str] = None,
                   trace_dir: Optional[str] = None,
                   reps: int = 3, device=None) -> List[BenchResult]:
    """cupoch's benchmark suite on this package's API, on `device` (the
    card when None)."""
    dev = resolve_device(device)
    prof = None
    if trace_dir:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[
            act.CUDA if dev.type == "cuda" else act.CPU])
        prof.start()
    try:
        results = _run(pcd_path, reps, dev)
    finally:
        if prof is not None:
            prof.stop()
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    return results


def _run(pcd_path, reps, dev) -> List[BenchResult]:
    from .. import registration
    from ..geometry import PointCloud

    def timed(name, fn, detail):
        results.append(time_op(name, fn, reps, detail, dev))

    results: List[BenchResult] = []
    pcd = _load_cloud(pcd_path, dev)
    n = len(pcd)

    # a copy to the host and back, then the transform
    T = np.eye(4, dtype=np.float32)
    timed("transform", lambda: PointCloud(
        pcd.points.cpu().numpy(), device=dev).transform(T), f"{n} pts")

    def _normals():
        p = PointCloud(pcd.points, device=dev)
        p.estimate_normals()
        return p.normals

    timed("estimate_normals", _normals, f"{n} pts, knn 30")
    timed("voxel_down_sample", lambda: pcd.voxel_down_sample(0.005).points,
          "voxel 0.005")
    timed("remove_radius_outlier",
          lambda: pcd.remove_radius_outliers(10, 0.1)[0].points,
          "nb 10, r 0.1")
    timed("remove_statistical_outlier",
          lambda: pcd.remove_statistical_outliers(20, 2.0)[0].points,
          "nb 20, std 2.0")

    ang = np.deg2rad(30.0)
    trans_init = np.asarray(
        [[np.cos(ang), -np.sin(ang), 0, 0],
         [np.sin(ang), np.cos(ang), 0, 0],
         [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    tgt = PointCloud(pcd.points.cpu().numpy(), device=dev)
    tgt.transform(trans_init)
    timed("registration_icp",
          lambda: registration.registration_icp(
              pcd, tgt, 0.02, trans_init,
              registration.TransformationEstimationPointToPoint()
          ).transformation,
          "pt2pt, thr 0.02")

    timed("cluster_dbscan", lambda: pcd.cluster_dbscan(0.02, 10),
          "eps 0.02, min 10")

    # benchmarks2.py: RGB-D odometry on a synthetic frame pair
    from ..camera import PinholeCameraIntrinsic
    from ..geometry import Image, RGBDImage
    from ..odometry import compute_rgbd_odometry

    rng = np.random.default_rng(1)
    H, W = RGBD_SHAPE
    depth = (1.0 + 0.2 * rng.random((H, W))).astype(np.float32)
    color = rng.random((H, W)).astype(np.float32)
    rgbd = RGBDImage(Image(color[..., None], device=dev),
                     Image(depth[..., None], device=dev))
    intr = PinholeCameraIntrinsic(W, H, 250.0, 250.0, W / 2, H / 2)
    timed("compute_rgbd_odometry",
          lambda: compute_rgbd_odometry(rgbd, rgbd, intr)[1],
          f"{W}x{H} hybrid")

    # voxel down-sampling, FPFH and FGR
    def _fgr_pipeline():
        from ..knn import KDTreeSearchParamHybrid
        from ..registration import (
            FastGlobalRegistrationOption,
            compute_fpfh_feature,
            fast_global_registration,
        )

        s = pcd.voxel_down_sample(0.02)
        t = tgt.voxel_down_sample(0.02)
        s.estimate_normals(KDTreeSearchParamHybrid(0.06, 30))
        t.estimate_normals(KDTreeSearchParamHybrid(0.06, 30))
        fs = compute_fpfh_feature(s, KDTreeSearchParamHybrid(0.1, 64))
        ft = compute_fpfh_feature(t, KDTreeSearchParamHybrid(0.1, 64))
        res = fast_global_registration(
            s, t, fs, ft, FastGlobalRegistrationOption())
        return res.transformation

    timed("fpfh_fgr_pipeline", _fgr_pipeline,
          "voxel 0.02 + FPFH + FGR (config #2)")

    # KinectFusion frames
    def _kinfu():
        from ..kinfu import KinfuOption, KinfuPipeline

        opt = KinfuOption(num_pyramid_levels=2, tsdf_length=3.0,
                          tsdf_resolution=64)
        pipe = KinfuPipeline(intr, opt, device=dev)
        for _ in range(3):
            pipe.process_frame(rgbd)
        return pipe.cur_pose

    timed("kinfu_process_frame_x3", _kinfu,
          "2 levels, 64^3 tsdf (config #4)")

    # benchmarks3.py: mesh sampling
    from ..geometry.trianglemesh_factory import create_sphere

    mesh = create_sphere(resolution=50, device=dev)
    timed("sample_points_uniformly",
          lambda: mesh.sample_points_uniformly(100_000).points,
          "sphere res 50 -> 100k pts")
    return results


def main(argv=None) -> List[BenchResult]:
    import argparse

    ap = argparse.ArgumentParser(
        description="per-op timings of cupoch's benchmark surface")
    ap.add_argument("--pcd", default=None,
                    help="point cloud file (default: synthetic 120k)")
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler trace into this directory")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    results = run_benchmarks(args.pcd, args.trace, args.reps, args.device)
    for r in results:
        print(f"{r.name:32s} {r.seconds * 1000:10.2f} ms   {r.detail}")
    print(json.dumps([r.to_dict() for r in results]))
    return results


if __name__ == "__main__":
    main()
