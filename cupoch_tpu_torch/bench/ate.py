"""Absolute trajectory error of hybrid RGB-D odometry on a sequence on
disk: the odometry of consecutive frames chained into a trajectory and
held to the ground truth's translations after both start at the
identity.

The sequence has the layout of cupoch's RGB-D test data: the camera in
`camera_primesense.json`, the frames in `rgbd/color/*` and
`rgbd/depth/*` (sorted by name; PNG depth in mm) and the true
camera-to-world poses in `rgbd/trajectory.log`. Run:

    python -m cupoch_tpu_torch.bench.ate --testdata DIR [--device cpu]

which prints one JSON line.
"""
from __future__ import annotations

import glob
import json
import os
from typing import List, Tuple

import numpy as np


def align_first(est: List[np.ndarray], gt: List[np.ndarray]):
    """Both trajectories moved to start at the identity."""
    e0 = np.linalg.inv(est[0])
    g0 = np.linalg.inv(gt[0])
    return [e0 @ T for T in est], [g0 @ T for T in gt]


def compute_ate(est: List[np.ndarray], gt: List[np.ndarray]) -> float:
    """RMSE of the translations after `align_first`, over the frames
    both trajectories have."""
    n = min(len(est), len(gt))
    est, gt = align_first(est[:n], gt[:n])
    t_e = np.stack([T[:3, 3] for T in est])
    t_g = np.stack([T[:3, 3] for T in gt])
    return float(np.sqrt(np.mean(np.sum((t_e - t_g) ** 2, -1))))


def read_sequence(testdata: str, device=None):
    """(RGB-D frames on `device` (None: the card), intrinsic, true
    poses) of the sequence under `testdata`."""
    from .. import io
    from ..geometry import RGBDImage

    intr = io.read_pinhole_camera_intrinsic(
        os.path.join(testdata, "camera_primesense.json"))
    colors = sorted(glob.glob(os.path.join(testdata, "rgbd/color/*")))
    depths = sorted(glob.glob(os.path.join(testdata, "rgbd/depth/*")))
    gt = io.read_trajectory_log(os.path.join(testdata,
                                             "rgbd/trajectory.log"))
    frames = [RGBDImage.create_from_color_and_depth(
        io.read_image(c, device), io.read_image(d, device))
        for c, d in zip(colors, depths)]
    return frames, intr, gt


def odometry_trajectory(frames, intrinsic) -> List[np.ndarray]:
    """Camera-to-first-frame poses [4, 4] f32 of the frames: hybrid
    odometry of each frame to the one before it at the default option,
    chained (a failed pair counts as no motion)."""
    from ..odometry import (OdometryOption,
                            RGBDOdometryJacobianFromHybridTerm,
                            compute_rgbd_odometry)

    poses = [np.eye(4, dtype=np.float32)]
    opt = OdometryOption()
    for k in range(1, len(frames)):
        ok, motion, _ = compute_rgbd_odometry(
            frames[k], frames[k - 1], intrinsic,
            jacobian=RGBDOdometryJacobianFromHybridTerm(), option=opt)
        if not ok:
            motion = np.eye(4, dtype=np.float32)
        poses.append((poses[-1] @ motion).astype(np.float32))
    return poses


def run_sequence(testdata: str, device=None
                 ) -> Tuple[float, int, List[np.ndarray]]:
    """(ATE in m, frames, the estimated poses) of the sequence under
    `testdata`, on `device` (None: the card)."""
    frames, intr, gt = read_sequence(testdata, device)
    poses = odometry_trajectory(frames, intr)
    return compute_ate(poses, gt), len(frames), poses


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="ATE of hybrid RGB-D odometry on a sequence on disk")
    ap.add_argument("--testdata", required=True,
                    help="directory with camera_primesense.json and rgbd/")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    ate, n, _ = run_sequence(args.testdata, args.device)
    print(json.dumps({"metric": "rgbd_odometry_ate_rmse", "value": ate,
                      "unit": "m", "frames": n}))


if __name__ == "__main__":
    main()
