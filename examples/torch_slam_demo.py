"""RGB-D SLAM through the PyTorch port, as slam_demo.py: frames of
chip_smoke.py's rendered room along its known trajectory (or cupoch's
RGB-D test data with --testdata) tracked by odometry, keyframes in a
pose graph, the graph optimised, the state saved and resumed. One
process; `parallel.launch.run_ranks` runs the backend over ranks. Runs
on the card unless --device cpu:

    python examples/torch_slam_demo.py [--device cpu] [--frames N]
        [--scale S] [--testdata DIR] [--state slam_state.npz]
"""
import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import cupoch_tpu_torch as ctt  # noqa: E402
from cupoch_tpu_torch.bench import ate  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="of PrimeSense's 640x480 camera")
    ap.add_argument("--testdata", default=None,
                    help="cupoch's test data directory (rgbd/ frames)")
    ap.add_argument("--state", default=None,
                    help="checkpoint file (default: a temporary one)")
    args = ap.parse_args(argv)
    dev = ctt.utility.resolve_device(args.device)
    create = ctt.geometry.RGBDImage.create_from_color_and_depth
    poses = None
    if args.testdata:
        frames, intr, _ = ate.read_sequence(args.testdata, dev)
    else:
        intr = ctt.camera.PinholeCameraIntrinsic(
            ctt.camera.PinholeCameraIntrinsicParameters.PrimeSenseDefault
        ).scale(args.scale)
        frames = [create(*chip_smoke.room_frame(np, ctt, k, intr, dev))
                  for k in range(args.frames)]
        poses = [chip_smoke.rgbd_pose(np, k) for k in range(args.frames)]
    slam = ctt.slam.RGBDSlam(intr, ctt.slam.SlamOption(keyframe_interval=2),
                             device=dev)
    for i, rgbd in enumerate(frames):
        slam.process_frame(rgbd)
        print(f"frame {i}: t={slam.cur_pose[:3, 3].round(4)} "
              f"keyframes={len(slam.pose_graph.nodes)}")
    slam.optimize()
    errors = []
    if poses is not None:
        errors = [float(np.linalg.norm(T[:3, 3] - P[:3, 3]))
                  for T, P in zip(slam.trajectory, poses)]
        print(f"translation error: max {max(errors):.4f} m over "
              f"{len(errors)} frames")
    with tempfile.TemporaryDirectory() as tmp:
        path = args.state or os.path.join(tmp, "slam_state.npz")
        slam.save(path)
        print(f"saved {len(slam.trajectory)} poses, "
              f"{len(slam.pose_graph.edges)} edges -> {path}")
        resumed = ctt.slam.RGBDSlam(intr, device=dev)
        resumed.restore(path)
    print(f"restored at frame {resumed.frame_id} with "
          f"{len(resumed.pose_graph.nodes)} keyframes")
    return slam, resumed, errors


if __name__ == "__main__":
    main()
