"""KinectFusion through the PyTorch port, as kinfu_demo.py: frames of
chip_smoke.py's rendered room along its known trajectory (or cupoch's
RGB-D test data with --testdata), tracked and fused into a TSDF volume,
then the model's cloud. Runs on the card unless --device cpu:

    python examples/torch_kinfu_demo.py [--device cpu] [--frames N]
        [--scale S] [--resolution R] [--testdata DIR] [--out model.ply]
"""
import argparse
import glob
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import cupoch_tpu_torch as ctt  # noqa: E402

def room_frames(intr, n, dev):
    """(colour, depth mm) Images of the room's first n frames and their
    true camera-to-first-camera poses."""
    frames = [chip_smoke.room_frame(np, ctt, k, intr, dev) for k in range(n)]
    return frames, [chip_smoke.rgbd_pose(np, k) for k in range(n)]


def file_frames(testdata, dev):
    intr = ctt.io.read_pinhole_camera_intrinsic(
        os.path.join(testdata, "camera_primesense.json"))
    colors = sorted(glob.glob(os.path.join(testdata, "rgbd/color/*")))
    depths = sorted(glob.glob(os.path.join(testdata, "rgbd/depth/*")))
    return intr, [(ctt.io.read_image(c, dev), ctt.io.read_image(d, dev))
                  for c, d in zip(colors, depths)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="of PrimeSense's 640x480 camera")
    ap.add_argument("--resolution", type=int, default=256,
                    help="voxels along each side of the 4 m volume")
    ap.add_argument("--testdata", default=None,
                    help="cupoch's test data directory (rgbd/ frames)")
    ap.add_argument("--out", default=None, help="write the model's cloud")
    args = ap.parse_args(argv)
    dev = ctt.utility.resolve_device(args.device)
    # KinFu filters the colour pyramid channel by channel, which the
    # image filter warns of on every level of every frame
    ctt.utility.set_verbosity_level(ctt.utility.VerbosityLevel.Error)
    poses = None
    if args.testdata:
        intr, frames = file_frames(args.testdata, dev)
    else:
        intr = ctt.camera.PinholeCameraIntrinsic(
            ctt.camera.PinholeCameraIntrinsicParameters.PrimeSenseDefault
        ).scale(args.scale)
        frames, poses = room_frames(intr, args.frames, dev)
    # a 4 m cube centred 2 m ahead of the first camera, truncated at
    # three voxels (at least 4 cm)
    opt = ctt.kinfu.KinfuOption(
        num_pyramid_levels=2, tsdf_length=4.0,
        tsdf_resolution=args.resolution,
        sdf_trunc=max(0.04, 3 * 4.0 / args.resolution),
        tsdf_origin=(0.0, 0.0, 2.0), distance_threshold=0.1,
        icp_iterations=[10, 10])
    pipe = ctt.kinfu.KinfuPipeline(intr, opt, device=dev)
    errors = []
    for i, (c, d) in enumerate(frames):
        rgbd = ctt.geometry.RGBDImage.create_from_color_and_depth(
            c, d, convert_rgb_to_intensity=False)
        t0 = time.time()
        ok = pipe.process_frame(rgbd)
        line = (f"frame {i}: tracked={ok} t={pipe.cur_pose[:3, 3].round(4)}"
                f" ({time.time() - t0:.2f}s)")
        if poses is not None:
            errors.append(float(np.linalg.norm(
                pipe.cur_pose[:3, 3] - poses[i][:3, 3])))
            line += f" translation error {errors[-1]:.4f} m"
        print(line)
        assert ok, f"frame {i} lost"
    pcd = pipe.extract_point_cloud()
    print(f"reconstructed {len(pcd)} surface points")
    if args.out:
        ctt.io.write_point_cloud(args.out, pcd)
        print(f"wrote {args.out}")
    return pipe, errors


if __name__ == "__main__":
    main()
