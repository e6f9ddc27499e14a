"""Semi-global stereo matching through the PyTorch port, as
stereo_demo.py: chip_smoke.py's rendered stereo pair of the room (or
left.png / right.png of cupoch's test data with --testdata) matched
into disparities, then a coloured cloud. Runs on the card unless
--device cpu:

    python examples/torch_stereo_demo.py [--device cpu] [--scale S]
        [--disp 64|128|256] [--testdata DIR] [--out cloud.ply]
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import cupoch_tpu_torch as ctt  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="of PrimeSense's 640x480 camera")
    ap.add_argument("--disp", type=int, default=128,
                    help="disparity range (64, 128 or 256)")
    ap.add_argument("--testdata", default=None,
                    help="cupoch's test data directory (left/right.png)")
    ap.add_argument("--out", default=None, help="write the stereo cloud")
    args = ap.parse_args(argv)
    dev = ctt.utility.resolve_device(args.device)
    G = ctt.geometry
    truth = None
    if args.testdata:
        left = ctt.io.read_image(os.path.join(args.testdata, "left.png"),
                                 dev)
        right = ctt.io.read_image(os.path.join(args.testdata, "right.png"),
                                  dev)
        color, baseline = left, 0.1
        intr = ctt.camera.PinholeCameraIntrinsic(
            left.width, left.height, 500.0, 500.0, left.width / 2,
            left.height / 2)
    else:
        intr = ctt.camera.PinholeCameraIntrinsic(
            ctt.camera.PinholeCameraIntrinsicParameters.PrimeSenseDefault
        ).scale(args.scale)
        grey_l, grey_r, rgb_l, z_l = chip_smoke.stereo_pair(np, intr)
        left, right = G.Image(grey_l, device=dev), G.Image(grey_r,
                                                           device=dev)
        color, baseline = G.Image(rgb_l, device=dev), \
            chip_smoke.STEREO_BASELINE
        fx, _ = intr.get_focal_length()
        truth = np.where(z_l > 0, fx * baseline / np.maximum(z_l, 1e-9), 0)
    opt = ctt.imageproc.SGMOption(left.width, left.height,
                                  disp_size=args.disp)
    disp = ctt.imageproc.SemiGlobalMatching(opt).process_frame(left, right)
    d = disp.to_numpy()[..., 0]
    line = (f"disparity: {100 * (d > 0).mean():.0f}% valid, median "
            f"{np.median(d[d > 0]):.1f} px")
    within = None
    if truth is not None:
        ok = (d > 0) & (truth > 0)
        within = float((np.abs(d[ok] - truth[ok]) <= 1.0).mean())
        line += f"; {100 * within:.1f}% of those within 1 px of the truth"
    print(line)
    pcd = G.PointCloud.create_from_disparity(disp, color, intr, intr,
                                             baseline)
    print(f"stereo cloud: {len(pcd)} points")
    if args.out:
        ctt.io.write_point_cloud(args.out, pcd)
        print(f"wrote {args.out}")
    return pcd, within


if __name__ == "__main__":
    main()
