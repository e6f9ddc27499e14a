"""Readings behind the open question of a LiDAR scan-odometry cell: where
the port's point-to-plane ICP on 64-beam street scans parts from the
plain reference.

    python3 benchmark/lidar_witness.py --seeds <a,b,...> [--variants street,blocks] [--device cuda]

For each seed and scene variant (`traffic/street_scans.json`), one
pair of scans (`scenes/street.py`), the source moved by one frame's
step and registered onto the target from a constant-velocity init
(the true motion with an error drawn from the seed), at the cell's
settings: normals by `KDTreeSearchParamHybrid(1.0, 30)`, threshold
1.0 m, default criteria. It prints one JSON line a reading:
- `normals_deg`: the median and largest angle between the port's
  normals and the exact ones (`reference/normals.py`), and the share
  of points over 1 degree; and with the port's brute-force search
  forced (`brute_normals_deg`); `parted`: of the points over 1 degree,
  the median range, neighbour count and middle over largest
  eigenvalue of the neighbourhood's covariance (near 0: a line);
- `program`: the port's pose against the reference's (the gaps that
  `correct` compares), `program_ref_normals`: the port's ICP given the
  reference's normals, `reference_port_normals`: the reference's ICP
  given the port's normals, against the port's pose;
- `control`: the reference in bfloat16 against the reference;
- `truth`: the reference against the true motion;
- `weak`: the least over the largest eigenvalue of the reference's
  Gauss-Newton matrix at its pose, and the unit motion it leaves
  least constrained.
Runs on the card; `--device cpu --beams 8` rehearses it on the host.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT

os.environ["USE_FLAX"] = "0"

import numpy as np  # noqa: E402
import torch  # noqa: E402

import cupoch_tpu_torch as ctt  # noqa: E402
from benchmark.lib import registry, rng  # noqa: E402
from benchmark.lib.precision import working  # noqa: E402
from benchmark.reference import grid_nn, normals  # noqa: E402
from benchmark.reference import icp as ref_icp  # noqa: E402
from benchmark.scenes import street  # noqa: E402


def gaps(T, R):
    T, R = np.asarray(T, np.float64), np.asarray(R, np.float64)
    return {"rot_gap": float(np.abs(T[:3, :3] - R[:3, :3]).max()),
            "shift_gap": float(np.abs(T[:3, 3] - R[:3, 3]).max()),
            "along_street": float(T[0, 3] - R[0, 3])}


def angles_deg(a, b):
    c = (a.double() * b.double()).sum(1).abs().clamp(max=1.0)
    deg = torch.rad2deg(torch.arccos(c))
    return [float(deg.median()), float(deg.max()),
            float((deg > 1.0).double().mean())]


def parted(tgt, n_port, n_ref, p):
    """What the points whose normals part by over 1 degree look like."""
    c = (n_port.double() * n_ref.double()).sum(1).abs().clamp(max=1.0)
    bad = torch.rad2deg(torch.arccos(c)) > 1.0
    if not bool(bad.any()):
        return {}
    idx = normals.hybrid_neighbours(tgt, p["normal_radius_m"],
                                    p["normal_max_nn"])[bad]
    have = idx >= 0
    cnt = have.sum(1)
    nb = tgt.double()[idx.clamp(min=0)] * have[..., None]
    d = (nb - (nb.sum(1) / cnt[:, None])[:, None]) * have[..., None]
    ev = torch.linalg.eigvalsh((d.transpose(1, 2) @ d).cpu())
    return {"range_m": float(tgt[bad].norm(dim=1).median()),
            "neighbours": float(cnt.double().median()),
            "line": float((ev[:, 1] / ev[:, 2].clamp(min=1e-30)).median())}


def pair(p, seed, variant, dev):
    """(source, target, true motion [4, 4], init [4, 4])."""
    h = rng.host_rng(seed, "street", variant)
    boxes = street.layout(h, p)
    P0 = street.pose(h.uniform(-20, 20), h.uniform(-1, 1), h.uniform(-3, 3),
                     p["sensor_height_m"])
    fwd, side, yaw = street.motion(h, p)
    P1 = P0 @ street.pose(fwd, side, yaw, 0.0)
    g = rng.generator(dev, seed, "scan", variant)
    tgt = street.scan(boxes, P0, p, g)
    src = street.scan(boxes, P1, p, g)
    true = torch.linalg.inv(P0) @ P1
    err = street.pose(*(h.uniform(-1, 1, 3) * p["init_error"]), 0.0)
    return src, tgt, true.numpy(), (true @ err).numpy().astype(np.float32)


def program_icp(src, tgt, tn, init, threshold, dev):
    s = ctt.geometry.PointCloud(src, device=dev)
    t = ctt.geometry.PointCloud(tgt, device=dev)
    t.normals = tn
    res = ctt.registration.registration_icp(
        s, t, threshold, init,
        ctt.registration.TransformationEstimationPointToPlane(),
        ctt.registration.ICPConvergenceCriteria())
    return np.asarray(res.transformation, np.float64), res.iterations


def port_normals(tgt, p, dev, brute=False):
    saved = ctt.knn._BRUTE_FORCE_LIMIT
    if brute:
        ctt.knn._BRUTE_FORCE_LIMIT = 1 << 40
    try:
        t = ctt.geometry.PointCloud(tgt, device=dev)
        t.estimate_normals(ctt.geometry.KDTreeSearchParamHybrid(
            p["normal_radius_m"], p["normal_max_nn"]))
        return torch.as_tensor(t.normals, device=dev)
    finally:
        ctt.knn._BRUTE_FORCE_LIMIT = saved


def weak_axis(src, tgt, tn, T, threshold):
    Td = torch.as_tensor(T, dtype=torch.float32, device=src.device)
    moved = src @ Td[:3, :3].T + Td[:3, 3]
    idx, _ = grid_nn.NearestIndex(tgt, threshold).nearest(moved)
    ok = idx >= 0
    n = tn[idx.clamp(min=0)].double()
    J = torch.cat([torch.linalg.cross(moved.double(), n, dim=-1), n], -1)
    J = J[ok]
    w, v = torch.linalg.eigh((J.T @ J).cpu())
    return {"ratio": float(w[0] / w[-1]),
            "least": [round(float(x), 4) for x in v[:, 0]]}


def reading(p, seed, variant, dev):
    thr = p["threshold_m"]
    src, tgt, true, init = pair(p, seed, variant, dev)
    out = {"seed": seed, "variant": variant, "points": [src.shape[0],
                                                        tgt.shape[0]]}
    t0 = time.perf_counter()
    n_port = port_normals(tgt, p, dev)
    n_ref = normals.estimate(tgt, p["normal_radius_m"], p["normal_max_nn"])
    n_brute = port_normals(tgt, p, dev, brute=True)
    out["normals_deg"] = angles_deg(n_port, n_ref)
    out["brute_normals_deg"] = angles_deg(n_brute, n_ref)
    out["parted"] = parted(tgt, n_port, n_ref, p)
    T_prog, it = program_icp(src, tgt, n_port, init, thr, dev)
    out["program_iterations"] = it
    T_ref = ref_icp.point_to_plane(src, tgt, n_ref, thr, init)[0].numpy()
    out["program"] = gaps(T_prog, T_ref)
    out["truth"] = gaps(T_ref, true)
    with working("bfloat16") as dtype:
        T_low = ref_icp.point_to_plane(src, tgt, n_ref, thr, init,
                                       dtype=dtype)[0].numpy()
    out["control"] = gaps(T_low, T_ref)
    out["weak"] = weak_axis(src, tgt, n_ref, T_ref, thr)
    if variant == "street":
        T_pr = program_icp(src, tgt, n_ref, init, thr, dev)[0]
        out["program_ref_normals"] = gaps(T_pr, T_ref)
        T_rp = ref_icp.point_to_plane(src, tgt, n_port, thr, init)[0]
        out["reference_port_normals"] = gaps(T_rp.numpy(), T_prog)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="street,blocks")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--beams", type=int, help="fewer beams, for a rehearsal")
    args = ap.parse_args(argv)
    mix = registry.traffic("street_scans")
    if args.beams:
        mix.update(beams=args.beams, azimuth_steps=args.beams * 32)
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variants.split(","):
            p = dict(mix, **mix["variants"][variant])
            print(json.dumps(reading(p, seed, variant, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
