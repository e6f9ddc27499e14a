"""Hybrid RGB-D odometry, plain PyTorch (cupoch ComputeRGBDOdometry
with RGBDOdometryJacobianFromHybridTerm and OdometryOption).

From the sensor's uint8 RGB and uint16 millimetre depth: intensities
(Gaussian-smoothed, scaled to a mean of 0.5 over the initial
correspondences) and depths in metres (0 beyond the depth cut-off, NaN
outside [min_depth, max_depth], Gaussian-smoothed), pyramids of 2x2
means (the intensities smoothed before each), then from the coarsest
level a fixed number of Gauss-Newton steps a level: each source pixel is
reprojected into the target, kept when its depth agrees within
max_depth_diff, and contributes a photometric row (weight 1 - 0.968)
and a geometric row (0.968); the 6x6 system is solved in float64 and
its Euler-angle update (R = Rz Ry Rx) composed on the left. A level
whose last system is singular fails the call. `dtype` is the working
type of the images and sums.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import image as im
from .icp import euler_update

SOBEL_SCALE = 0.125
LAMBDA_DEPTH = 0.968


def _correspondence(ds, dt, K, K_inv, T, max_diff):
    H, W = ds.shape
    uu, vv = im.pixel_grid(H, W, ds.device, ds.dtype)
    R, t = T[:3, :3], T[:3, 3]
    M = (K @ R) @ K_inv
    valid = torch.isfinite(ds)
    d0 = torch.where(valid, ds, 0.0)
    uvw = torch.stack([uu, vv, torch.ones_like(uu)], -1)
    proj = d0[..., None] * (uvw @ M.T) + K @ t
    z = proj[..., 2]
    zs = torch.where(z.abs() > 1e-8, z, 1.0)
    ut = torch.floor(proj[..., 0] / zs + 0.5).to(torch.int64)
    vt = torch.floor(proj[..., 1] / zs + 0.5).to(torch.int64)
    inb = (ut >= 0) & (ut < W) & (vt >= 0) & (vt < H) & valid & (z > 0)
    ut, vt = ut.clamp(0, W - 1), vt.clamp(0, H - 1)
    d_t = dt[vt, ut]
    ok = inb & torch.isfinite(d_t) & ((z - d_t).abs() <= max_diff)
    return ut, vt, ok


def _xyz(depth, K):
    H, W = depth.shape
    uu, vv = im.pixel_grid(H, W, depth.device, depth.dtype)
    d = torch.where(torch.isfinite(depth), depth, 0.0)
    return torch.stack([(uu - K[0, 2]) * d / K[0, 0],
                        (vv - K[1, 2]) * d / K[1, 1], d], -1)


def _step(sc, sd, tc, td, gx_c, gx_d, gy_c, gy_d, K, K_inv, T, max_diff):
    ut, vt, ok = _correspondence(sd, td, K, K_inv, T, max_diff)
    fx, fy = K[0, 0], K[1, 1]
    p = _xyz(sd, K) @ T[:3, :3].T + T[:3, 3]
    X, Y, Z = p[..., 0], p[..., 1], p[..., 2]
    invz = 1.0 / torch.where(Z.abs() > 1e-8, Z, 1.0)
    li, ld = math.sqrt(1.0 - LAMBDA_DEPTH), math.sqrt(LAMBDA_DEPTH)

    def rows(gx, gy):
        a = SOBEL_SCALE * gx[vt, ut] * fx * invz
        b = SOBEL_SCALE * gy[vt, ut] * fy * invz
        c = -(a * X + b * Y) * invz
        return a, b, c

    a, b, c = rows(gx_c, gy_c)
    Jp = li * torch.stack([-Z * b + Y * c, Z * a - X * c, -Y * a + X * b,
                           a, b, c], -1)
    rp = li * (tc[vt, ut] - sc)
    gxd = torch.nan_to_num(gx_d, nan=0.0)
    gyd = torch.nan_to_num(gy_d, nan=0.0)
    a, b, c = rows(gxd, gyd)
    Jg = ld * torch.stack([(-Z * b + Y * c) - Y, (Z * a - X * c) + X,
                           -Y * a + X * b, a, b, c - 1.0], -1)
    rg = ld * (td[vt, ut] - Z)
    m = ok[..., None]
    J = torch.cat([torch.where(m, Jp, 0.0).reshape(-1, 6),
                   torch.where(m, Jg, 0.0).reshape(-1, 6)])
    r = torch.cat([torch.where(ok, rp, 0.0).reshape(-1),
                   torch.where(ok, rg, 0.0).reshape(-1)])
    JTJ = (J.T @ J).double().cpu()
    JTr = (J.T @ r).double().cpu()
    try:
        x = torch.linalg.solve(JTJ, -JTr)
        solved = bool(torch.isfinite(x).all()) \
            and abs(float(torch.linalg.det(JTJ))) > 1e-12
    except RuntimeError:
        solved = False
    if not solved:
        return T, False
    return (euler_update(x).to(T.device, T.dtype) @ T), True


def odometry(src_rgb, src_mm, tgt_rgb, tgt_mm, K, option: dict,
             depth_scale=1000.0, depth_trunc=3.0, dtype=torch.float32):
    """(success, 4x4 motion float64 numpy) from the source frame to the
    target frame, from the identity."""
    dev = src_rgb.device

    def depth(mm):
        d = mm.to(torch.int32).to(dtype) / depth_scale
        d = torch.where(d > depth_trunc, 0.0, d)
        bad = (d < option["min_depth"]) | (d > option["max_depth"]) \
            | (d <= 0)
        return im.gauss3(torch.where(bad, math.nan, d))

    sc, tc = im.gauss3(im.intensity(src_rgb, dtype)), \
        im.gauss3(im.intensity(tgt_rgb, dtype))
    sd, td = depth(src_mm), depth(tgt_mm)
    K0 = torch.as_tensor(np.asarray(K, np.float32))
    Kd, Kinv = K0.to(dev, dtype), torch.linalg.inv(K0).to(dev, dtype)
    T = torch.eye(4, dtype=dtype, device=dev)
    max_diff = option["max_depth_diff"]
    ut, vt, ok = _correspondence(sd, td, Kd, Kinv, T, max_diff)
    w = ok.to(dtype)
    n = w.sum().clamp(min=1.0)
    sc = sc * (0.5 / ((w * sc).sum() / n).clamp(min=1e-12))
    tc = tc * (0.5 / ((w * tc[vt, ut]).sum() / n).clamp(min=1e-12))
    iters = option["iteration_number_per_pyramid_level"]
    levels = len(iters)
    pyr = [[x] for x in (sc, sd, tc, td)]
    for _ in range(1, levels):
        for p, smooth in zip(pyr, (True, False, True, False)):
            p.append(im.down2(im.gauss3(p[-1]) if smooth else p[-1]))
    for level in range(levels - 1, -1, -1):
        Kl = K0.clone()
        Kl[:2] *= 0.5 ** level
        Kl, Kl_inv = Kl.to(dev, dtype), torch.linalg.inv(Kl).to(dev, dtype)
        s_c, s_d, t_c, t_d = (p[level] for p in pyr)
        grads = (im.sobel_dx(t_c), im.sobel_dx(t_d), im.sobel_dy(t_c),
                 im.sobel_dy(t_d))
        solved = True
        for _ in range(iters[levels - level - 1]):
            T, solved = _step(s_c, s_d, t_c, t_d, *grads, Kl, Kl_inv, T,
                              max_diff)
        if not solved:
            return False, np.eye(4)
    return True, T.double().cpu().numpy()
