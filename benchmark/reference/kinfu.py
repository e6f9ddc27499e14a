"""KinectFusion, plain PyTorch (cupoch KinfuPipeline::ProcessFrame with
KinfuOption, kinfu.cpp / uniform_tsdfvolume.cu).

A frame: the depth in metres (uint16 mm / depth_scale, 0 beyond
depth_trunc), a pyramid of 2x2 means, each level bilateral-filtered;
at each level the back-projected points (the pixels with a depth in
(0, depth_cutoff]) and their image-gradient normals; from the second
frame on, coarse-to-fine point-to-plane ICP of each level's points onto
the model's raycast of that level (`icp.point_to_plane`, exact nearest
neighbours from `grid_nn`), from the last pose; then the projective
TSDF update of every voxel from level 0's depth, and a raycast of the
volume at every level from the new pose. The volume is centred on
`tsdf_origin` (cupoch offsets every index by half the resolution).

Departures from cupoch, each the port's:
- the raycast refines a crossing with trilinear samples up to
  `REFINE_STEPS` steps past the step where the march found it (cupoch
  samples one step either side and loses pixels where the trilinear
  zero lies further on);
- the march tests whether every ray has stopped every `STOP_CHECK`
  steps and ends then (a stopped ray never changes);
- the volume keeps no colour: no compared number reads it, and
  point-to-plane ICP reads no colour.
`dtype` is the working type of ICP (points, normals and sums): float32
as the configuration states, or a lower one for the control; the
images, the volume and the raycast stay in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import icp

STOP_CHECK = 16
REFINE_STEPS = 4
SLAB_VOXELS = 1 << 23


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _grid(H, W, dev):
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    return u, v


def bilateral(depth, diameter: int, sigma_depth, sigma_space):
    """cupoch's bilateral filter over a (2r+1)^2 edge-clamped window,
    r = diameter // 2 (the identity below a diameter of 2)."""
    H, W = depth.shape
    r = diameter // 2
    dev = depth.device
    rows = torch.arange(-r, H + r, device=dev).clamp(0, H - 1)
    cols = torch.arange(-r, W + r, device=dev).clamp(0, W - 1)
    pad = depth[rows][:, cols]
    inv_c = 1.0 / (2.0 * _f32(sigma_depth, dev) ** 2)
    inv_s = 1.0 / (2.0 * _f32(sigma_space, dev) ** 2)
    acc = torch.zeros_like(depth)
    wsum = torch.zeros_like(depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = pad[dy + r: dy + r + H, dx + r: dx + r + W]
            diff = nb - depth
            w = torch.exp(-(diff * diff) * inv_c - (dy * dy + dx * dx) * inv_s)
            acc = acc + w * nb
            wsum = wsum + w
    return acc / wsum.clamp(min=1e-12)


def depth_pyramid(mm, cfg):
    """The filtered depth [H, W] in metres of each pyramid level."""
    o = cfg["kinfu"]
    d = mm.to(torch.float32) / _f32(cfg["depth_scale"], mm.device)
    d = torch.where(d > cfg["depth_trunc"], 0.0, d)
    levels = [d]
    for _ in range(1, o["num_pyramid_levels"]):
        p = levels[-1]
        H, W = p.shape[0] // 2, p.shape[1] // 2
        levels.append(p[:2 * H, :2 * W].reshape(H, 2, W, 2).mean(dim=(1, 3)))
    return [bilateral(x, o["diameter"], o["sigma_depth"], o["sigma_space"])
            for x in levels]


def camera(cfg, level: int):
    """(fx, fy, cx, cy, W, H) of pyramid level `level`."""
    c = cfg["camera"]
    f = 0.5 ** level
    return (c["fx"] * f, c["fy"] * f, c["cx"] * f, c["cy"] * f,
            int(round(c["width"] * f)), int(round(c["height"] * f)))


def cloud(depth, cam, cutoff):
    """(points [n, 3], normals [n, 3]) in the camera frame of the pixels
    with a depth in (0, cutoff], row by row; a normal is the cross
    product of the forward row and column differences ((0, 0, 1) where
    it vanishes)."""
    fx, fy, cx, cy = (_f32(x, depth.device) for x in cam[:4])
    d = torch.where(depth > cutoff, 0.0, depth)
    u, v = _grid(*d.shape, d.device)
    xyz = torch.stack([(u - cx) * d / fx, (v - cy) * d / fy, d], -1)
    dx = torch.diff(xyz, dim=1, append=xyz[:, -1:])
    dy = torch.diff(xyz, dim=0, append=xyz[-1:])
    n = torch.linalg.cross(dy, dx, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = torch.where(norm > 1e-12, n / norm.clamp(min=1e-12),
                    torch.tensor([0.0, 0.0, 1.0], device=d.device))
    ok = ((d > 0) & torch.isfinite(d)).reshape(-1)
    return xyz.reshape(-1, 3)[ok], n.reshape(-1, 3)[ok]


class Volume:
    """tsdf and weight [R, R, R] float32 over a cube of `length` centred
    on `origin`."""

    def __init__(self, cfg, device):
        o = cfg["kinfu"]
        self.R = o["tsdf_resolution"]
        self.length = float(o["tsdf_length"])
        self.vl = self.length / self.R
        self.trunc = o["sdf_trunc"]
        self.corner = (np.asarray(o["tsdf_origin"], np.float32)
                       - np.float32(0.5 * o["tsdf_length"]))
        self.dev = torch.device(device)
        R = self.R
        self.tsdf = torch.zeros((R, R, R), dtype=torch.float32,
                                device=self.dev)
        self.weight = torch.zeros_like(self.tsdf)

    def integrate(self, depth, cam, world_to_cam):
        """The projective update of every voxel from `depth` [H, W]."""
        dev, R = self.dev, self.R
        fx, fy, cx, cy = (_f32(x, dev) for x in cam[:4])
        H, W = depth.shape
        E = _f32(world_to_cam, dev)
        rot, t = E[:3, :3], E[:3, 3]
        vl = _f32(self.vl, dev)
        trunc = _f32(self.trunc, dev)
        u, v = _grid(H, W, dev)
        xx, yy = (u - cx) / fx, (v - cy) / fy
        mult = torch.sqrt(xx * xx + yy * yy + 1.0).reshape(-1)
        flat = depth.reshape(-1)
        idx = torch.arange(R, dtype=torch.float32, device=dev)
        centre = idx[:, None] * vl + 0.5 * vl + _f32(self.corner, dev)
        py = centre[None, :, None, 1:2]
        pz = centre[None, None, :, 2:3]
        step = max(1, SLAB_VOXELS // (R * R))
        for x0 in range(0, R, step):
            x1 = min(R, x0 + step)
            px = centre[x0:x1, None, None, 0:1]
            p = (px * rot[:, 0] + py * rot[:, 1]) + pz * rot[:, 2] + t
            z = p[..., 2]
            sz = torch.where(z > 1e-8, z, 1.0)
            uf = p[..., 0] * fx / sz + cx + 0.5
            vf = p[..., 1] * fy / sz + cy + 0.5
            inside = ((uf >= 1e-4) & (uf < W - 1e-4) & (vf >= 1e-4)
                      & (vf < H - 1e-4) & (z > 0))
            pix = (vf.to(torch.int64).clamp(0, H - 1) * W
                   + uf.to(torch.int64).clamp(0, W - 1))
            d = flat[pix]
            sdf = (d - z) * mult[pix]
            upd = inside & (d > 0.0) & (sdf > -trunc)
            ts, w = self.tsdf[x0:x1], self.weight[x0:x1]
            new = torch.clamp(sdf / trunc, max=1.0)
            w1 = w + 1.0
            self.tsdf[x0:x1] = torch.where(upd, (ts * w + new) / w1, ts)
            self.weight[x0:x1] = torch.where(upd, w1, w)

    def _at(self, vol, gi):
        R = self.R
        return vol.reshape(-1)[(gi[..., 0] * R + gi[..., 1]) * R + gi[..., 2]]

    def _trilinear(self, p):
        """(trilinear tsdf at world points p, all 8 corners observed)."""
        dev, R = self.dev, self.R
        g = (p - _f32(self.corner, dev)) * (1.0 / _f32(self.vl, dev)) - 0.5
        g0 = torch.floor(g)
        f = g - g0
        gi = g0.to(torch.int64).clamp(0, R - 2)
        val = torch.zeros(p.shape[:-1], dtype=torch.float32, device=dev)
        wmin = torch.full(p.shape[:-1], math.inf, dtype=torch.float32,
                          device=dev)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    c = gi + torch.tensor([dx, dy, dz], device=dev)
                    wx = f[..., 0] if dx else 1.0 - f[..., 0]
                    wy = f[..., 1] if dy else 1.0 - f[..., 1]
                    wz = f[..., 2] if dz else 1.0 - f[..., 2]
                    val = val + wx * wy * wz * self._at(self.tsdf, c)
                    wmin = torch.minimum(wmin, self._at(self.weight, c))
        return val, wmin > 0.0

    def raycast(self, cam, cam_to_world):
        """(points [n, 3], normals [n, 3]) in the world frame where the
        rays of `cam` from `cam_to_world` meet the surface, row by row:
        a march of nearest-voxel samples a step of sdf_trunc / 2 from
        each ray's entry into the cube, stopped at a +/- crossing (a
        hit), a -/+ crossing or the exit; the hit refined between
        trilinear samples of observed voxels; the normal the trilinear
        central difference."""
        dev, R = self.dev, self.R
        fx, fy, cx, cy = (_f32(x, dev) for x in cam[:4])
        W, H = cam[4], cam[5]
        P = _f32(cam_to_world, dev)
        u, v = _grid(H, W, dev)
        dc = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)],
                         -1)
        dc = dc / torch.linalg.norm(dc, dim=-1, keepdim=True)
        dirs = dc @ P[:3, :3].T
        o = P[:3, 3]
        vl = _f32(self.vl, dev)
        inv_vl = 1.0 / vl
        corner = _f32(self.corner, dev)
        rel = o - corner
        side = R * vl
        sd = torch.where(dirs.abs() > 1e-12, dirs, 1e-12)
        ta, tb = (0.0 - rel) / sd, (side - rel) / sd
        t_near = torch.minimum(ta, tb).amax(-1)
        t_far = torch.maximum(ta, tb).amin(-1)
        start = t_near.clamp(min=0.0) + vl
        step = _f32(self.trunc, dev) * 0.5
        max_steps = int(np.ceil(self.length * np.sqrt(3.0)
                                / (0.5 * self.trunc))) + 1

        def sample(t):
            gi = torch.floor((rel + dirs * t[..., None]) * inv_vl) \
                .to(torch.int64)
            inb = ((gi >= 1) & (gi < R - 1)).all(-1)
            return self._at(self.tsdf, gi.clamp(0, R - 1)), inb

        f, inb = sample(start)
        f = torch.where(inb, f, 0.0)
        stopped = torch.zeros((H, W), dtype=torch.bool, device=dev)
        hit = torch.zeros_like(stopped)
        t_lo = torch.zeros((H, W), dtype=torch.float32, device=dev)
        for i in range(max_steps):
            t = start + float(i) * step
            fn, inb = sample(t + step)
            live = ~stopped & inb
            new = live & (f > 0.0) & (fn < 0.0)
            t_lo = torch.where(new, t, t_lo)
            hit = hit | new
            stopped = stopped | new | (live & (f < 0.0) & (fn > 0.0)) \
                | (t >= t_far)
            f = torch.where(inb, fn, f)
            if (i + 1) % STOP_CHECK == 0 and bool(stopped.all()):
                break
        samples = [self._trilinear(o + dirs * (t_lo + k * step)[..., None])
                   for k in range(-1, REFINE_STEPS + 1)]
        seg, flo, fhi = t_lo, samples[1][0], samples[2][0]
        seen = samples[1][1] & samples[2][1]
        taken = torch.zeros_like(hit)
        for k in range(-1, REFINE_STEPS):
            (fa, oa), (fb, ob) = samples[k + 1], samples[k + 2]
            take = ~taken & (fa > 0.0) & (fb <= 0.0)
            seg = torch.where(take, t_lo + k * step, seg)
            flo = torch.where(take, fa, flo)
            fhi = torch.where(take, fb, fhi)
            seen = torch.where(take, oa & ob, seen)
            taken = taken | take
        good = (flo > 0.0) & (fhi < 0.0) & ((flo - fhi).abs() > 1e-12)
        t_hit = torch.where(good, seg + step * flo
                            / torch.where(good, flo - fhi, 1.0),
                            t_lo + 0.5 * step)
        hit = hit & good & seen
        pts = o + dirs * t_hit[..., None]
        n = []
        for a in range(3):
            e = torch.zeros(3, dtype=torch.float32, device=dev)
            e[a] = vl
            n.append(self._trilinear(pts + e)[0] - self._trilinear(pts - e)[0])
        n = torch.stack(n, -1)
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
        pts = torch.where(hit[..., None], pts, math.nan).reshape(-1, 3)
        n = torch.where(hit[..., None], n, math.nan).reshape(-1, 3)
        ok = torch.isfinite(pts).all(-1)
        return pts[ok], n[ok]


class KinFu:
    """The pipeline's state: the volume, the model pyramid and the
    camera-to-world pose (float32, the first camera's frame)."""

    def __init__(self, cfg, device, dtype=torch.float32):
        self.cfg = cfg
        self.o = cfg["kinfu"]
        self.dtype = dtype
        self.volume = Volume(cfg, device)
        self.model = [None] * self.o["num_pyramid_levels"]
        self.pose = np.eye(4, dtype=np.float32)
        self.frames = 0

    def track(self, levels) -> bool:
        o = self.o
        cur = self.pose
        for lv in range(o["num_pyramid_levels"] - 1, -1, -1):
            src, model = levels[lv], self.model[lv]
            if model is None or not len(src[0]) or not len(model[0]):
                continue
            T, _, _, _ = icp.point_to_plane(
                src[0], model[0], model[1], o["distance_threshold"], cur,
                max_iteration=o["icp_iterations"][lv], dtype=self.dtype)
            cur = T.numpy().astype(np.float32)
            if not np.isfinite(cur).all():
                return False
        self.pose = cur
        return True

    def process(self, mm) -> bool:
        """One frame of uint16 depth [H, W] in mm; False on a lost
        track."""
        o = self.o
        depths = depth_pyramid(mm, self.cfg)
        levels = [cloud(d, camera(self.cfg, i), o["depth_cutoff"])
                  for i, d in enumerate(depths)]
        if self.frames > 0 and not self.track(levels):
            return False
        world_to_cam = np.linalg.inv(self.pose).astype(np.float32)
        self.volume.integrate(depths[0], camera(self.cfg, 0), world_to_cam)
        cam_to_world = np.linalg.inv(world_to_cam).astype(np.float32)
        for i in range(o["num_pyramid_levels"]):
            self.model[i] = self.volume.raycast(camera(self.cfg, i),
                                                cam_to_world)
        self.frames += 1
        return True


def volume_gap(tsdf_a, weight_a, tsdf_b, weight_b, tol: float) -> float:
    """Share of the voxels observed by either volume whose weights
    differ or whose tsdf values differ by more than `tol`."""
    seen = (weight_a > 0) | (weight_b > 0)
    n = int(seen.sum())
    if n == 0:
        return 0.0
    differ = (weight_a != weight_b) | ((tsdf_a - tsdf_b).abs() > tol)
    return int((differ & seen).sum()) / n
