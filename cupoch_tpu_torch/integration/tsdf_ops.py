"""TSDF functions over dense [R, R, R] grids (cupoch
integration/integrate_functor.h, uniform_tsdfvolume.cu).

- `integrate`: the projective update of every voxel, in slabs along x
  so the temporaries of a 512^3 grid stay small; each voxel's update is
  independent of the others, so the result is that of one pass.
  `integrate_blocks` makes the same update over the 16^3 blocks of a
  block table, in chunks.
- `surface_crossings`: the zero crossings between neighbouring voxels.
- `raycast`: a march of nearest-voxel samples for every pixel, then a
  trilinear refinement of the crossing, normals and colours; on the
  card one thread a ray in the hand-written kernel
  `csrc/tsdf_raycast.cu`, on the CPU `raycast_plain`.
- `mc_classify_blocks`, `mc_compact`, `mc_emit_blocks`: marching cubes
  on the device at a fixed capacity.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from ..utility import nvcc, trace
from . import marching_cubes_tables as mct

#: voxels a slab of `integrate` holds at most (its temporaries are a few
#: tensors of this many elements)
SLAB_VOXELS = 1 << 23
#: the plain raycast tests whether every ray has stopped once every this
#: many steps (one host read each time)
STOP_CHECK_STEPS = 16
#: the raycast refines a crossing up to this many steps past the step
#: where the march found it
REFINE_STEPS = 4

#: `raycast` kernel launches since the count was last set to 0
launches = 0


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c of float32 tensors rounded once, as a fused
    multiply-add: the product is exact in float64 and the sum rounds
    there first (a second rounding that changes the float32 result only
    at a tie of 2^-29 odds)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _muladd(a, b, c) -> torch.Tensor:
    return a * b + c


def _update(pc, ts, w, cv, depth, color_img, multiplier, K, sdf_trunc,
            muladd):
    """The projective update of voxels whose camera-frame centres are pc
    [..., 3] and whose tsdf, weight and colour are ts, w [...] and cv
    [..., 3] (None without colour): each centre takes the depth of the
    pixel it rounds to; a voxel in the image with a positive depth and
    sdf > -sdf_trunc averages in min(1, sdf / sdf_trunc), and its
    colour. `muladd(a, b, c)` forms the running averages' a * b + c:
    `integrate` rounds the product and the sum apart (`_muladd`), which
    keeps a 512^3 grid's temporaries in float32 (fused, chip_smoke.py
    phase 4k's update took 47 ms a frame for 35 on an H100);
    `integrate_blocks` rounds once
    (`_fma`), as the JAX package's compiled scalable update does and as
    its 1e-6 parity needs. Returns (ts, w, cv) updated."""
    H, W = depth.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = pc[..., 2]
    safe_z = torch.where(z > 1e-8, z, 1.0)
    # +0.5 then truncation: the nearest pixel (integrate_functor.h)
    u_f = pc[..., 0] * fx / safe_z + cx + 0.5
    v_f = pc[..., 1] * fy / safe_z + cy + 0.5
    in_img = ((u_f >= 1e-4) & (u_f < W - 1e-4) & (v_f >= 1e-4)
              & (v_f < H - 1e-4) & (z > 0))
    u = u_f.to(torch.int64).clamp(0, W - 1)
    v = v_f.to(torch.int64).clamp(0, H - 1)
    pix = v * W + u
    d = depth.reshape(-1)[pix]
    sdf = (d - z) * multiplier.reshape(-1)[pix]
    update = in_img & (d > 0.0) & (sdf > -sdf_trunc)
    tsdf_new = torch.clamp(sdf / sdf_trunc, max=1.0)
    w1 = w + 1.0
    if cv is not None:
        color_f = color_img.reshape(-1, color_img.shape[-1])
        c_new = muladd(cv, w[..., None], color_f[pix]) / w1[..., None]
        cv = torch.where(update[..., None], c_new, cv)
    return (torch.where(update, muladd(ts, w, tsdf_new) / w1, ts),
            torch.where(update, w1, w), cv)


def integrate(tsdf, weight, color_vol, depth, color_img, multiplier, K,
              extrinsic, voxel_length, sdf_trunc, origin,
              color_channels: int):
    """One projective TSDF update (`_update`, cupoch
    integrate_functor.h), in place, of every voxel of a dense grid, its
    centres put into the camera of the world-to-camera `extrinsic`.

    tsdf, weight [R, R, R]; color_vol [R, R, R, 3]; depth [H, W] metres
    (0 invalid); color_img [H, W, 3]; multiplier [H, W] (z-depth to ray
    distance); K [3, 3], extrinsic [4, 4], origin [3] (the grid's min
    corner) f32 tensors on the grid's device. Returns (tsdf, weight,
    color_vol)."""
    dev = tsdf.device
    R = tsdf.shape[0]
    vl = _f32(voxel_length, dev)
    trunc = _f32(sdf_trunc, dev)
    Rot, t = extrinsic[:3, :3], extrinsic[:3, 3]
    idx = torch.arange(R, dtype=torch.float32, device=dev)
    centre = idx[:, None] * vl + 0.5 * vl + origin        # [R, 3]
    yz = (centre[None, :, None, 1:2], centre[None, None, :, 2:3])
    slab = max(1, SLAB_VOXELS // (R * R))
    for x0 in range(0, R, slab):
        x1 = min(R, x0 + slab)
        px = centre[x0:x1, None, None, 0:1]
        # camera-frame centres [S, R, R, 3]: R p + t, summed over p's axes
        pc = (px * Rot[:, 0] + yz[0] * Rot[:, 1]) + yz[1] * Rot[:, 2] + t
        cv = color_vol[x0:x1] if color_channels > 0 else None
        ts, w, cv_new = _update(pc, tsdf[x0:x1], weight[x0:x1], cv, depth,
                                color_img, multiplier, K, trunc, _muladd)
        if cv is not None:
            cv.copy_(cv_new)
        tsdf[x0:x1] = ts
        weight[x0:x1] = w
    return tsdf, weight, color_vol


def integrate_blocks(tsdf, weight, color_vol, slots, block_origins, depth,
                     color_img, multiplier, K, extrinsic, voxel_length,
                     sdf_trunc, color_channels: int):
    """`_update` of the [16, 16, 16] blocks `slots` [B] of block tables
    tsdf and weight [cap, 16, 16, 16] and color_vol [cap, 16, 16, 16, 3],
    whose min corners are block_origins [B, 3], in place (cupoch
    scalable_tsdfvolume.cu, integrate_functor.h): each chunk of blocks is
    gathered, updated and written back, at most SLAB_VOXELS voxels at a
    time."""
    dev = tsdf.device
    S = tsdf.shape[1]
    vl = _f32(voxel_length, dev)
    trunc = _f32(sdf_trunc, dev)
    Rot, t = extrinsic[:3, :3], extrinsic[:3, 3]
    local = _fma(torch.arange(S, dtype=torch.float32, device=dev), vl,
                 0.5 * vl)
    chunk = max(1, SLAB_VOXELS // (S * S * S))
    for b0 in range(0, slots.shape[0], chunk):
        sl = slots[b0:b0 + chunk]
        o = block_origins[b0:b0 + chunk]
        px = (o[:, None, 0] + local)[:, :, None, None, None]
        py = (o[:, None, 1] + local)[:, None, :, None, None]
        pz = (o[:, None, 2] + local)[:, None, None, :, None]
        # camera-frame centres [B, S, S, S, 3]: R p + t, the product's
        # terms accumulated as fused multiply-adds
        pc = _fma(pz, Rot[:, 2], _fma(py, Rot[:, 1], px * Rot[:, 0])) + t
        cv = color_vol.index_select(0, sl) if color_channels > 0 else None
        ts, w, cv = _update(pc, tsdf.index_select(0, sl),
                            weight.index_select(0, sl), cv, depth,
                            color_img, multiplier, K, trunc, _fma)
        if cv is not None:
            color_vol.index_copy_(0, sl, cv)
        tsdf.index_copy_(0, sl, ts)
        weight.index_copy_(0, sl, w)
    return tsdf, weight, color_vol


def surface_crossings(tsdf, weight) -> torch.Tensor:
    """Zero-crossing mask [R, R, R, 3] per (voxel, axis) (cupoch
    extract_pointcloud_functor): both voxels observed, |f| < 0.98 at the
    base voxel, a sign change to the next voxel along the axis, which
    must exist."""
    R = tsdf.shape[0]
    valid = (weight > 0.0) & (tsdf.abs() < 0.98)
    masks = []
    for axis in range(3):
        fn = torch.roll(tsdf, -1, axis)
        wn = torch.roll(weight, -1, axis)
        shape = [1, 1, 1]
        shape[axis] = R
        has_nbr = (torch.arange(R, device=tsdf.device) < R - 1) \
            .reshape(shape)
        masks.append(valid & (wn > 0.0) & has_nbr & (tsdf * fn < 0.0))
    return torch.stack(masks, -1)


def crossing_fraction(tsdf, ii, jj, kk, axis) -> torch.Tensor:
    """f / (f - f_next) at voxels (ii, jj, kk) towards their next voxel
    along `axis` (wrapping, as a roll does)."""
    R = tsdf.shape[0]
    f = tsdf[ii, jj, kk]
    nxt = [ii, jj, kk]
    for a in range(3):
        nxt[a] = torch.where(axis == a, (nxt[a] + 1) % R, nxt[a])
    d = f - tsdf[nxt[0], nxt[1], nxt[2]]
    return f / torch.where(d.abs() > 1e-12, d, 1.0)


def central_gradient(tsdf, ii, jj, kk) -> torch.Tensor:
    """(f[i + 1] - f[i - 1]) / 2 along each axis at voxels (ii, jj, kk),
    wrapping at the faces (as a roll does), [N, 3]."""
    R = tsdf.shape[0]
    cols = []
    for a in range(3):
        p, m = [ii, jj, kk], [ii, jj, kk]
        p[a] = (p[a] + 1) % R
        m[a] = (m[a] - 1) % R
        cols.append((tsdf[p[0], p[1], p[2]] - tsdf[m[0], m[1], m[2]]) * 0.5)
    return torch.stack(cols, -1)


def _gather3(vol, gi) -> torch.Tensor:
    """vol[gi[..., 0], gi[..., 1], gi[..., 2]] for in-range indices."""
    R = vol.shape[0]
    flat = (gi[..., 0] * R + gi[..., 1]) * R + gi[..., 2]
    return vol.reshape((R * R * R,) + vol.shape[3:])[flat]


def march_steps(slowest: int, max_steps: int) -> int:
    """The steps the plain march reports when its slowest ray stops
    after `slowest` steps (max_steps + 1 where one never stops): it
    tests every STOP_CHECK_STEPS steps whether every ray has stopped,
    and ends at max_steps at the latest. An empty image stops at the
    first test."""
    checks = max(1, -(-slowest // STOP_CHECK_STEPS))
    return min(max_steps, STOP_CHECK_STEPS * checks)


def _rays(K, cam_to_world, voxel_length, sdf_trunc, origin, R: int,
          H: int, W: int):
    """Each pixel's ray, shared by both raycasts: (dirs [H, W, 3] unit
    world directions, the camera centre o [3], rel_o = o - origin, the
    voxel length vl, 1 / vl, each ray's exit time t_far and first sample
    time ray0 [H, W], the step sdf_trunc / 2), scalars as 0-d tensors on
    the grid's device."""
    dev = K.device
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    dirs_cam = torch.stack([(uu - cx) / fx, (vv - cy) / fy,
                            torch.ones_like(uu)], -1)
    dirs_cam = dirs_cam / torch.linalg.norm(dirs_cam, dim=-1, keepdim=True)
    dirs = dirs_cam @ cam_to_world[:3, :3].T
    o = cam_to_world[:3, 3]
    vl = _f32(voxel_length, dev)
    inv_vl = 1.0 / vl
    L = R * vl
    rel_o = o - origin

    # each ray's entry and exit times of the box [0, L]^3 (cupoch
    # GetMinTime / GetMaxTime)
    safe_d = torch.where(dirs.abs() > 1e-12, dirs, 1e-12)
    t_a = (0.0 - rel_o) / safe_d
    t_b = (L - rel_o) / safe_d
    t_near = torch.minimum(t_a, t_b).amax(-1)
    t_far = torch.maximum(t_a, t_b).amin(-1)
    ray0 = t_near.clamp(min=0.0) + vl
    step = _f32(sdf_trunc, dev) * 0.5
    return dirs, o, rel_o, vl, inv_vl, t_far, ray0, step


def _finish(pts, n, colors, found):
    """The rays' outputs as both raycasts return them: the gradient n
    normalised, NaN where there is no hit, [H*W, 3] each."""
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
    keep = found[..., None]
    return (torch.where(keep, pts, math.nan).reshape(-1, 3),
            torch.where(keep, n, math.nan).reshape(-1, 3),
            torch.where(keep, colors, math.nan).reshape(-1, 3))


def raycast(tsdf, weight, color_vol, K, cam_to_world, voxel_length,
            sdf_trunc, origin, H: int, W: int, max_steps: int):
    """The model seen from `cam_to_world` (cupoch raycast_tsdf_functor),
    as `raycast_plain` computes it, bit for bit. On CUDA tensors each
    ray's march and refinement run in the hand-written kernel
    `csrc/tsdf_raycast.cu` (counted in `launches`), one thread a ray,
    and the only read is the slowest ray's steps; on CPU tensors this is
    `raycast_plain`. A CUDA tensor launches the kernel or raises: there
    is no fallback. The steps are `march_steps` of the slowest ray's,
    what the plain march reports; counted in `tsdf.march_steps` (the
    kernel makes no stop tests). Returns ([H*W, 3] points, normals,
    colours), NaN where there is no hit, and the steps."""
    dev = tsdf.device
    if dev.type == "cpu":
        return raycast_plain(tsdf, weight, color_vol, K, cam_to_world,
                             voxel_length, sdf_trunc, origin, H, W,
                             max_steps)
    if dev.type != "cuda":
        raise ValueError(f"raycast runs on cuda or cpu, not {dev}")
    R = tsdf.shape[0]
    for name, t, shape in (("tsdf", tsdf, (R, R, R)),
                           ("weight", weight, (R, R, R)),
                           ("color_vol", color_vol, (R, R, R, 3))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"raycast takes a contiguous float32 {name} "
                             f"of shape {shape} on {dev}, not "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t, shape in (("K", K, (3, 3)),
                           ("cam_to_world", cam_to_world, (4, 4)),
                           ("origin", origin, (3,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != dev:
            raise ValueError(f"raycast takes a float32 {name} of shape "
                             f"{shape} on {dev}")
    if not (3 <= R and R ** 3 < 1 << 31 and 0 <= max_steps < 1 << 24
            and H >= 0 and W >= 0 and REFINE_STEPS >= 1):
        raise ValueError(f"raycast takes 3 <= R < 1291, 0 <= max_steps < "
                         f"2^24 and REFINE_STEPS >= 1, not R {R}, max_steps "
                         f"{max_steps}, REFINE_STEPS {REFINE_STEPS}")
    rays = _rays(K, cam_to_world, voxel_length, sdf_trunc, origin, R, H, W)
    pts, n, colors, found, slowest = _launch(tsdf, weight, color_vol, rays,
                                             origin, max_steps)
    steps = march_steps(int(trace.to_host(slowest)[0]), max_steps)
    trace.count("tsdf.march_steps", steps)
    return _finish(pts, n, colors, found) + (steps,)


def _launch(tsdf, weight, color_vol, rays, origin, max_steps: int):
    """One launch of the kernel on checked CUDA tensors and the rays of
    `_rays`: (points, unnormalised gradients, colours [H, W, 3], hit
    flags [H, W], and the slowest ray's steps [1] int32 on the card)."""
    global launches
    dirs, o, rel_o, vl, inv_vl, t_far, ray0, step = rays
    dev = tsdf.device
    R = tsdf.shape[0]
    H, W = ray0.shape
    params = torch.cat([o, origin, rel_o, torch.stack([vl, inv_vl, step])])
    dirs, t_far, ray0 = (t.contiguous() for t in (dirs, t_far, ray0))
    pts = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    n = torch.empty_like(pts)
    colors = torch.empty_like(pts)
    found = torch.empty((H, W), dtype=torch.bool, device=dev)
    slowest = torch.empty(1, dtype=torch.int32, device=dev)
    lib = nvcc.load("tsdf_raycast")
    fn = lib.tsdf_raycast_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tsdf.data_ptr(), weight.data_ptr(), color_vol.data_ptr(),
                 dirs.data_ptr(), ray0.data_ptr(), t_far.data_ptr(),
                 params.data_ptr(), pts.data_ptr(), n.data_ptr(),
                 colors.data_ptr(), found.data_ptr(), slowest.data_ptr(),
                 H, W, R, max_steps, REFINE_STEPS, stream)
    if err != 0:
        raise RuntimeError(f"tsdf_raycast launch failed: CUDA error {err}")
    launches += 1
    return pts, n, colors, found, slowest


def raycast_plain(tsdf, weight, color_vol, K, cam_to_world, voxel_length,
                  sdf_trunc, origin, H: int, W: int, max_steps: int):
    """Plain PyTorch version of `raycast`'s kernel, on any device: one
    nearest-voxel sample a step of sdf_trunc / 2 from each ray's entry
    into the grid, stopping a ray at a +/- crossing (a hit), a -/+
    crossing (a back face) or its exit; unobserved voxels hold 0 and
    never cross. A hit's crossing is then refined between trilinear
    samples that must see observed voxels only; its normal is the
    trilinear gradient and its colour the nearest voxel's. The march
    ends after `max_steps`, or earlier once every ray has stopped
    (tested every STOP_CHECK_STEPS steps: a stopped ray's hit and
    crossing never change; counted in `tsdf.stop_checks`, the steps in
    `tsdf.march_steps`). Returns ([H*W, 3] points, normals, colours),
    NaN where there is no hit, and the steps the march took."""
    dev = tsdf.device
    R = tsdf.shape[0]
    dirs, o, rel_o, vl, inv_vl, t_far, ray0, step = _rays(
        K, cam_to_world, voxel_length, sdf_trunc, origin, R, H, W)

    def nearest(p_rel):
        gi = torch.floor(p_rel * inv_vl).to(torch.int64)
        inb = ((gi >= 1) & (gi < R - 1)).all(-1)
        return _gather3(tsdf, gi.clamp(0, R - 1)), inb

    f, inb0 = nearest(rel_o + dirs * ray0[..., None])
    f = torch.where(inb0, f, 0.0)
    stopped = torch.zeros((H, W), dtype=torch.bool, device=dev)
    found = torch.zeros_like(stopped)
    t_lo = torch.zeros((H, W), dtype=torch.float32, device=dev)
    steps = max_steps
    for i in range(max_steps):
        ray_len = ray0 + float(i) * step
        f_new, inb = nearest(rel_o + dirs * (ray_len + step)[..., None])
        live_in = ~stopped & inb
        new_hit = live_in & (f > 0.0) & (f_new < 0.0)
        t_lo = torch.where(new_hit, ray_len, t_lo)
        found = found | new_hit
        # a back face stops the ray; an outside step skips the test and
        # keeps the last value (cupoch's `continue`)
        stopped = stopped | new_hit | (live_in & (f < 0.0) & (f_new > 0.0)) \
            | (ray_len >= t_far)
        f = torch.where(inb, f_new, f)
        if (i + 1) % STOP_CHECK_STEPS == 0:
            trace.count("tsdf.stop_checks")
            if bool(trace.to_host(stopped.all())):
                steps = i + 1
                break
    trace.count("tsdf.march_steps", steps)

    def trilinear_obs(p):
        """Trilinear tsdf at world points p and whether all 8 corners
        are observed (a stencil that mixes unobserved tsdf = 0 corners
        drags the zero off the surface)."""
        g = (p - origin) * inv_vl - 0.5
        g0 = torch.floor(g)
        r = g - g0
        gi = g0.to(torch.int64).clamp(0, R - 2)
        val = torch.zeros(p.shape[:-1], dtype=torch.float32, device=dev)
        wmin = torch.full(p.shape[:-1], math.inf, dtype=torch.float32,
                          device=dev)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    wx = r[..., 0] if dx else 1.0 - r[..., 0]
                    wy = r[..., 1] if dy else 1.0 - r[..., 1]
                    wz = r[..., 2] if dz else 1.0 - r[..., 2]
                    corner = gi + torch.tensor([dx, dy, dz], device=dev)
                    val = val + wx * wy * wz * _gather3(tsdf, corner)
                    wmin = torch.minimum(wmin, _gather3(weight, corner))
        return val, wmin > 0.0

    # the smooth field's zero may lie outside the nearest-value bracket
    # [t_lo, t_lo + step]: half a voxel's diagonal off the surface, which
    # along a grazing ray is several steps. Samples at t_lo + k step,
    # k = -1 .. REFINE_STEPS, and the first segment with a +/- change
    # is interpolated (the reference samples k = -1 .. 1 and misses a
    # zero past t_lo + step; where it finds one, so does this)
    samples = [trilinear_obs(o + dirs * (t_lo + k * step)[..., None])
               for k in range(-1, REFINE_STEPS + 1)]
    seg_t, flo, fhi = t_lo, samples[1][0], samples[2][0]
    seg_obs = samples[1][1] & samples[2][1]
    chosen = torch.zeros_like(found)
    for k in range(-1, REFINE_STEPS):
        (fa, oa), (fb, ob) = samples[k + 1], samples[k + 2]
        take = ~chosen & (fa > 0.0) & (fb <= 0.0)
        seg_t = torch.where(take, t_lo + k * step, seg_t)
        flo = torch.where(take, fa, flo)
        fhi = torch.where(take, fb, fhi)
        seg_obs = torch.where(take, oa & ob, seg_obs)
        chosen = chosen | take
    good = (flo > 0.0) & (fhi < 0.0) & ((flo - fhi).abs() > 1e-12)
    t_star = torch.where(
        good, seg_t + step * flo / torch.where(good, flo - fhi, 1.0),
        t_lo + 0.5 * step)
    found = found & good & seg_obs
    pts = o + dirs * t_star[..., None]

    n = []
    for a in range(3):
        e = torch.zeros(3, dtype=torch.float32, device=dev)
        e[a] = vl
        n.append(trilinear_obs(pts + e)[0] - trilinear_obs(pts - e)[0])
    n = torch.stack(n, -1)

    g = ((pts - origin) * inv_vl - 0.5).to(torch.int64).clamp(0, R - 1)
    colors = _gather3(color_vol, g)
    return _finish(pts, n, colors, found) + (steps,)


def mc_classify_blocks(fields, weights, side: int) -> torch.Tensor:
    """Marching-cubes case of every cell of [B, S, S, S] fields (S =
    side), [B, S-1, S-1, S-1] int32 (cupoch ExtractTriangleMesh's first
    pass): corner k sets bit k where tsdf < 0; a cell with an unobserved
    corner is case 0."""
    C = side - 1
    idx = torch.zeros(fields.shape[:1] + (C, C, C), dtype=torch.int32,
                      device=fields.device)
    observed = torch.ones(idx.shape, dtype=torch.bool, device=fields.device)
    for k, (dx, dy, dz) in enumerate(mct.CORNERS):
        fc = fields[:, dx: dx + C, dy: dy + C, dz: dz + C]
        wc = weights[:, dx: dx + C, dy: dy + C, dz: dz + C]
        idx |= (fc < 0.0).to(torch.int32) << k
        observed &= wc > 0.0
    return idx.masked_fill_(~observed, 0)


def mc_classify(tsdf, weight) -> torch.Tensor:
    """`mc_classify_blocks` of one [R, R, R] grid: [R-1, R-1, R-1]."""
    return mc_classify_blocks(tsdf[None], weight[None], tsdf.shape[0])[0]


def mc_compact(cases_flat, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat ids of the cells with a case other than 0 and 255, padded
    with -1 (or cut) to `cap`, and their count."""
    active = (cases_flat != 0) & (cases_flat != 255)
    ids = torch.nonzero(active)[:cap, 0]
    pad = torch.full((cap - ids.shape[0],), -1, dtype=ids.dtype,
                     device=ids.device)
    return torch.cat([ids, pad]), active.sum()


_EV = mct.EDGE_VERTS
_EDGE_A = mct.CORNERS[_EV[:, 0]]
_EDGE_B = mct.CORNERS[_EV[:, 1]]
# each edge's lower corner and axis: a vertex's exact integer identity
_EDGE_LOWER = np.minimum(_EDGE_A, _EDGE_B)
_EDGE_AXIS = np.argmax(np.abs(_EDGE_B - _EDGE_A), -1)


def mc_emit_blocks(fields, colors, cases_flat, cell_ids, block_origins,
                   block_keys, voxel_length, side: int,
                   color_channels: int):
    """Vertices of the compacted cells of [B, S, S, S] fields.

    cell_ids [cap] are flat ids into [B, (S-1)^3] (-1 pads);
    block_origins [B, 3] f32 and block_keys [B, 3] int (a global voxel
    is block_key * (S-1) + the local one). Each vertex carries the exact
    integer identity of its edge (global lower corner and axis), so the
    weld is free of float rounding. Returns (verts [cap, 15, 3], cols
    [cap, 15, 3], ekeys [cap, 15, 4] int32, tri_valid [cap, 5])."""
    dev = fields.device
    C = side - 1
    ok = cell_ids >= 0
    ids = cell_ids.clamp(min=0)
    b = ids // (C * C * C)
    r = ids % (C * C * C)
    ci, cj, ck = r // (C * C), (r // C) % C, r % C
    cases = cases_flat[ids].long()

    corner_f, corner_c = [], []
    for dx, dy, dz in mct.CORNERS:
        corner_f.append(fields[b, ci + dx, cj + dy, ck + dz])
        if color_channels:
            corner_c.append(colors[b, ci + dx, cj + dy, ck + dz])
        else:
            corner_c.append(torch.zeros(ids.shape + (3,),
                                        dtype=torch.float32, device=dev))
    corner_f = torch.stack(corner_f, -1)                   # [cap, 8]
    corner_c = torch.stack(corner_c, 1)                    # [cap, 8, 3]

    ev = torch.as_tensor(_EV, device=dev).long()
    fa, fb = corner_f[:, ev[:, 0]], corner_f[:, ev[:, 1]]  # [cap, 12]
    denom = torch.where((fb - fa).abs() > 1e-12, fb - fa, 1.0)
    t = (-fa / denom).clamp(0.0, 1.0)
    pa = torch.as_tensor(_EDGE_A, dtype=torch.float32, device=dev)
    pb = torch.as_tensor(_EDGE_B, dtype=torch.float32, device=dev)
    cell = torch.stack([ci, cj, ck], -1)
    edge_pts = cell.to(torch.float32)[:, None, :] + pa[None] \
        + t[..., None] * (pb - pa)[None]
    edge_pts = (edge_pts + 0.5) * _f32(voxel_length, dev) \
        + block_origins[b][:, None, :]                     # [cap, 12, 3]
    ca, cb = corner_c[:, ev[:, 0]], corner_c[:, ev[:, 1]]
    edge_cols = ca + t[..., None] * (cb - ca)

    gcell = (block_keys[b] * C + cell).to(torch.int32)     # [cap, 3]
    ekeys12 = torch.cat([
        gcell[:, None, :] + torch.as_tensor(_EDGE_LOWER, dtype=torch.int32,
                                            device=dev)[None],
        torch.as_tensor(_EDGE_AXIS, dtype=torch.int32, device=dev)[None, :,
                                                                   None]
        .expand(ids.shape[0], 12, 1)], -1)                 # [cap, 12, 4]

    tri_edges = torch.as_tensor(mct.TRI_TABLE, device=dev)[cases]
    ntris = torch.as_tensor(mct.NUM_TRIS, device=dev)[cases]
    e = tri_edges[:, :15].clamp(min=0).long()              # [cap, 15]
    verts = torch.gather(edge_pts, 1, e[..., None].expand(-1, -1, 3))
    cols = torch.gather(edge_cols, 1, e[..., None].expand(-1, -1, 3))
    ekeys = torch.gather(ekeys12, 1, e[..., None].expand(-1, -1, 4))
    tri_valid = ok[:, None] & (torch.arange(5, device=dev)[None, :]
                               < ntris[:, None])
    return verts, cols, ekeys, tri_valid
