"""Scalable (block-hashed) TSDF volume (cupoch
integration/scalable_tsdfvolume.h): 16^3 voxel blocks allocated near
the observed depth.

The hash map is a host dict (block key -> slot, slots in insertion
order) beside block tables on one device, tsdf and weight [cap, 16, 16,
16] and colour [cap, 16, 16, 16, 3] f32, whose capacity doubles as
blocks are opened. A frame opens the blocks its sampled depth points
reach (host float64), culls the table to the blocks the camera can see
and updates those through `tsdf_ops.integrate_blocks`. Extraction
stitches each block with the faces, edges and corner of its forward
neighbours into [B, 17, 17, 17] fields on the device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..geometry import image_ops
from ..geometry.pointcloud import PointCloud
from ..geometry.trianglemesh import TriangleMesh
from ..utility.device import resolve_device
from . import tsdf_ops
from .tsdfvolume import TSDFVolume, TSDFVolumeColorType
from .uniform_tsdfvolume import mesh_from_mc_device

BLOCK = 16  # voxels a block side (cupoch VolumeUnit 16^3)

# the forward neighbours a block's stitched field reads: (offset, the
# index of the field it fills, the index of the neighbour it reads)
_ALL, _END, _FIRST = slice(None, BLOCK), BLOCK, 0
_STITCH = (
    ((0, 0, 0), (_ALL, _ALL, _ALL), (_ALL, _ALL, _ALL)),
    ((1, 0, 0), (_END, _ALL, _ALL), (_FIRST, _ALL, _ALL)),
    ((0, 1, 0), (_ALL, _END, _ALL), (_ALL, _FIRST, _ALL)),
    ((0, 0, 1), (_ALL, _ALL, _END), (_ALL, _ALL, _FIRST)),
    ((1, 1, 0), (_END, _END, _ALL), (_FIRST, _FIRST, _ALL)),
    ((1, 0, 1), (_END, _ALL, _END), (_FIRST, _ALL, _FIRST)),
    ((0, 1, 1), (_ALL, _END, _END), (_ALL, _FIRST, _FIRST)),
    ((1, 1, 1), (_END, _END, _END), (_FIRST, _FIRST, _FIRST)),
)


class ScalableTSDFVolume(TSDFVolume):
    """cupoch scalable_tsdfvolume.h:44-112, on `device` (None: the
    card)."""

    def __init__(self, voxel_length: float, sdf_trunc: float,
                 color_type: TSDFVolumeColorType = TSDFVolumeColorType.RGB8,
                 volume_unit_resolution: int = BLOCK,
                 depth_sampling_stride: int = 4,
                 initial_capacity: int = 1024, device=None):
        super().__init__(voxel_length, sdf_trunc, color_type)
        if volume_unit_resolution != BLOCK:
            raise ValueError("volume_unit_resolution must be 16")
        self.volume_unit_resolution = BLOCK
        self.volume_unit_length = voxel_length * BLOCK
        self.depth_sampling_stride = int(depth_sampling_stride)
        self.device = resolve_device(device)
        self._capacity = int(initial_capacity)
        self.reset()

    @classmethod
    def from_numpy(cls, slots, tsdf, weight, color, voxel_length: float,
                   sdf_trunc: float,
                   color_type: TSDFVolumeColorType = TSDFVolumeColorType.RGB8,
                   depth_sampling_stride: int = 4, device=None
                   ) -> "ScalableTSDFVolume":
        """A volume holding the given state: the block table `slots`
        ({(i, j, k): slot}, in the order the blocks were opened) and
        [cap, 16, 16, 16] tsdf and weight and [cap, 16, 16, 16, 3]
        colour, as another volume of this layout saved it (a JAX package
        volume's `_slots` and `np.asarray` of its arrays included)."""
        tsdf = np.asarray(tsdf, np.float32)
        vol = cls(voxel_length, sdf_trunc, color_type,
                  depth_sampling_stride=depth_sampling_stride,
                  initial_capacity=tsdf.shape[0], device=device)
        cap = vol._capacity
        block = (cap, BLOCK, BLOCK, BLOCK)
        for name, arr, shape in (("tsdf", tsdf, block),
                                 ("weight", weight, block),
                                 ("color", color, block + (3,))):
            a = np.array(arr, np.float32)
            if a.shape != shape:
                raise ValueError(f"{name} has shape {a.shape}, not {shape}")
            getattr(vol, name).copy_(torch.from_numpy(a))
        vol._slots = {tuple(int(c) for c in k): int(s)
                      for k, s in dict(slots).items()}
        if sorted(vol._slots.values()) != list(range(len(vol._slots))) \
                or len(vol._slots) > cap:
            raise ValueError("slots must number the blocks 0 .. n-1 "
                             "within the capacity")
        return vol

    def reset(self):
        B = self._capacity
        f32 = dict(dtype=torch.float32, device=self.device)
        self._slots: Dict[Tuple[int, int, int], int] = {}
        self.tsdf = torch.zeros((B, BLOCK, BLOCK, BLOCK), **f32)
        self.weight = torch.zeros((B, BLOCK, BLOCK, BLOCK), **f32)
        self.color = torch.zeros((B, BLOCK, BLOCK, BLOCK, 3), **f32)
        return self

    def __len__(self):
        return len(self._slots)

    @property
    def capacity(self) -> int:
        return self._capacity

    def _grow(self, needed: int):
        """Double the capacity until `needed` blocks fit; the new slots
        are zero (unobserved)."""
        while self._capacity < needed:
            self._capacity *= 2

        def pad(x):
            extra = self._capacity - x.shape[0]
            if extra <= 0:
                return x
            return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])], 0)

        self.tsdf = pad(self.tsdf)
        self.weight = pad(self.weight)
        self.color = pad(self.color)

    def _touched_blocks(self, depth_np, K, extrinsic) -> np.ndarray:
        """Keys [n, 3] (sorted) of the blocks that every
        `depth_sampling_stride`-th depth point reaches at -sdf_trunc, 0
        and +sdf_trunc along its ray (cupoch OpenVolumeUnitKernel,
        scalable_tsdfvolume.cu:98), in float64 on the host."""
        H, W = depth_np.shape
        s = self.depth_sampling_stride
        d = depth_np[::s, ::s]
        vv, uu = np.meshgrid(np.arange(0, H, s), np.arange(0, W, s),
                             indexing="ij")
        ok = d > 0
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        keys = set()
        T_inv = np.linalg.inv(extrinsic)
        zs = d[ok]
        us = uu[ok]
        vs = vv[ok]
        rays = np.stack([(us - cx) / fx, (vs - cy) / fy,
                         np.ones_like(zs)], -1)
        norm = np.linalg.norm(rays, axis=-1)
        for tscale in (-self.sdf_trunc, 0.0, self.sdf_trunc):
            pts_cam = rays * (zs + tscale / np.maximum(norm, 1e-9))[:, None]
            pts_w = pts_cam @ T_inv[:3, :3].T + T_inv[:3, 3]
            bk = np.floor(pts_w / self.volume_unit_length).astype(np.int64)
            keys.update(map(tuple, np.unique(bk, axis=0)))
        return np.asarray(sorted(keys), np.int64).reshape(-1, 3)

    def _visible(self, depth_np, K, extrinsic):
        """(keys [n, 3] f32, slots [n] int64) of the table's blocks whose
        bounding sphere, widened by sdf_trunc, lies in the camera's
        frustum up to the frame's farthest depth."""
        keys = np.asarray(list(self._slots.keys()), np.float32) \
            .reshape(-1, 3)
        slots = np.asarray(list(self._slots.values()), np.int64)
        H, W = depth_np.shape
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        centers = (keys + 0.5) * self.volume_unit_length
        pc = centers @ extrinsic[:3, :3].T + extrinsic[:3, 3]
        rad = (np.sqrt(3.0) / 2.0) * self.volume_unit_length \
            + self.sdf_trunc
        z = pc[:, 2]
        zmax = float(depth_np.max()) if depth_np.size else 0.0
        vis = (z > -rad) & (z - rad < zmax + self.sdf_trunc)
        safe_z = np.maximum(z, 1e-6)
        u = pc[:, 0] * fx / safe_z + cx
        v = pc[:, 1] * fy / safe_z + cy
        su = rad * fx / safe_z
        sv = rad * fy / safe_z
        vis &= (u + su >= 0) & (u - su < W) & (v + sv >= 0) & (v - sv < H)
        return keys[vis], slots[vis]

    def integrate(self, image, intrinsic, extrinsic=None):
        """Fuse an RGB-D frame seen from the world-to-camera `extrinsic`
        (cupoch ScalableTSDFVolume::Integrate): open the blocks near its
        depth, then update the visible ones."""
        dev = self.device
        T = np.eye(4, dtype=np.float32) if extrinsic is None \
            else np.asarray(extrinsic, np.float32)
        depth = image.depth.data.to(dev, torch.float32)
        depth = depth[..., 0] if depth.ndim == 3 else depth
        depth_np = depth.cpu().numpy()
        K = np.asarray(intrinsic.intrinsic_matrix, np.float32)

        for k in map(tuple, self._touched_blocks(depth_np, K, T)):
            if k not in self._slots:
                self._slots[k] = len(self._slots)
        if len(self._slots) > self._capacity:
            self._grow(len(self._slots))
        keys, slots = self._visible(depth_np, K, T)
        if not len(slots):
            return self
        mult = image_ops.depth_to_camera_distance_multiplier(
            depth.shape[1], depth.shape[0], K, dev)[..., 0]
        if self.color_type == TSDFVolumeColorType.NoColor:
            cimg = torch.zeros(depth.shape + (3,), dtype=torch.float32,
                               device=dev)
            channels = 0
        else:
            cimg = image.color.data.to(dev, torch.float32)
            if cimg.shape[-1] == 1:
                cimg = cimg.expand(-1, -1, 3)
            channels = 3
        tsdf_ops.integrate_blocks(
            self.tsdf, self.weight, self.color,
            torch.as_tensor(slots, device=dev),
            torch.as_tensor(keys * np.float32(self.volume_unit_length),
                            device=dev),
            depth, cimg, mult, torch.as_tensor(K, device=dev),
            torch.as_tensor(T, device=dev), self.voxel_length,
            self.sdf_trunc, channels)
        return self

    # -- extraction ------------------------------------------------------
    def _stitched_fields(self, with_color: bool):
        """[B, 17, 17, 17] tsdf and weight fields (and colour with
        `with_color`, else None) of the table's blocks, each with the
        +x / +y / +z faces, the three +diagonal edges and the +x+y+z
        corner of its forward neighbours (a missing neighbour reads a
        zero block: weight 0, unobserved); with the keys [B, 3] int64
        and slots [B]. The host only looks the neighbours' slots up."""
        dev = self.device
        keys = list(self._slots.keys())
        zero_slot = self.tsdf.shape[0]     # one past the end: a zero block
        nbr = [torch.as_tensor(np.asarray(
            [self._slots.get((k[0] + dx, k[1] + dy, k[2] + dz), zero_slot)
             for k in keys], np.int64), device=dev)
            for (dx, dy, dz), _, _ in _STITCH]
        S = BLOCK + 1

        def stitch(src):
            src = torch.cat([src, src.new_zeros((1,) + src.shape[1:])], 0)
            out = src.new_zeros((len(keys), S, S, S) + src.shape[4:])
            for sl, (_, dst, take) in zip(nbr, _STITCH):
                out[(slice(None),) + dst] = src[sl][(slice(None),) + take]
            return out

        return (stitch(self.tsdf), stitch(self.weight),
                stitch(self.color) if with_color else None,
                np.asarray(keys, np.int64).reshape(-1, 3), nbr[0])

    def extract_point_cloud(self) -> PointCloud:
        """The zero crossings between neighbouring voxels of each block
        and its stitched border, axis by axis, with the base voxel's
        colour (cupoch ScalableTSDFVolume::ExtractPointCloud); the
        positions are summed in float64 and rounded once."""
        dev = self.device
        if not self._slots:
            return PointCloud(device=dev)
        fp, wp, _, keys, slots = self._stitched_fields(False)
        f0 = fp[:, :BLOCK, :BLOCK, :BLOCK]
        valid0 = (wp[:, :BLOCK, :BLOCK, :BLOCK] > 0) & (f0.abs() < 0.98)
        origins = torch.as_tensor(
            keys.astype(np.float32) * np.float32(self.volume_unit_length),
            device=dev).double()
        vl = self.voxel_length
        pts, cols = [], []
        for axis in range(3):
            sl = [slice(0, BLOCK)] * 3
            sl[axis] = slice(1, BLOCK + 1)
            idx = (slice(None),) + tuple(sl)
            fn, wn = fp[idx], wp[idx]
            bi, ii, jj, kk = torch.nonzero(valid0 & (wn > 0)
                                           & (f0 * fn < 0), as_tuple=True)
            fa = f0[bi, ii, jj, kk]
            t = fa / (fa - fn[bi, ii, jj, kk])
            base = (torch.stack([ii, jj, kk], -1).double() + 0.5) * vl
            off = torch.zeros_like(base)
            off[:, axis] = (t * vl).double()
            pts.append(origins[bi] + base + off)
            cols.append(self.color[slots[bi], ii, jj, kk])
        pts = torch.cat(pts, 0)
        if not pts.shape[0]:
            return PointCloud(device=dev)
        pcd = PointCloud(pts.to(torch.float32), device=dev)
        if self.color_type != TSDFVolumeColorType.NoColor:
            c = torch.cat(cols, 0)
            pcd.colors = c / 255.0 \
                if self.color_type == TSDFVolumeColorType.RGB8 else c
        return pcd

    def extract_triangle_mesh(self) -> TriangleMesh:
        """Marching cubes block by block over the stitched fields, the
        vertices welded across blocks by their integer edge keys (cupoch
        ScalableTSDFVolume::ExtractTriangleMesh)."""
        if not self._slots:
            return TriangleMesh(device=self.device)
        with_color = self.color_type != TSDFVolumeColorType.NoColor
        fp, wp, cp, keys, _ = self._stitched_fields(with_color)
        if cp is None:
            cp = torch.zeros(fp.shape + (3,), dtype=torch.float32,
                             device=self.device)
        origins = keys.astype(np.float32) \
            * np.float32(self.volume_unit_length)
        return mesh_from_mc_device(fp, wp, cp, origins,
                                   keys.astype(np.int32), self.voxel_length,
                                   BLOCK + 1, self.color_type)
