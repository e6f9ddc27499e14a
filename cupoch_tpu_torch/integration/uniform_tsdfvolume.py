"""Dense uniform TSDF volume (cupoch integration/uniform_tsdfvolume.h).

The state is three tensors on one device, tsdf and weight [R, R, R] and
colour [R, R, R, 3] f32, updated in place by `tsdf_ops`. The volume is
centred on `origin` (cupoch offsets every index by R / 2); the grid
functions take its min corner. Extraction compacts on the device and
reads one count to size the capacity.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..geometry import image_ops
from ..geometry.pointcloud import PointCloud
from ..geometry.trianglemesh import TriangleMesh
from ..utility.device import resolve_device
from . import tsdf_ops
from .tsdfvolume import TSDFVolume, TSDFVolumeColorType


def _next_bucket(n: int, lo: int = 1024) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def _weld(keys: np.ndarray):
    """np.unique(keys, axis=0, return_index=True, return_inverse=True)
    of integer rows [n, 4] (first index and inverse): the rows are
    packed into one int64 each, in the same lexicographic order."""
    k = keys.astype(np.int64)
    k = k - k.min(0)
    span = k.max(0) + 1
    packed = ((k[:, 0] * span[1] + k[:, 1]) * span[2] + k[:, 2]) \
        * span[3] + k[:, 3]
    _, first, inv = np.unique(packed, return_index=True,
                              return_inverse=True)
    return first, inv


def mesh_from_mc_device(fields, weights, colors, block_origins,
                        block_keys, voxel_length, side: int,
                        color_type) -> TriangleMesh:
    """Marching cubes over [B, S, S, S] fields on their device (B = 1
    for the dense volume). The host reads the active-cell count to size
    the capacity, then welds the vertices by their exact integer edge
    identity, which keeps the mesh watertight whatever the float
    rounding; the mesh stays on the fields' device."""
    dev = fields.device
    cases_flat = tsdf_ops.mc_classify_blocks(fields, weights, side) \
        .reshape(-1)
    count = int(((cases_flat != 0) & (cases_flat != 255)).sum())
    if count == 0:
        return TriangleMesh(device=dev)
    cap = _next_bucket(count)
    ids, _ = tsdf_ops.mc_compact(cases_flat, cap)
    channels = 0 if color_type == TSDFVolumeColorType.NoColor else 3
    verts, cols, ekeys, tri_valid = tsdf_ops.mc_emit_blocks(
        fields, colors, cases_flat, ids,
        torch.as_tensor(np.asarray(block_origins, np.float32), device=dev),
        torch.as_tensor(np.asarray(block_keys), device=dev).long(),
        voxel_length, side, channels)
    del cases_flat, ids
    v = verts.reshape(cap, 5, 3, 3)[tri_valid].reshape(-1, 3)
    c = cols.reshape(cap, 5, 3, 3)[tri_valid].reshape(-1, 3)
    k = ekeys.reshape(cap, 5, 3, 4)[tri_valid].reshape(-1, 4)
    first, inv = _weld(k.cpu().numpy())
    first_d = torch.as_tensor(first, device=dev)
    mesh = TriangleMesh(v[first_d], inv.reshape(-1, 3).astype(np.int32),
                        device=dev)
    cw = c[first_d]
    if color_type == TSDFVolumeColorType.RGB8:
        mesh.vertex_colors = cw / 255.0
    elif color_type == TSDFVolumeColorType.Gray32:
        mesh.vertex_colors = cw
    mesh.remove_degenerate_triangles()
    mesh.compute_vertex_normals()
    return mesh


class UniformTSDFVolume(TSDFVolume):
    """cupoch uniform_tsdfvolume.h, on `device` (None: the card)."""

    def __init__(self, length: float, resolution: int, sdf_trunc: float,
                 color_type: TSDFVolumeColorType = TSDFVolumeColorType.RGB8,
                 origin=(0.0, 0.0, 0.0), device=None):
        super().__init__(length / float(resolution), sdf_trunc, color_type)
        self.length = float(length)
        self.resolution = int(resolution)
        self.origin = np.asarray(origin, np.float32)
        self.device = resolve_device(device)
        #: the steps the last raycast's march took
        self.last_march_steps = 0
        self.reset()

    @classmethod
    def from_numpy(cls, tsdf, weight, color, length: float,
                   resolution: int, sdf_trunc: float,
                   color_type: TSDFVolumeColorType =
                   TSDFVolumeColorType.RGB8,
                   origin=(0.0, 0.0, 0.0), device=None
                   ) -> "UniformTSDFVolume":
        """A volume holding the given state ([R, R, R] tsdf and weight,
        [R, R, R, 3] colour), as another volume of this layout saved it."""
        vol = cls(length, resolution, sdf_trunc, color_type, origin, device)
        R = vol.resolution
        for name, arr, shape in (("tsdf", tsdf, (R, R, R)),
                                 ("weight", weight, (R, R, R)),
                                 ("color", color, (R, R, R, 3))):
            a = np.asarray(arr, np.float32)
            if a.shape != shape:
                raise ValueError(f"{name} has shape {a.shape}, not {shape}")
            if not a.flags.writeable:       # torch wraps writable arrays
                a = a.copy()
            getattr(vol, name).copy_(torch.from_numpy(a))
        return vol

    @property
    def voxel_num(self) -> int:
        return self.resolution ** 3

    @property
    def corner(self) -> np.ndarray:
        """The min corner of the (centred) volume in the world frame."""
        return (self.origin - 0.5 * self.length).astype(np.float32)

    def _corner(self) -> torch.Tensor:
        return torch.as_tensor(self.corner, device=self.device)

    def reset(self):
        R = self.resolution
        f32 = dict(dtype=torch.float32, device=self.device)
        self.tsdf = torch.zeros((R, R, R), **f32)
        self.weight = torch.zeros((R, R, R), **f32)
        self.color = torch.zeros((R, R, R, 3), **f32)
        return self

    # -- integration ----------------------------------------------------
    def integrate(self, image, intrinsic, extrinsic=None):
        """Fuse an RGB-D frame seen from the world-to-camera `extrinsic`
        (cupoch UniformTSDFVolume::Integrate)."""
        dev = self.device
        T = np.eye(4, dtype=np.float32) if extrinsic is None \
            else np.asarray(extrinsic, np.float32)
        depth = image.depth.data.to(dev, torch.float32)
        depth = depth[..., 0] if depth.ndim == 3 else depth
        mult = image_ops.depth_to_camera_distance_multiplier(
            depth.shape[1], depth.shape[0], intrinsic.intrinsic_matrix,
            dev)[..., 0]
        if self.color_type == TSDFVolumeColorType.NoColor:
            cimg = torch.zeros(depth.shape + (3,), dtype=torch.float32,
                               device=dev)
            channels = 0
        else:
            cimg = image.color.data.to(dev, torch.float32)
            if cimg.shape[-1] == 1:
                cimg = cimg.expand(-1, -1, 3)
            channels = 3
        tsdf_ops.integrate(
            self.tsdf, self.weight, self.color, depth, cimg, mult,
            torch.as_tensor(np.asarray(intrinsic.intrinsic_matrix,
                                       np.float32), device=dev),
            torch.as_tensor(T, device=dev), self.voxel_length,
            self.sdf_trunc, self._corner(), channels)
        return self

    def integrate_with_depth_to_camera_distance_multiplier(
            self, image, intrinsic, extrinsic, multiplier):
        """cupoch uniform_tsdfvolume.cu: the multiplier is recomputed
        from the intrinsics."""
        return self.integrate(image, intrinsic, extrinsic)

    # -- extraction ------------------------------------------------------
    def extract_point_cloud(self) -> PointCloud:
        """The zero crossings between neighbouring voxels, with the
        tsdf's central-difference gradient as normals and the base
        voxel's colour (cupoch ExtractPointCloud)."""
        mask = tsdf_ops.surface_crossings(self.tsdf, self.weight)
        ids = torch.nonzero(mask.reshape(-1))[:, 0]
        del mask
        if ids.numel() == 0:
            return PointCloud(device=self.device)
        R = self.resolution
        axis = ids % 3
        lin = ids // 3
        kk, jj, ii = lin % R, (lin // R) % R, lin // (R * R)
        vl = torch.tensor(self.voxel_length, dtype=torch.float32,
                          device=self.device)
        base = (torch.stack([ii, jj, kk], -1).to(torch.float32) + 0.5) \
            * vl + self._corner()
        fr = tsdf_ops.crossing_fraction(self.tsdf, ii, jj, kk, axis) * vl
        offs = torch.where(
            torch.arange(3, device=self.device)[None, :] == axis[:, None],
            fr[:, None], 0.0)
        pcd = PointCloud(base + offs, device=self.device)
        n = tsdf_ops.central_gradient(self.tsdf, ii, jj, kk)
        pcd.normals = n / torch.linalg.norm(n, dim=-1, keepdim=True) \
            .clamp(min=1e-12)
        if self.color_type != TSDFVolumeColorType.NoColor:
            c = self.color[ii, jj, kk]
            pcd.colors = c / 255.0 \
                if self.color_type == TSDFVolumeColorType.RGB8 else c
        return pcd

    def extract_voxel_point_cloud(self) -> PointCloud:
        """Observed voxel centres with |tsdf| < 0.98, coloured by
        (tsdf + 1) / 2 (cupoch ExtractVoxelPointCloud)."""
        f, w = self.tsdf, self.weight
        sel = (w != 0.0) & (f < 0.98) & (f >= -0.98)
        ijk = torch.nonzero(sel)
        vl = torch.tensor(self.voxel_length, dtype=torch.float32,
                          device=self.device)
        pcd = PointCloud((ijk.to(torch.float32) + 0.5) * vl + self._corner(),
                         device=self.device)
        c = (f[sel] + 1.0) * 0.5
        pcd.colors = torch.stack([c, c, c], -1)
        return pcd

    def extract_triangle_mesh(self) -> TriangleMesh:
        """Marching cubes (cupoch ExtractTriangleMesh; the tables are
        derived in `marching_cubes_tables`)."""
        return mesh_from_mc_device(
            self.tsdf[None], self.weight[None], self.color[None],
            np.asarray([self.corner], np.float32),
            np.zeros((1, 3), np.int64), self.voxel_length,
            self.resolution, self.color_type)

    def raycast(self, intrinsic, extrinsic, sdf_trunc: Optional[float] = None,
                project_valid_depth_only: bool = True) -> PointCloud:
        """The model seen from the world-to-camera `extrinsic` (cupoch
        UniformTSDFVolume::Raycast): the march takes at most the steps of
        sdf_trunc / 2 that cross the volume's diagonal."""
        sdf_trunc = self.sdf_trunc if sdf_trunc is None else float(sdf_trunc)
        dev = self.device
        T = np.asarray(extrinsic, np.float32)
        cam_to_world = np.linalg.inv(T).astype(np.float32)
        diag = self.length * np.sqrt(3.0)
        max_steps = int(np.ceil(diag / (0.5 * sdf_trunc))) + 1
        pts, normals, colors, self.last_march_steps = tsdf_ops.raycast(
            self.tsdf, self.weight, self.color,
            torch.as_tensor(np.asarray(intrinsic.intrinsic_matrix,
                                       np.float32), device=dev),
            torch.as_tensor(cam_to_world, device=dev), self.voxel_length,
            sdf_trunc, self._corner(), intrinsic.height, intrinsic.width,
            max_steps)
        if project_valid_depth_only:
            ok = torch.isfinite(pts).all(-1)
            pts, normals, colors = pts[ok], normals[ok], colors[ok]
        pcd = PointCloud(pts, device=dev)
        pcd.normals = normals
        if self.color_type == TSDFVolumeColorType.RGB8:
            colors = colors / 255.0
        pcd.colors = colors
        return pcd
