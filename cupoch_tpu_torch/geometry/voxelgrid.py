"""Sparse VoxelGrid container (cupoch geometry/voxelgrid.{h,cu},
voxelgrid_factory.cu): unique [N, 3] int32 voxel keys with averaged
float32 colours on one device, the voxel queries, carving, and the
factories from dense boxes, point clouds, triangle meshes and occupancy
grids.

Keys are deduplicated with `torch.unique(dim=0)` (sorted rows, as the
reference's sort_by_key) and colours averaged in float64. Membership
queries search sorted linear keys instead of comparing every query with
every key.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utility import console
from .boundingvolume import AxisAlignedBoundingBox, OrientedBoundingBox
from .geometry import Geometry3D, GeometryType, as_f32
from .image_ops import _f32, float_value_at
from .intersection_test import triangle_aabb

# the key of no voxel (the JAX package marks dropped keys with it; the
# port drops them by mask and keeps the name)
INVALID_VOXEL_INDEX = np.iinfo(np.int32).min

# element budget of one [voxels, triangles] tile of the mesh voxelizer
_MESH_TILE_ELEMS = 1 << 22


class Voxel:
    """cupoch voxelgrid.h:48-63."""

    def __init__(self, grid_index=(0, 0, 0), color=(1.0, 1.0, 1.0)):
        self.grid_index = np.asarray(grid_index, np.int32)
        self.color = np.asarray(color, np.float32)

    def __repr__(self):
        return (f"Voxel(grid_index={tuple(self.grid_index)}, "
                f"color={tuple(self.color)})")


def unique_keys(keys: torch.Tensor, colors: torch.Tensor = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted unique int32 key rows, their colours' means in float64
    cast to float32; ones without `colors`)."""
    if keys.shape[0] == 0:
        return keys.reshape(0, 3).to(torch.int32), torch.zeros(
            (0, 3), dtype=torch.float32, device=keys.device)
    uniq, inv = torch.unique(keys, dim=0, return_inverse=True)
    if colors is None:
        return uniq.to(torch.int32), torch.ones(
            (uniq.shape[0], 3), dtype=torch.float32, device=keys.device)
    csum = torch.zeros((uniq.shape[0], 3), dtype=torch.float64,
                       device=keys.device)
    csum.index_add_(0, inv, colors.to(torch.float64))
    cnt = torch.bincount(inv, minlength=uniq.shape[0])[:, None]
    return uniq.to(torch.int32), (csum / cnt).to(torch.float32)


def key_membership(query_keys: torch.Tensor, grid_keys: torch.Tensor
                   ) -> torch.Tensor:
    """[Q] bool: does each query key row appear among the grid's key
    rows? Linear keys over the grid's key box, sorted and searched."""
    dev = query_keys.device
    if grid_keys.shape[0] == 0 or query_keys.shape[0] == 0:
        return torch.zeros(query_keys.shape[0], dtype=torch.bool,
                           device=dev)
    g = grid_keys.to(torch.int64)
    q = query_keys.to(torch.int64)
    lo = g.amin(0)
    dims = g.amax(0) - lo + 1

    def lin(k):
        k = k - lo
        return (k[:, 0] * dims[1] + k[:, 1]) * dims[2] + k[:, 2]

    table = torch.sort(lin(g)).values
    inb = ((q >= lo) & (q < lo + dims)).all(-1)
    ql = torch.where(inb, lin(q), 0)
    pos = torch.searchsorted(table, ql).clamp(max=table.shape[0] - 1)
    return inb & (table[pos] == ql)


def _box_corner_offsets(voxel_size: float) -> np.ndarray:
    h = voxel_size / 2.0
    return np.array([[sx, sy, sz] for sx in (-h, h)
                     for sy in (-h, h) for sz in (-h, h)], np.float32)


def _affine_rows(M: torch.Tensor, p: torch.Tensor, translate: bool):
    """[..., rows] = M[:, :3] p (+ M[:, 3] when `translate`), one
    elementwise operation at a time."""
    out = []
    for k in range(M.shape[0]):
        r = p[..., 0] * M[k, 0] + p[..., 1] * M[k, 1] + p[..., 2] * M[k, 2]
        out.append(r + M[k, 3] if translate else r)
    return torch.stack(out, -1)


class VoxelGrid(Geometry3D):
    """Sparse voxel list: `voxels_keys` [N, 3] int32 (unique grid
    indices) and `voxels_colors` [N, 3] float32 on `device`."""

    def __init__(self, device=None):
        super().__init__(GeometryType.VoxelGrid, device)
        self.voxel_size = 0.0
        self.origin = np.zeros(3, np.float32)
        self.voxels_keys = torch.zeros((0, 3), dtype=torch.int32,
                                       device=self.device)
        self.voxels_colors = torch.zeros((0, 3), dtype=torch.float32,
                                         device=self.device)

    @staticmethod
    def from_numpy(keys, colors, voxel_size: float, origin,
                   device=None) -> "VoxelGrid":
        """A grid holding a saved state: keys, colours (None: white),
        voxel size and origin."""
        out = VoxelGrid(device)
        out.voxel_size = float(voxel_size)
        out.origin = np.array(origin, np.float32)
        out.voxels_keys = torch.tensor(
            np.asarray(keys, np.int32).reshape(-1, 3), device=out.device)
        out.voxels_colors = torch.ones(
            (len(out), 3), dtype=torch.float32, device=out.device) \
            if colors is None else as_f32(colors, out.device).reshape(-1, 3)
        return out

    def _like(self) -> "VoxelGrid":
        out = VoxelGrid(self.device)
        out.voxel_size = self.voxel_size
        out.origin = self.origin.copy()
        return out

    # -- basics ---------------------------------------------------------
    def __len__(self):
        return int(self.voxels_keys.shape[0])

    def __repr__(self):
        return f"VoxelGrid with {len(self)} voxels on {self.device}."

    def has_voxels(self) -> bool:
        return len(self) > 0

    def has_colors(self) -> bool:
        return True  # voxelgrid.h:113-115 (default white)

    def is_empty(self) -> bool:
        return not self.has_voxels()

    def clear(self):
        self.voxels_keys = self.voxels_keys[:0]
        self.voxels_colors = self.voxels_colors[:0]
        return self

    def _primary_points(self):
        return self.get_voxel_centers()

    def _origin_t(self) -> torch.Tensor:
        return torch.as_tensor(self.origin, device=self.device)

    def get_voxel_centers(self) -> torch.Tensor:
        return self._origin_t() + (self.voxels_keys.to(torch.float32)
                                   + 0.5) * self.voxel_size

    def get_min_bound(self) -> np.ndarray:
        if self.is_empty():
            return np.asarray(self.origin, np.float32)
        return np.asarray(self.origin + self.voxels_keys.amin(0).cpu(
        ).numpy().astype(np.float32) * self.voxel_size)

    def get_max_bound(self) -> np.ndarray:
        if self.is_empty():
            return np.asarray(self.origin, np.float32)
        return np.asarray(self.origin + (self.voxels_keys.amax(0).cpu(
        ).numpy().astype(np.float32) + 1.0) * self.voxel_size)

    def get_center(self) -> np.ndarray:
        if self.is_empty():
            return np.zeros(3, np.float32)
        return self.get_voxel_centers().mean(0).cpu().numpy()

    def get_axis_aligned_bounding_box(self) -> AxisAlignedBoundingBox:
        return AxisAlignedBoundingBox(self.get_min_bound(),
                                      self.get_max_bound(),
                                      device=self.device)

    def get_oriented_bounding_box(self) -> OrientedBoundingBox:
        return OrientedBoundingBox.create_from_points(
            self.get_voxel_centers())

    # -- voxel access (voxelgrid.h:120-138) -------------------------------
    def get_voxel(self, point) -> np.ndarray:
        p = np.asarray(point, np.float32)
        return np.floor((p - self.origin) / np.float32(self.voxel_size)
                        ).astype(np.int32)

    def get_voxel_center_coordinate(self, idx) -> np.ndarray:
        idx = np.asarray(idx, np.float32)
        return self.origin + (idx + 0.5) * self.voxel_size

    def get_voxel_bounding_points(self, index) -> np.ndarray:
        return self.get_voxel_center_coordinate(index) \
            + _box_corner_offsets(self.voxel_size)

    def get_voxels(self):
        keys = self.voxels_keys.cpu().numpy()
        cols = self.voxels_colors.cpu().numpy()
        return [Voxel(k, c) for k, c in zip(keys, cols)]

    # -- modification ----------------------------------------------------
    def paint_uniform_color(self, color):
        self.voxels_colors = as_f32(color, self.device).expand(
            len(self), 3).contiguous()
        return self

    def paint_indexed_color(self, indices, color):
        idx = torch.tensor(np.asarray(indices, np.int64),
                              device=self.device)
        cols = self.voxels_colors.clone()
        cols[idx] = as_f32(color, self.device)
        self.voxels_colors = cols
        return self

    def select_by_index(self, indices, invert: bool = False) -> "VoxelGrid":
        """cupoch voxelgrid.h SelectByIndex."""
        mask = torch.zeros(len(self), dtype=torch.bool, device=self.device)
        mask[torch.tensor(np.asarray(indices, np.int64),
                             device=self.device)] = True
        if invert:
            mask = ~mask
        out = self._like()
        out.voxels_keys = self.voxels_keys[mask]
        out.voxels_colors = self.voxels_colors[mask]
        return out

    def add_voxel(self, voxel: Voxel):
        self.voxels_keys = torch.cat([self.voxels_keys, torch.as_tensor(
            voxel.grid_index, device=self.device)[None]], 0)
        self.voxels_colors = torch.cat([self.voxels_colors, torch.as_tensor(
            voxel.color, device=self.device)[None]], 0)
        self.voxels_keys, self.voxels_colors = unique_keys(
            self.voxels_keys, self.voxels_colors)
        return self

    def __iadd__(self, other: "VoxelGrid"):
        """Merged grids share voxel_size and origin; colours of
        coincident voxels average (cupoch VoxelGrid::operator+=)."""
        if self.voxel_size != other.voxel_size:
            console.log_error("[VoxelGrid] Could not combine VoxelGrid "
                              "because voxel_size differs.")
        if not np.allclose(self.origin, other.origin):
            console.log_error("[VoxelGrid] Could not combine VoxelGrid "
                              "because origin differs.")
        self.voxels_keys, self.voxels_colors = unique_keys(
            torch.cat([self.voxels_keys,
                       other.voxels_keys.to(self.device)], 0),
            torch.cat([self.voxels_colors,
                       other.voxels_colors.to(self.device)], 0))
        return self

    def __add__(self, other: "VoxelGrid") -> "VoxelGrid":
        out = self._like()
        out.voxels_keys = self.voxels_keys
        out.voxels_colors = self.voxels_colors
        out += other
        return out

    # -- queries ----------------------------------------------------------
    def check_if_included(self, queries) -> np.ndarray:
        """Element-wise membership of query points (cupoch voxelgrid.cu
        CheckIfIncluded)."""
        q = as_f32(queries, self.device).reshape(-1, 3)
        keys = torch.floor((q - self._origin_t())
                           / _f32(self.voxel_size, self.device))
        return key_membership(keys.to(torch.int32),
                              self.voxels_keys).cpu().numpy()

    # -- carving (voxelgrid.cu CarveDepthMap / CarveSilhouette) -----------
    def carve_keep_mask(self, image, camera_parameter,
                        keep_voxels_outside_image: bool) -> torch.Tensor:
        """[N] bool: a voxel stays when any of its 8 corners is outside
        the image (and `keep_voxels_outside_image`) or inside it with a
        sampled value d > 0 and z >= d (compute_carve_functor,
        voxelgrid.cu:58-122, bilinear FloatValueAt)."""
        dev = self.device
        intr = torch.tensor(np.asarray(
            camera_parameter.intrinsic.intrinsic_matrix, np.float32),
            device=dev)
        ext = torch.tensor(np.asarray(camera_parameter.extrinsic,
                                      np.float32), device=dev)
        img = image.data.to(dev, torch.float32)
        H, W = img.shape[0], img.shape[1]
        offs = torch.as_tensor(_box_corner_offsets(self.voxel_size),
                               device=dev)
        pts = self.get_voxel_centers()[:, None, :] + offs[None]
        pc = _affine_rows(ext[:3], pts, True)
        uvz = _affine_rows(intr, pc, False)
        z = uvz[..., 2]
        u = uvz[..., 0] / z
        v = uvz[..., 1] / z
        inside = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
        d = float_value_at(img, u, v)
        keep_pt = (~inside & bool(keep_voxels_outside_image)) | (
            inside & (d > 0) & (z >= d))
        return keep_pt.any(-1)

    def _carve(self, image, camera_parameter, keep_voxels_outside_image):
        keep = self.carve_keep_mask(image, camera_parameter,
                                    keep_voxels_outside_image)
        self.voxels_keys = self.voxels_keys[keep]
        self.voxels_colors = self.voxels_colors[keep]
        return self

    def carve_depth_map(self, depth_map, camera_parameter,
                        keep_voxels_outside_image: bool = False):
        """cupoch VoxelGrid::CarveDepthMap (voxelgrid.cu:378-404)."""
        if depth_map.height != camera_parameter.intrinsic.height or \
                depth_map.width != camera_parameter.intrinsic.width:
            console.log_error(
                "[VoxelGrid::CarveDepthMap] depth_map size does not match "
                "intrinsic parameters.")
        return self._carve(depth_map, camera_parameter,
                           keep_voxels_outside_image)

    def carve_silhouette(self, silhouette_mask, camera_parameter,
                         keep_voxels_outside_image: bool = False):
        """cupoch VoxelGrid::CarveSilhouette (voxelgrid.cu:405-431)."""
        if silhouette_mask.height != camera_parameter.intrinsic.height or \
                silhouette_mask.width != camera_parameter.intrinsic.width:
            console.log_error(
                "[VoxelGrid::CarveSilhouette] silhouette_mask size does not "
                "match intrinsic parameters.")
        return self._carve(silhouette_mask, camera_parameter,
                           keep_voxels_outside_image)

    # -- factories ---------------------------------------------------------
    @staticmethod
    def create_dense(origin, voxel_size: float, width: float, height: float,
                     depth: float, device=None) -> "VoxelGrid":
        """cupoch voxelgrid_factory.cu:131-160."""
        out = VoxelGrid(device)
        out.voxel_size = float(voxel_size)
        out.origin = np.array(origin, np.float32)
        num = [int(round(s / voxel_size)) for s in (width, height, depth)]
        axes = [torch.arange(n, dtype=torch.int32, device=out.device)
                for n in num]
        out.voxels_keys = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                                      -1).reshape(-1, 3)
        out.voxels_colors = torch.ones((len(out), 3), dtype=torch.float32,
                                       device=out.device)
        return out

    @staticmethod
    def create_from_point_cloud(input, voxel_size: float) -> "VoxelGrid":
        """cupoch voxelgrid_factory.cu:221-228; on the cloud's device."""
        half = np.full(3, voxel_size * 0.5, np.float32)
        return VoxelGrid.create_from_point_cloud_within_bounds(
            input, voxel_size,
            input.get_min_bound() - half, input.get_max_bound() + half)

    @staticmethod
    def create_from_point_cloud_within_bounds(
            input, voxel_size: float, min_bound, max_bound) -> "VoxelGrid":
        """cupoch voxelgrid_factory.cu:163-219."""
        if voxel_size <= 0.0:
            console.log_error("[VoxelGridFromPointCloud] voxel_size <= 0.")
        min_bound = np.asarray(min_bound, np.float32)
        max_bound = np.asarray(max_bound, np.float32)
        if voxel_size * np.iinfo(np.int32).max < (max_bound - min_bound).max():
            console.log_error("[VoxelGridFromPointCloud] voxel_size is too "
                              "small.")
        out = VoxelGrid(input.device)
        out.voxel_size = float(voxel_size)
        out.origin = min_bound
        pts = input.points
        keys = torch.floor((pts - out._origin_t())
                           / _f32(voxel_size, out.device)).to(torch.int32)
        cols = input.colors if input.has_colors() \
            else torch.zeros_like(pts)
        out.voxels_keys, out.voxels_colors = unique_keys(keys, cols)
        console.log_debug(
            "Pointcloud is voxelized from %d points to %d voxels.",
            int(pts.shape[0]), len(out))
        return out

    @staticmethod
    def create_from_triangle_mesh(input, voxel_size: float) -> "VoxelGrid":
        """cupoch voxelgrid_factory.cu:288-296; on the mesh's device."""
        half = np.full(3, voxel_size * 0.5, np.float32)
        return VoxelGrid.create_from_triangle_mesh_within_bounds(
            input, voxel_size,
            input.get_min_bound() - half, input.get_max_bound() + half)

    @staticmethod
    def create_from_triangle_mesh_within_bounds(
            input, voxel_size: float, min_bound, max_bound) -> "VoxelGrid":
        """Every voxel of the bounds tested against every triangle
        (cupoch voxelgrid_factory.cu:231-286), in tiles of voxels."""
        if voxel_size <= 0.0:
            console.log_error("[CreateFromTriangleMesh] voxel_size <= 0.")
        min_bound = np.asarray(min_bound, np.float32)
        max_bound = np.asarray(max_bound, np.float32)
        out = VoxelGrid(input.device)
        out.voxel_size = float(voxel_size)
        out.origin = min_bound
        num = np.maximum(np.round((max_bound - min_bound) / voxel_size)
                         .astype(int), 1)
        out.voxels_keys = _voxelize_mesh(
            input.vertices, input.triangles.long(), out._origin_t(),
            voxel_size, [int(n) for n in num])
        out.voxels_colors = torch.ones((len(out), 3), dtype=torch.float32,
                                       device=out.device)
        return out

    @staticmethod
    def create_from_occupancy_grid(input) -> "VoxelGrid":
        """Occupied voxels become grid voxels, the grid's origin at the
        occupancy grid's corner (cupoch voxelgrid_factory.cu
        CreateFromOccupancyGrid)."""
        out = VoxelGrid(input.device)
        out.voxel_size = float(input.voxel_size)
        half = input.resolution // 2
        out.origin = np.asarray(input.origin, np.float32) - \
            half * input.voxel_size
        idx, _, colors = input.extract_occupied_voxels()
        out.voxels_keys = idx.to(torch.int32)
        out.voxels_colors = colors if colors is not None else torch.ones(
            (len(out), 3), dtype=torch.float32, device=out.device)
        return out


def _voxelize_mesh(vertices, triangles, min_bound, voxel_size: float, num):
    """Keys of the voxels of the num[0] x num[1] x num[2] box at
    `min_bound` that overlap a triangle (create_from_trianglemesh_functor,
    voxelgrid_factory.cu:82-129), in row-major key order."""
    dev = vertices.device
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    half = torch.full((3,), voxel_size / 2.0, dtype=torch.float32,
                      device=dev)
    nw, nh, nd = num
    n_total = nw * nh * nd
    tile = max(1, _MESH_TILE_ELEMS // max(int(v0.shape[0]), 1))
    hits = []
    for s in range(0, n_total, tile):
        lin = torch.arange(s, min(s + tile, n_total), dtype=torch.int32,
                           device=dev)
        keys = torch.stack([lin // (nh * nd), (lin % (nh * nd)) // nd,
                            lin % nd], -1)
        centers = min_bound + (keys.to(torch.float32) + 0.5) * voxel_size
        hit = triangle_aabb(centers[:, None, :], half, v0[None], v1[None],
                            v2[None]).any(-1)
        hits.append(keys[hit])
    if not hits:
        return torch.zeros((0, 3), dtype=torch.int32, device=dev)
    return torch.cat(hits, 0)
