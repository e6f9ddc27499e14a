"""Exact Euclidean distance transform on a dense grid (cupoch
geometry/distancetransform.{h,cu}).

The squared EDT is separable: per axis, out[i] = min_j ((i - j)^2 +
in[j]), with the minimising j kept, in three passes (z, y, x). That
gives the exact distances and each voxel's nearest site (the Voronoi
diagram). Each pass forms [lines, R, R] cost tiles and reduces them with
`torch.min`, whose ties go to the first index; the tile's width comes
from the device's free memory. The sums are integers below 2^24, so the
float32 arithmetic is exact, and a line with no site (cost 1e18, which
swallows the offsets) gets index 0. Lines whose inputs are all 1e18 are
filled directly with (1e18, 0), which is what their tiles would give.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utility import console
from .geometry import Geometry3D, GeometryType, as_f32, sqrt_f32

_INF = 1e18
# a cost tile takes at most this share of the free device memory
_TILE_MEMORY_SHARE = 0.25
# lines a gather chunk composes at once
_GATHER_LINES = 1 << 16


def _tile_lines(R: int, n_lines: int, device: torch.device) -> int:
    """Lines a cost tile of [lines, R, R] float32 (with the indices
    torch.min returns) may hold."""
    per_line = R * R * 4 + R * 12
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = int(free * _TILE_MEMORY_SHARE)
    else:
        budget = 1 << 28
    return max(1, min(n_lines, budget // per_line))


def minplus_pass(g: torch.Tensor):
    """One pass over rows: g [L, R] (L lines) -> (out [L, R] float32,
    arg [L, R] int32) with out[l, i] = min_j ((i - j)^2 + g[l, j]) and
    arg the first minimising j."""
    L, R = g.shape
    dev = g.device
    i = torch.arange(R, dtype=torch.float32, device=dev)
    D = (i[:, None] - i[None, :]) ** 2                  # [R_out, R_in]
    out = torch.full((L, R), _INF, dtype=torch.float32, device=dev)
    arg = torch.zeros((L, R), dtype=torch.int32, device=dev)
    live = torch.nonzero((g < _INF).any(-1))[:, 0]
    tile = _tile_lines(R, max(int(live.shape[0]), 1), dev)
    for s in range(0, int(live.shape[0]), tile):
        rows = live[s:s + tile]
        cost = g[rows][:, None, :] + D[None]            # [T, R_out, R_in]
        v, a = torch.min(cost, -1)
        del cost
        out[rows] = v
        arg[rows] = a.to(torch.int32)
    return out, arg


def _gather(src: torch.Tensor, dim: int, index: torch.Tensor,
            chunk_dim: int) -> torch.Tensor:
    """torch.gather in chunks along `chunk_dim` (int32 indices made
    int64 a chunk at a time)."""
    out = torch.empty_like(index)
    R = index.shape[chunk_dim]
    step = max(1, _GATHER_LINES * 64 // max(index.numel() // R, 1))
    for s in range(0, R, step):
        sl = [slice(None)] * index.ndim
        sl[chunk_dim] = slice(s, s + step)
        src_c = src if chunk_dim == dim else src[tuple(sl)]
        out[tuple(sl)] = torch.gather(src_c, dim, index[tuple(sl)].long())
    return out


def edt3d(site_mask: torch.Tensor):
    """Exact squared EDT and nearest-site indices of a [R, R, R] bool
    mask: (dist2 [R, R, R] float32 in voxel units, nearest [R, R, R, 3]
    int32, all -1 when there is no site)."""
    R = site_mask.shape[0]
    g0 = torch.where(site_mask, 0.0, _INF).to(torch.float32)
    # pass 1: along z, lines (x, y)
    d1, nz = minplus_pass(g0.reshape(R * R, R))
    d1 = d1.reshape(R, R, R)
    nz = nz.reshape(R, R, R)
    del g0
    # pass 2: along y, lines (x, z)
    d2, ay = minplus_pass(d1.permute(0, 2, 1).reshape(R * R, R))
    del d1
    d2 = d2.reshape(R, R, R).permute(0, 2, 1).contiguous()
    ay = ay.reshape(R, R, R).permute(0, 2, 1).contiguous()  # [x, y, z]
    nz2 = _gather(nz, 1, ay, 0)                    # nz[x, ay, z]
    del nz
    # pass 3: along x, lines (y, z)
    d3, ax = minplus_pass(d2.permute(1, 2, 0).reshape(R * R, R))
    del d2
    d3 = d3.reshape(R, R, R).permute(2, 0, 1).contiguous()
    ax = ax.reshape(R, R, R).permute(2, 0, 1).contiguous()  # [x, y, z]
    ny3 = _gather(ay, 0, ax, 1)                    # ay[ax, y, z]
    del ay
    nz3 = _gather(nz2, 0, ax, 1)                   # nz2[ax, y, z]
    del nz2
    nearest = torch.stack([ax, ny3, nz3], -1)
    if not bool(site_mask.any()):
        return torch.full_like(d3, _INF), torch.full_like(nearest, -1)
    return d3, nearest


class DistanceTransform(Geometry3D):
    """Dense EDT grid centred on `origin` like OccupancyGrid
    (distancetransform.h:51-79; the query convention of
    distancetransform.cu:411-415)."""

    def __init__(self, voxel_size: float = 0.05, resolution: int = 512,
                 origin=(0.0, 0.0, 0.0), device=None):
        super().__init__(GeometryType.DistanceTransform, device)
        self.voxel_size = float(voxel_size)
        self.resolution = int(resolution)
        self.origin = np.array(origin, np.float32)
        self.clear()

    @staticmethod
    def from_numpy(distance, nearest_index, voxel_size: float, origin,
                   device=None) -> "DistanceTransform":
        """A transform holding a saved state: distances and nearest
        sites."""
        d = np.asarray(distance, np.float32)
        out = DistanceTransform(voxel_size, d.shape[0], origin, device)
        out.distance = torch.tensor(d, device=out.device)
        out.nearest_index = torch.tensor(
            np.asarray(nearest_index, np.int32), device=out.device)
        return out

    def __repr__(self):
        return (f"DistanceTransform with resolution {self.resolution}, "
                f"voxel_size {self.voxel_size} on {self.device}")

    def clear(self):
        R = self.resolution
        self.distance = torch.zeros((R, R, R), dtype=torch.float32,
                                    device=self.device)
        self.nearest_index = torch.zeros((R, R, R, 3), dtype=torch.int32,
                                         device=self.device)
        return self

    def is_empty(self) -> bool:
        return not bool((self.distance != 0).any())

    def reconstruct(self, voxel_size: float, resolution: int):
        self.voxel_size = float(voxel_size)
        self.resolution = int(resolution)
        return self.clear()

    def _primary_points(self):
        return torch.zeros((0, 3), dtype=torch.float32, device=self.device)

    # -- computation ------------------------------------------------------
    def compute_edt(self, obstacles):
        """`obstacles`: [N, 3] int grid indices (0..R-1, the centred
        convention) or a VoxelGrid with the same voxel size (cupoch
        ComputeEDT, distancetransform.cu:318-356)."""
        idx = self._obstacle_indices(obstacles)
        R = self.resolution
        mask = torch.zeros(R * R * R + 1, dtype=torch.bool,
                           device=self.device)
        if idx.shape[0] > 0:
            ok = ((idx >= 0) & (idx < R)).all(-1)
            f = (idx[:, 0].long() * R + idx[:, 1]) * R + idx[:, 2]
            mask[torch.where(ok, f, R * R * R)] = True
        d2, self.nearest_index = edt3d(mask[:-1].reshape(R, R, R))
        self.distance = sqrt_f32(d2) * self.voxel_size
        return self

    def compute_voronoi_diagram(self, obstacles):
        """The same computation: the Voronoi labels are the nearest-site
        indices (cupoch ComputeVoronoiDiagram,
        distancetransform.cu:358-409)."""
        return self.compute_edt(obstacles)

    def _obstacle_indices(self, obstacles) -> torch.Tensor:
        from .voxelgrid import VoxelGrid

        if isinstance(obstacles, VoxelGrid):
            if abs(self.voxel_size - obstacles.voxel_size) > 1e-7:
                console.log_error(
                    "[DistanceTransform] voxel size does not match.")
            half = self.resolution // 2
            # voxel-grid key -> world position -> centred grid index
            # (compute_obstacle_cells_functor, distancetransform.cu:244-258)
            centers = obstacles.get_voxel_centers().to(self.device)
            rel = (centers - torch.as_tensor(self.origin, device=self.device)
                   ) / torch.tensor(self.voxel_size, dtype=torch.float32,
                                    device=self.device)
            return torch.floor(rel).to(torch.int32) + half
        if isinstance(obstacles, torch.Tensor):
            return obstacles.to(self.device, torch.int32).reshape(-1, 3)
        return torch.tensor(np.asarray(obstacles, np.int32).reshape(-1, 3),
                               device=self.device)

    # -- queries ------------------------------------------------------------
    def get_distances(self, queries) -> np.ndarray:
        """Distances at world query points, the nearest voxel's (cupoch
        GetDistances / query_distance_functor); inf outside the grid."""
        q = as_f32(queries, self.device).reshape(-1, 3)
        R = self.resolution
        vs = torch.tensor(self.voxel_size, dtype=torch.float32,
                          device=self.device)
        g = (q - torch.as_tensor(self.origin, device=self.device)
             + 0.5 * self.voxel_size * R) / vs
        v = torch.floor(g).to(torch.int32)
        ok = ((v >= 0) & (v < R)).all(-1)
        vc = v.clamp(0, R - 1).long()
        d = self.distance[vc[:, 0], vc[:, 1], vc[:, 2]]
        return torch.where(ok, d, float("inf")).cpu().numpy()

    def get_distance(self, query) -> float:
        return float(self.get_distances(np.asarray(query)[None])[0])

    @staticmethod
    def create_from_occupancy_grid(input) -> "DistanceTransform":
        """cupoch CreateFromOccupancyGrid (distancetransform.cu): the
        occupied voxels are the sites."""
        out = DistanceTransform(input.voxel_size, input.resolution,
                                input.origin, device=input.device)
        idx, _, _ = input.extract_occupied_voxels()
        return out.compute_edt(idx)
