"""Dense probabilistic occupancy grid (cupoch geometry/occupancygrid.{h,cu},
densegrid.{h,inl}).

`prob_log` is a [R, R, R] float32 log-odds tensor on one device, NaN
where unknown, centred on `origin`. An insert walks every ray from the
viewpoint to its end point through the voxels it crosses (3D DDA,
occupancygrid.cu:61-127): all rays step in lockstep, a finished ray
marks the dump cell past the grid, and the walk tests whether every ray
has finished once every STOP_CHECK_STEPS steps (one host read each
time; the steps after a ray has finished mark only the dump cell, so
the masks do not depend on it). The crossed voxels become free, the end
points occupied, and every touched voxel gets one log-odds update.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .geometry import Geometry3D, GeometryType, as_f32, norm_f32
from .image_ops import _f32

#: the DDA tests whether every ray has finished once every this many steps
STOP_CHECK_STEPS = 16


class OccupancyVoxel:
    """cupoch occupancygrid.h:30-50."""

    def __init__(self, grid_index=(0, 0, 0), prob_log=float("nan"),
                 color=(0.0, 0.0, 1.0)):
        self.grid_index = np.asarray(grid_index, np.int32)
        self.prob_log = float(prob_log)
        self.color = np.asarray(color, np.float32)

    def __repr__(self):
        return (f"OccupancyVoxel(grid_index={tuple(self.grid_index)}, "
                f"prob_log={self.prob_log:.3f})")


def _flat_index(v: torch.Tensor, R: int) -> torch.Tensor:
    """Row-major cell of integer voxel coordinates [N, 3], R^3 (the dump
    cell) where a coordinate lies outside [0, R)."""
    ok = ((v >= 0) & (v < R)).all(-1)
    f = (v[:, 0].long() * R + v[:, 1]) * R + v[:, 2]
    return torch.where(ok, f, R * R * R)


def _mark(flat: torch.Tensor, R: int) -> torch.Tensor:
    """[R, R, R] bool with the listed cells set (the dump cell dropped)."""
    m = torch.zeros(R * R * R + 1, dtype=torch.bool, device=flat.device)
    m[flat] = True
    return m[:-1].reshape(R, R, R)


def dda_free_mask(points: torch.Tensor, viewpoint: torch.Tensor,
                  voxel_size: float, origin: torch.Tensor, resolution: int,
                  max_steps: int) -> Tuple[torch.Tensor, int]:
    """([R, R, R] bool of the voxels the viewpoint-to-point rays cross,
    the steps the walk took); the walk ends after `max_steps`, or
    earlier once every ray has reached its end voxel."""
    R = resolution
    half = R // 2
    dev = points.device
    vs = _f32(voxel_size, dev)
    start = (viewpoint - origin) / vs
    end = (points - origin) / vs
    ray = end - start[None]
    length = norm_f32(ray[:, 0], ray[:, 1], ray[:, 2])[:, None]
    dirn = ray / length.clamp(min=1e-20)
    done = length[:, 0] == 0.0
    current = torch.floor(start)[None].repeat(points.shape[0], 1)
    last = torch.floor(end)
    step = torch.sign(dirn)
    moving = step != 0
    boundary = current + 0.5 * step + 0.5
    inf = torch.tensor(float("inf"), device=dev)
    tmax = torch.where(moving, (boundary - start[None]) / dirn, inf)
    tdelta = torch.where(moving, 1.0 / torch.abs(dirn), inf)
    dump = torch.full_like(done, R * R * R, dtype=torch.int64)
    free = torch.zeros(R * R * R + 1, dtype=torch.bool, device=dev)
    axes = torch.arange(3, device=dev)
    steps = 0
    while steps < max_steps:
        for _ in range(min(STOP_CHECK_STEPS, max_steps - steps)):
            f = torch.where(done, dump, _flat_index(
                current.to(torch.int32) + half, R))
            free[f] = True
            done = done | (current == last).all(-1)
            pick = axes == torch.argmin(tmax, -1, keepdim=True)
            current = torch.where(pick, current + step, current)
            tmax = torch.where(pick, tmax + tdelta, tmax)
            steps += 1
        if bool(done.all()):
            break
    return free[:-1].reshape(R, R, R), steps


def occupied_mask(points: torch.Tensor, hit: torch.Tensor,
                  voxel_size: float, origin: torch.Tensor,
                  resolution: int) -> torch.Tensor:
    """[R, R, R] bool of the end points' voxels
    (create_occupancy_voxels_functor, occupancygrid.cu:194-219)."""
    R = resolution
    v = torch.floor((points - origin) / _f32(voxel_size, points.device)
                    ).to(torch.int32) + R // 2
    f = torch.where(hit, _flat_index(v, R), R * R * R)
    return _mark(f, R)


def apply_log_odds(prob_log, free, occ, prob_miss_log: float,
                   prob_hit_log: float, cmin: float, cmax: float):
    """One log-odds update a touched voxel (add_occupancy_functor,
    occupancygrid.cu:248-282): (new prob_log, touched)."""
    free = free & ~occ
    touched = free | occ
    p = torch.where(torch.isnan(prob_log), 0.0, prob_log)
    p = p + torch.where(occ, prob_hit_log, 0.0) \
        + torch.where(free, prob_miss_log, 0.0)
    p = p.clamp(cmin, cmax)
    return torch.where(touched, p, prob_log), touched


class OccupancyGrid(Geometry3D):
    """Dense [R, R, R] log-odds grid centred on `origin`
    (occupancygrid.h:71-141; the same defaults: 0.05 m, 512^3)."""

    def __init__(self, voxel_size: float = 0.05, resolution: int = 512,
                 origin=(0.0, 0.0, 0.0), device=None):
        super().__init__(GeometryType.OccupancyGrid, device)
        self.voxel_size = float(voxel_size)
        self.resolution = int(resolution)
        self.origin = np.array(origin, np.float32)
        self.clamping_thres_min = -2.0
        self.clamping_thres_max = 3.5
        self.prob_hit_log = 0.85
        self.prob_miss_log = -0.4
        self.occ_prob_thres_log = 0.0
        self.visualize_free_area = True
        #: the DDA steps of the last insert
        self.last_dda_steps = 0
        self.clear()

    @staticmethod
    def from_numpy(prob_log, voxel_size: float, origin, min_bound,
                   max_bound, clamping_thres_min: float = -2.0,
                   clamping_thres_max: float = 3.5,
                   prob_hit_log: float = 0.85, prob_miss_log: float = -0.4,
                   occ_prob_thres_log: float = 0.0,
                   device=None) -> "OccupancyGrid":
        """A grid holding a saved state: log-odds, bounds, thresholds."""
        p = np.asarray(prob_log, np.float32)
        out = OccupancyGrid(voxel_size, p.shape[0], origin, device=device)
        out.prob_log = torch.tensor(p, device=out.device)
        out.min_bound = np.asarray(min_bound, np.int32).copy()
        out.max_bound = np.asarray(max_bound, np.int32).copy()
        out.clamping_thres_min = float(clamping_thres_min)
        out.clamping_thres_max = float(clamping_thres_max)
        out.prob_hit_log = float(prob_hit_log)
        out.prob_miss_log = float(prob_miss_log)
        out.occ_prob_thres_log = float(occ_prob_thres_log)
        return out

    # -- basics -----------------------------------------------------------
    def clear(self):
        R = self.resolution
        self.prob_log = torch.full((R, R, R), float("nan"),
                                   dtype=torch.float32, device=self.device)
        self.min_bound = np.full(3, R // 2, np.int32)
        self.max_bound = np.full(3, R // 2, np.int32)
        return self

    def is_empty(self) -> bool:
        return not bool((~torch.isnan(self.prob_log)).any())

    def __repr__(self):
        return (f"OccupancyGrid with resolution {self.resolution}, "
                f"voxel_size {self.voxel_size} on {self.device}")

    def has_voxels(self) -> bool:
        return not self.is_empty()

    def get_min_bound(self) -> np.ndarray:
        half = self.resolution // 2
        return self.origin + (self.min_bound.astype(np.float32) - half) \
            * self.voxel_size

    def get_max_bound(self) -> np.ndarray:
        half = self.resolution // 2
        return self.origin + (self.max_bound.astype(np.float32) + 1 - half) \
            * self.voxel_size

    def _origin_t(self) -> torch.Tensor:
        return torch.as_tensor(self.origin, device=self.device)

    def voxel_centers(self, idx: torch.Tensor) -> torch.Tensor:
        """World centres of grid indices [K, 3]."""
        return self._origin_t() + (idx.to(torch.float32)
                                   - self.resolution // 2 + 0.5) \
            * self.voxel_size

    def _primary_points(self):
        return self.voxel_centers(self.extract_known_voxels()[0])

    # -- point queries (occupancygrid.cu GetVoxel / IsOccupied) ------------
    def _index_of(self, point) -> np.ndarray:
        half = self.resolution // 2
        return np.floor((np.asarray(point, np.float32) - self.origin)
                        / np.float32(self.voxel_size)).astype(np.int32) + half

    def get_voxel(self, point) -> Tuple[bool, OccupancyVoxel]:
        idx = self._index_of(point)
        R = self.resolution
        if np.any(idx < 0) or np.any(idx >= R):
            return False, OccupancyVoxel()
        p = float(self.prob_log[idx[0], idx[1], idx[2]])
        return True, OccupancyVoxel(idx, p)

    def is_occupied(self, point) -> bool:
        ok, v = self.get_voxel(point)
        return bool(ok and not np.isnan(v.prob_log)
                    and v.prob_log > self.occ_prob_thres_log)

    def is_unknown(self, point) -> bool:
        ok, v = self.get_voxel(point)
        return (not ok) or bool(np.isnan(v.prob_log))

    # -- extraction (occupancygrid.cu ExtractBoundVoxels) -------------------
    def _extract(self, predicate):
        """(grid indices [K, 3] int32, their log-odds [K], None) of the
        known voxels inside the bounds that satisfy `predicate`, in
        row-major order, on the grid's device."""
        lo = self.min_bound
        hi = self.max_bound + 1
        sub = self.prob_log[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        mask = predicate(sub) & ~torch.isnan(sub)
        idx = torch.nonzero(mask).to(torch.int32) \
            + torch.as_tensor(lo, device=self.device)
        return idx, sub[mask], None

    def extract_known_voxels(self):
        return self._extract(lambda p: torch.ones_like(p, dtype=torch.bool))

    def extract_free_voxels(self):
        return self._extract(lambda p: p <= self.occ_prob_thres_log)

    def extract_occupied_voxels(self):
        return self._extract(lambda p: p > self.occ_prob_thres_log)

    # -- updates ------------------------------------------------------------
    def _update(self, free, occ):
        self.prob_log, touched = apply_log_odds(
            self.prob_log, free, occ, self.prob_miss_log, self.prob_hit_log,
            self.clamping_thres_min, self.clamping_thres_max)
        any_axes = [touched.any(dims) for dims in ((1, 2), (0, 2), (0, 1))]
        R = self.resolution
        ar = torch.arange(R, device=self.device)
        lo = [int(torch.where(a, ar, R).amin()) for a in any_axes]
        if lo[0] < R:
            hi = [int(torch.where(a, ar, -1).amax()) for a in any_axes]
            self.min_bound = np.minimum(self.min_bound,
                                        np.asarray(lo, np.int32))
            self.max_bound = np.maximum(self.max_bound,
                                        np.asarray(hi, np.int32))
        return self

    def insert(self, points, viewpoint, max_range: float = -1.0):
        """Insert a scan: the crossed voxels free, the end points
        occupied (cupoch OccupancyGrid::Insert, occupancygrid.cu:463-507).
        `points` is a PointCloud or [N, 3] points; rays longer than
        `max_range` (when >= 0) end free at that range."""
        pts = getattr(points, "points", points)
        pts = as_f32(pts, self.device).reshape(-1, 3)
        if pts.shape[0] == 0:
            return self
        vp = as_f32(viewpoint, self.device).reshape(3)
        pt_vp = pts - vp
        dist = norm_f32(pt_vp[:, 0], pt_vp[:, 1], pt_vp[:, 2])
        is_hit = torch.full_like(dist, True, dtype=torch.bool) \
            if max_range < 0 else dist <= max_range
        safe = dist.clamp(min=1e-20)[:, None]
        ranged = torch.where(is_hit[:, None], pts,
                             vp + pt_vp / safe * _f32(max_range, self.device))
        max_dist = float(torch.abs(ranged - vp).amax())
        n_div = int(np.ceil(max_dist / self.voxel_size))
        origin = self._origin_t()
        occ = occupied_mask(ranged, is_hit, self.voxel_size, origin,
                            self.resolution)
        if n_div > 0:
            free, self.last_dda_steps = dda_free_mask(
                ranged, vp, self.voxel_size, origin, self.resolution,
                max_steps=3 * (n_div + 1))
        else:
            free, self.last_dda_steps = torch.zeros_like(occ), 0
        return self._update(free, occ)

    def add_voxel(self, voxel_index, occupied: bool = False):
        return self.add_voxels(np.asarray(voxel_index, np.int32)[None],
                               occupied)

    def add_voxels(self, voxel_indices, occupied: bool = False):
        """cupoch OccupancyGrid::AddVoxels (occupancygrid.cu)."""
        idx = torch.tensor(np.asarray(voxel_indices, np.int32),
                              device=self.device) \
            if not isinstance(voxel_indices, torch.Tensor) \
            else voxel_indices.to(self.device, torch.int32)
        if idx.shape[0] == 0:
            return self
        mask = _mark(_flat_index(idx.reshape(-1, 3), self.resolution),
                     self.resolution)
        zero = torch.zeros_like(mask)
        return self._update(zero if occupied else mask,
                            mask if occupied else zero)

    def set_free_area(self, min_bound, max_bound):
        """Every voxel of the box (clipped to the grid) becomes free
        (cupoch OccupancyGrid::SetFreeArea, occupancygrid.cu:430-460)."""
        R = self.resolution
        lo = np.clip(self._index_of(min_bound), 0, R - 1)
        hi = np.clip(self._index_of(max_bound), 0, R - 1)
        mask = torch.zeros((R, R, R), dtype=torch.bool, device=self.device)
        mask[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1] = True
        return self._update(mask, torch.zeros_like(mask))

    def reconstruct(self, voxel_size: float, resolution: int):
        """cupoch DenseGrid::Reconstruct: a new voxel size and
        resolution, the contents cleared."""
        self.voxel_size = float(voxel_size)
        self.resolution = int(resolution)
        return self.clear()

    @staticmethod
    def create_from_voxel_grid(input) -> "OccupancyGrid":
        """cupoch OccupancyGrid::CreateFromVoxelGrid: the voxel grid's
        voxels occupied, in a default-sized grid on its device."""
        out = OccupancyGrid(input.voxel_size, device=input.device)
        half = out.resolution // 2
        centers = torch.as_tensor(input.origin, device=out.device) + (
            input.voxels_keys.to(torch.float32) + 0.5) * input.voxel_size
        idx = torch.floor(centers / _f32(out.voxel_size, out.device)
                          ).to(torch.int32) + half
        return out.add_voxels(idx, occupied=True)
