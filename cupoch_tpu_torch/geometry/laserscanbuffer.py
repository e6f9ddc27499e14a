"""Ring buffer of 2D laser scans (cupoch geometry/laserscanbuffer.{h,cu},
laserscanbuffer_factory.cu).

The buffer is a fixed [num_max_scans, num_steps] range matrix and
[num_max_scans, 4, 4] scan origins on one device; the ring is two host
integers (top_, bottom_) over them, so each filter is a few tensor
operations over the whole buffer. The beam angles' sines and cosines
are computed once on the host, so the card and the CPU project scans to
the same points.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utility import console
from .geometry import Geometry3D, GeometryType, as_f32, sqrt_f32
from .image_ops import _f32

DEFAULT_NUM_MAX_SCANS = 50


def _trig32(angles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of float32 angles, computed in float64 and rounded to
    float32."""
    a = np.asarray(angles, np.float32).astype(np.float64)
    return np.cos(a).astype(np.float32), np.sin(a).astype(np.float32)


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2) as the reference's hypot takes it: the larger
    magnitude times sqrt(1 + r^2), r the ratio of the smaller to it."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    r = lo / torch.where(hi == 0, 1.0, hi)
    h = torch.where(hi == 0, hi, hi * sqrt_f32(1.0 + r * r))
    return torch.where(torch.isinf(ax) | torch.isinf(ay), float("inf"), h)


def shadow_filter(ranges: torch.Tensor, min_tan: float, max_tan: float,
                  angle_increment: float, window: int, neighbors: int,
                  remove_shadow_start_point: bool) -> torch.Tensor:
    """The scan-shadow filter over a whole [S, num_steps] buffer
    (apply_scan_shadow_filter_functor, laserscanbuffer.cu:57-107): for
    each step i and window offset y, a shadow between readings i and i+y
    NaNs the readings of i's neighbourhood farther than i (and i itself
    when asked)."""
    S, num_steps = ranges.shape
    dev = ranges.device
    out_nan = torch.zeros_like(ranges, dtype=torch.bool)
    self_nan = torch.zeros_like(ranges, dtype=torch.bool)
    r1 = ranges
    i = torch.arange(num_steps, device=dev)
    inc = np.float32(angle_increment)
    for y in range(-window, window + 1):
        if y == 0:
            continue
        r2 = torch.roll(ranges, -y, 1)
        inb = (i + y >= 0) & (i + y < num_steps)
        cos_a, sin_a = _trig32(np.float32(y) * inc)
        perp_y = r2 * _f32(sin_a, dev)
        perp_x = r1 - r2 * _f32(cos_a, dev)
        perp_tan = torch.abs(perp_y) / perp_x
        shadow = torch.where(perp_tan > 0, perp_tan < min_tan,
                             perp_tan > max_tan) & inb[None, :]
        self_nan = self_nan | shadow
        for off in range(-neighbors, neighbors + 1):
            tgt = torch.roll(r1, -off, 1)
            t_inb = (i + off >= 0) & (i + off < num_steps)
            hit = shadow & t_inb[None, :] & (r1 < tgt)
            out_nan = out_nan | torch.roll(hit, off, 1)
    if remove_shadow_start_point:
        out_nan = out_nan | self_nan
    return torch.where(out_nan, float("nan"), ranges)


def scan_to_points(ranges: torch.Tensor, origins: torch.Tensor,
                   min_angle: float, angle_increment: float,
                   min_range: float, max_range: float):
    """Every (scan, step) reading as a world point
    (compute_points_from_scan_functor, pointcloud_factory.cu:202-237):
    ([S * num_steps, 3] points, [S * num_steps] bool of the finite
    readings within [min_range, max_range])."""
    S, num_steps = ranges.shape
    dev = ranges.device
    angle = np.float32(min_angle) + np.arange(num_steps, dtype=np.float32) \
        * np.float32(angle_increment)
    c, s = (torch.as_tensor(t, device=dev) for t in _trig32(angle))
    x = ranges * c[None, :]
    y = ranges * s[None, :]
    o = origins[:, None]
    pts = torch.stack([o[..., k, 0] * x + o[..., k, 1] * y + o[..., k, 3]
                       for k in range(3)], -1)
    ok = torch.isfinite(ranges) & (ranges >= min_range) \
        & (ranges <= max_range)
    return pts.reshape(-1, 3), ok.reshape(-1)


class LaserScanBuffer(Geometry3D):
    """cupoch laserscanbuffer.h:42-130."""

    def __init__(self, num_steps: int,
                 num_max_scans: int = DEFAULT_NUM_MAX_SCANS,
                 min_angle: float = -math.pi, max_angle: float = math.pi,
                 device=None):
        super().__init__(GeometryType.LaserScanBuffer, device)
        self.num_steps_ = int(num_steps)
        self.num_max_scans_ = int(num_max_scans)
        self.min_angle_ = float(min_angle)
        self.max_angle_ = float(max_angle)
        self.top_ = 0
        self.bottom_ = 0
        self.ranges = torch.full((self.num_max_scans_, self.num_steps_),
                                 float("nan"), device=self.device)
        self.intensities = None
        self.origins = torch.eye(4, device=self.device).repeat(
            self.num_max_scans_, 1, 1)

    @staticmethod
    def from_numpy(ranges, origins, top: int, bottom: int,
                   min_angle: float = -math.pi, max_angle: float = math.pi,
                   intensities=None, device=None) -> "LaserScanBuffer":
        """A buffer holding a saved state: the [slots, steps] ring, the
        [slots, 4, 4] origins, the ring's top and bottom counters and
        the angles."""
        r = np.asarray(ranges, np.float32)
        out = LaserScanBuffer(r.shape[1], r.shape[0], min_angle, max_angle,
                              device=device)
        out.ranges = torch.tensor(r, device=out.device)
        out.origins = torch.tensor(np.asarray(origins, np.float32),
                                      device=out.device)
        out.top_, out.bottom_ = int(top), int(bottom)
        if intensities is not None:
            out.intensities = torch.tensor(
                np.asarray(intensities, np.float32), device=out.device)
        return out

    # -- predicates / bookkeeping -------------------------------------
    def get_num_scans(self) -> int:
        return self.bottom_ - self.top_

    def is_full(self) -> bool:
        return self.get_num_scans() == self.num_max_scans_

    def is_empty(self) -> bool:
        return self.bottom_ == self.top_

    def has_intensities(self) -> bool:
        return self.intensities is not None

    def get_angle_increment(self) -> float:
        return (self.max_angle_ - self.min_angle_) / (self.num_steps_ - 1)

    def _slots(self) -> np.ndarray:
        """Occupied ring slots, oldest first."""
        return np.arange(self.top_, self.bottom_) % self.num_max_scans_

    def _slot_mask(self) -> torch.Tensor:
        m = torch.zeros(self.num_max_scans_, dtype=torch.bool,
                        device=self.device)
        m[torch.as_tensor(self._slots(), device=self.device)] = True
        return m

    def get_ranges(self) -> np.ndarray:
        """The occupied scans, oldest first (GetRanges)."""
        return self.ranges.cpu().numpy()[self._slots()]

    def get_intensities(self) -> np.ndarray:
        if self.intensities is None:
            return np.zeros((0, self.num_steps_), np.float32)
        return self.intensities.cpu().numpy()[self._slots()]

    def get_origins(self) -> np.ndarray:
        return self.origins.cpu().numpy()[self._slots()]

    def clear(self):
        self.top_ = 0
        self.bottom_ = 0
        self.ranges = torch.full_like(self.ranges, float("nan"))
        self.intensities = None
        self.origins = torch.eye(4, device=self.device).repeat(
            self.num_max_scans_, 1, 1)
        return self

    def __repr__(self):
        return (f"LaserScanBuffer with {self.get_num_scans()} scans of "
                f"{self.num_steps_} steps on {self.device}")

    # -- geometry interface -------------------------------------------
    def _all_points(self, min_range=0.0, max_range=np.inf):
        pts, ok = scan_to_points(self.ranges, self.origins, self.min_angle_,
                                 self.get_angle_increment(), min_range,
                                 max_range)
        return pts, ok & self._slot_mask().repeat_interleave(self.num_steps_)

    def _bound(self, fn) -> np.ndarray:
        pts, ok = self._all_points()
        if not bool(ok.any()):
            return np.zeros(3, np.float32)
        return fn(pts[ok]).cpu().numpy()

    def get_min_bound(self):
        return self._bound(lambda p: p.amin(0))

    def get_max_bound(self):
        return self._bound(lambda p: p.amax(0))

    def get_center(self):
        return self._bound(lambda p: p.mean(0))

    def get_axis_aligned_bounding_box(self):
        from .boundingvolume import AxisAlignedBoundingBox

        return AxisAlignedBoundingBox(self.get_min_bound(),
                                      self.get_max_bound(),
                                      device=self.device)

    def transform(self, T):
        """Transforms every scan origin (Transform, laserscanbuffer.cu)."""
        T = as_f32(T, self.device)
        self.origins = torch.einsum("ij,sjk->sik", T, self.origins)
        return self

    def translate(self, t, relative: bool = True):
        t = as_f32(t, self.device)
        o = self.origins.clone()
        o[:, :3, 3] = o[:, :3, 3] + t[None] if relative else t[None]
        self.origins = o
        return self

    def rotate(self, R, center: bool = True):
        R = as_f32(R, self.device)
        o = self.origins.clone()
        o[:, :3, :3] = torch.einsum("ij,sjk->sik", R, self.origins[:, :3, :3])
        self.origins = o
        return self

    def scale(self, s, center: bool = True):
        self.ranges = self.ranges * float(s)
        return self

    # -- mutation ------------------------------------------------------
    def add_ranges(self, ranges, transformation=None, intensities=None):
        """Push scans, the oldest evicted when full (AddRanges)."""
        r = as_f32(ranges, self.device).reshape(-1, self.num_steps_)
        T = torch.eye(4, device=self.device) if transformation is None \
            else as_f32(transformation, self.device).reshape(4, 4)
        if intensities is not None:
            ints = as_f32(intensities, self.device).reshape(
                -1, self.num_steps_)
            if self.intensities is None:
                self.intensities = torch.full_like(self.ranges, float("nan"))
        for j in range(r.shape[0]):
            slot = self.bottom_ % self.num_max_scans_
            self.ranges[slot] = r[j]
            self.origins[slot] = T
            if intensities is not None:
                self.intensities[slot] = ints[j]
            self.bottom_ += 1
            if self.bottom_ - self.top_ > self.num_max_scans_:
                self.top_ += 1
        return self

    add_host_ranges = add_ranges

    def merge(self, other: "LaserScanBuffer"):
        if (other.num_steps_ != self.num_steps_
                or other.min_angle_ != self.min_angle_
                or other.max_angle_ != self.max_angle_):
            console.log_error("[LaserScanBuffer::Merge] buffers are not "
                              "compatible.")
        slots = torch.as_tensor(other._slots(), device=other.device)
        ints = other.intensities[slots] if other.has_intensities() else None
        ranges = other.ranges[slots]
        origins = other.origins[slots]
        for j in range(ranges.shape[0]):
            self.add_ranges(ranges[j], origins[j],
                            None if ints is None else ints[j])
        return self

    def pop_one_scan(self) -> Optional["LaserScanBuffer"]:
        """Removes and returns the oldest scan as a one-scan buffer
        (PopOneScan)."""
        if self.is_empty():
            console.log_warning("[LaserScanBuffer::PopOneScan] empty buffer.")
            return None
        slot = self.top_ % self.num_max_scans_
        out = LaserScanBuffer(self.num_steps_, 1, self.min_angle_,
                              self.max_angle_, device=self.device)
        out.add_ranges(self.ranges[slot], self.origins[slot],
                       None if self.intensities is None
                       else self.intensities[slot])
        self.top_ += 1
        return out

    def pop_host_one_scan(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ranges, intensities) of the oldest scan (PopHostOneScan)."""
        scan = self.pop_one_scan()
        if scan is None:
            return (np.zeros(0, np.float32), np.zeros(0, np.float32))
        ints = (scan.get_intensities()[0] if scan.has_intensities()
                else np.zeros(0, np.float32))
        return scan.get_ranges()[0], ints

    # -- filters -------------------------------------------------------
    def range_filter(self, min_range: float, max_range: float
                     ) -> "LaserScanBuffer":
        """NaNs the readings outside [min_range, max_range]
        (RangeFilter)."""
        if min_range >= max_range:
            console.log_error(
                "[LaserScanBuffer::RangeFilter] min_range must be smaller "
                "than max_range.")
        out = self._copy()
        out.ranges = torch.where(
            (self.ranges < min_range) | (self.ranges > max_range),
            float("nan"), self.ranges)
        return out

    def scan_shadows_filter(self, min_angle: float, max_angle: float,
                            window: int, neighbors: int = 0,
                            remove_shadow_start_point: bool = False
                            ) -> "LaserScanBuffer":
        """Removes veiling points (ScanShadowsFilter,
        laserscanbuffer.cu:437+); min/max_angle are the perpendicular
        test angles in degrees, as in the laser_filters ROS package."""
        min_tan = math.tan(math.radians(min_angle))
        max_tan = math.tan(math.radians(max_angle))
        if min_tan < 0:
            min_tan = -min_tan
        if max_tan > 0:
            max_tan = -max_tan
        out = self._copy()
        out.ranges = shadow_filter(
            self.ranges, float(np.float32(min_tan)),
            float(np.float32(max_tan)), self.get_angle_increment(),
            int(window), int(neighbors), bool(remove_shadow_start_point))
        return out

    def _copy(self) -> "LaserScanBuffer":
        out = LaserScanBuffer(self.num_steps_, self.num_max_scans_,
                              self.min_angle_, self.max_angle_,
                              device=self.device)
        out.top_, out.bottom_ = self.top_, self.bottom_
        out.ranges = self.ranges.clone()
        out.intensities = None if self.intensities is None \
            else self.intensities.clone()
        out.origins = self.origins.clone()
        return out

    # -- factories -----------------------------------------------------
    @staticmethod
    def create_from_point_cloud(pcd, angle_increment: float,
                                min_height: float, max_height: float,
                                num_vertical_divisions: int = 1,
                                min_range: float = 0.0,
                                max_range: float = np.inf,
                                min_angle: float = -math.pi,
                                max_angle: float = math.pi
                                ) -> Optional["LaserScanBuffer"]:
        """Bins the cloud's points into (height slice, bearing) cells,
        keeping the least range of each (pointcloud_to_laserscan_functor,
        laserscanbuffer_factory.cu:34-82): one scatter-min on the cloud's
        device."""
        if angle_increment <= 0.0:
            console.log_error("[LaserScanBuffer::CreateFromPointCloud] "
                              "angle_increment must be positive.")
            return None
        if min_height >= max_height:
            console.log_error("[LaserScanBuffer::CreateFromPointCloud] "
                              "min_height must be smaller than max_height.")
            return None
        if min_range >= max_range:
            console.log_error("[LaserScanBuffer::CreateFromPointCloud] "
                              "min_range must be smaller than max_range.")
            return None
        if min_angle >= max_angle:
            console.log_error("[LaserScanBuffer::CreateFromPointCloud] "
                              "min_angle must be smaller than max_angle.")
            return None
        num_steps = int(math.ceil((max_angle - min_angle) / angle_increment))
        num_max_scans = max(DEFAULT_NUM_MAX_SCANS, num_vertical_divisions)
        dev = pcd.device
        buf = LaserScanBuffer(num_steps, num_max_scans, min_angle, max_angle,
                              device=dev)
        height_increment = (max_height - min_height) / num_vertical_divisions
        pts = pcd.points
        rng = _hypot(pts[:, 0], pts[:, 1])
        ang = torch.atan2(pts[:, 1], pts[:, 0])
        row = torch.floor((pts[:, 2] - min_height)
                          / _f32(height_increment, dev)).to(torch.int32)
        col = torch.floor((ang - min_angle) / _f32(angle_increment, dev)
                          ).to(torch.int32)
        ok = ((rng >= min_range) & (rng <= max_range)
              & (ang >= min_angle) & (ang <= max_angle)
              & (row >= 0) & (row < num_max_scans)
              & (col >= 0) & (col < num_steps))
        n_cells = num_max_scans * num_steps
        flat = torch.where(ok, row.long() * num_steps + col, n_cells)
        grid = torch.full((n_cells + 1,), float("inf"), device=dev)
        grid.scatter_reduce_(0, flat, torch.where(ok, rng, float("inf")),
                             "amin")
        ranges = grid[:-1].reshape(num_max_scans, num_steps)
        buf.ranges = torch.where(torch.isfinite(ranges), ranges,
                                 float("nan"))
        origins = np.tile(np.eye(4, dtype=np.float32), (num_max_scans, 1, 1))
        origins[:, 2, 3] = min_height + (max_height - min_height) * np.arange(
            num_max_scans) / num_vertical_divisions
        buf.origins = torch.as_tensor(origins, device=dev)
        buf.bottom_ += num_vertical_divisions
        return buf

    @staticmethod
    def create_from_depth_image(depth, intrinsic, angle_increment: float,
                                min_y: float, max_y: float,
                                num_vertical_divisions: int = 1,
                                min_range: float = 0.0,
                                max_range: float = np.inf,
                                min_angle: float = -math.pi,
                                max_angle: float = math.pi,
                                depth_scale: float = 1000.0,
                                depth_trunc: float = 1000.0,
                                stride: int = 1
                                ) -> Optional["LaserScanBuffer"]:
        """Depth image to cloud to scan (CreateFromDepthImage,
        laserscanbuffer_factory.cu:146-183): the camera looks along +z,
        the scan plane is the camera's x-z plane with y up."""
        from .pointcloud import PointCloud

        pcd = PointCloud.create_from_depth_image(
            depth, intrinsic, depth_scale=depth_scale,
            depth_trunc=depth_trunc, stride=stride)
        flip = np.asarray([[0.0, 0.0, 1.0, 0.0],
                           [-1.0, 0.0, 0.0, 0.0],
                           [0.0, -1.0, 0.0, 0.0],
                           [0.0, 0.0, 0.0, 1.0]], np.float32)
        pcd.transform(flip)
        return LaserScanBuffer.create_from_point_cloud(
            pcd, angle_increment, min_y, max_y, num_vertical_divisions,
            min_range, max_range, min_angle, max_angle)
