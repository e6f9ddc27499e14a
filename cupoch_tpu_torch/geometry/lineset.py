"""LineSet container (cupoch geometry/lineset.{h,cu}): points [N, dim]
f32 and [E, 2] int32 line index pairs with per-line colours, on one
device, with the rigid transforms."""
from __future__ import annotations

import numpy as np
import torch

from ..utility import transforms
from ..utility.device import resolve_device
from .boundingvolume import AxisAlignedBoundingBox
from .geometry import Geometry, GeometryType, as_f32

DEFAULT_LINE_COLOR = np.ones(3, np.float32)  # cupoch lineset.h:46


def as_i32(x, device, width: int) -> torch.Tensor:
    """Coerce to int32 [N, width] on `device`."""
    # a copy: numpy views of other arrays may be read-only
    t = x if isinstance(x, torch.Tensor) \
        else torch.tensor(np.asarray(x, np.int32))
    return t.to(device=device, dtype=torch.int32).reshape(-1, width)


class LineSet(Geometry):
    """Lines between points; `dim` is 2 or 3."""

    def __init__(self, points=None, lines=None, dim: int = 3,
                 gtype: GeometryType = GeometryType.LineSet, device=None):
        super().__init__(gtype, dim)
        self.device = resolve_device(device)
        self.dim = dim
        self.points = np.zeros((0, dim), np.float32) if points is None \
            else points
        self.lines = np.zeros((0, 2), np.int32) if lines is None else lines
        self.colors = np.zeros((0, 3), np.float32)

    @property
    def points(self):
        return self._points

    @points.setter
    def points(self, v):
        self._points = as_f32(v, self.device, (self.dim,)).reshape(
            -1, self.dim)

    @property
    def lines(self):
        return self._lines

    @lines.setter
    def lines(self, v):
        self._lines = as_i32(v, self.device, 2)

    @property
    def colors(self):
        return self._colors

    @colors.setter
    def colors(self, v):
        self._colors = as_f32(v, self.device).reshape(-1, 3)

    @staticmethod
    def from_path(path, dim: int = 3, device=None) -> "LineSet":
        """The poly-line through consecutive path points (cupoch
        lineset.h LineSet(path))."""
        path = np.asarray(path, np.float32)
        n = len(path)
        lines = np.stack([np.arange(n - 1), np.arange(1, n)], -1)
        return LineSet(path, lines, dim=dim, device=device)

    @staticmethod
    def from_numpy(points, lines, colors=None, dim: int = 3,
                   device=None) -> "LineSet":
        """A line set holding a saved state: points, lines and colours."""
        out = LineSet(points, lines, dim=dim, device=device)
        if colors is not None:
            out.colors = colors
        return out

    # -- basics ---------------------------------------------------------
    def __repr__(self):
        return (f"LineSet with {int(self.lines.shape[0])} lines and "
                f"{int(self.points.shape[0])} points.")

    def has_points(self) -> bool:
        return self.points.shape[0] > 0

    def has_lines(self) -> bool:
        return self.lines.shape[0] > 0

    def has_colors(self) -> bool:
        return (self.colors.shape[0] > 0
                and self.colors.shape[0] == self.lines.shape[0])

    def is_empty(self) -> bool:
        return not self.has_points()

    def clear(self):
        self.points = np.zeros((0, self.dim), np.float32)
        self.lines = np.zeros((0, 2), np.int32)
        self.colors = np.zeros((0, 3), np.float32)
        return self

    def get_line_coordinate(self, line_index: int):
        li = self.lines[line_index].long()
        return (self.points[li[0]].cpu().numpy(),
                self.points[li[1]].cpu().numpy())

    def _reduce(self, fn) -> np.ndarray:
        if self.is_empty():
            return np.zeros(self.dim, np.float32)
        return fn(self.points).cpu().numpy()

    def get_min_bound(self) -> np.ndarray:
        return self._reduce(lambda p: p.amin(0))

    def get_max_bound(self) -> np.ndarray:
        return self._reduce(lambda p: p.amax(0))

    def get_center(self) -> np.ndarray:
        return self._reduce(lambda p: p.mean(0))

    def get_axis_aligned_bounding_box(self) -> AxisAlignedBoundingBox:
        return AxisAlignedBoundingBox(self.get_min_bound(),
                                      self.get_max_bound(),
                                      device=self.device)

    def paint_uniform_color(self, color):
        self.colors = as_f32(color, self.device).expand(
            int(self.lines.shape[0]), 3).contiguous()
        return self

    # -- transforms -------------------------------------------------------
    def transform(self, T):
        T = as_f32(T, self.device)
        if self.dim == 3:
            self.points = transforms.transform_points(T, self.points)
        else:
            self.points = self.points @ T[:2, :2].T + T[:2, 2]
        return self

    def translate(self, t, relative: bool = True):
        t = as_f32(t, self.device)
        if not relative:
            t = t - self.points.mean(0)
        self.points = self.points + t
        return self

    def scale(self, s: float, center: bool = True):
        if center and self.has_points():
            c = self.points.mean(0)
            self.points = (self.points - c) * s + c
        else:
            self.points = self.points * s
        return self

    def rotate(self, R, center: bool = True):
        R = as_f32(R, self.device)
        if center and self.has_points():
            c = self.points.mean(0)
            self.points = (self.points - c) @ R.T + c
        else:
            self.points = self.points @ R.T
        return self
