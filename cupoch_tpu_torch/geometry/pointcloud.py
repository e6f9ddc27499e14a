"""PointCloud container (cupoch geometry/pointcloud.h): points and
normals as float32 tensors on one device. Only this half of the
container is ported so far; colors, covariances and the point-cloud
operations come with the slices that use them."""
from __future__ import annotations

import numpy as np

from .geometry import Geometry3D, GeometryType, as_f32


class PointCloud(Geometry3D):
    def __init__(self, points=None, device=None):
        super().__init__(GeometryType.PointCloud, device)
        self.points = points if points is not None else np.zeros((0, 3))
        self.normals = None

    @property
    def points(self):
        return self._points

    @points.setter
    def points(self, v):
        self._points = as_f32(v, self.device)

    @property
    def normals(self):
        return self._normals

    @normals.setter
    def normals(self, v):
        self._normals = None if v is None else as_f32(v, self.device)

    def has_points(self) -> bool:
        return self.points.shape[0] > 0

    def has_normals(self) -> bool:
        n = self.points.shape[0]
        return self.normals is not None and self.normals.shape[0] == n \
            and n > 0

    def __len__(self):
        return int(self.points.shape[0])

    def __repr__(self):
        return f"PointCloud with {len(self)} points on {self.device}."

    def to(self, device) -> "PointCloud":
        """A copy of this cloud on `device`."""
        out = PointCloud(self.points, device=device)
        out.normals = self.normals
        return out
