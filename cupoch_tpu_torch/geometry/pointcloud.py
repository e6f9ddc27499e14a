"""PointCloud container (cupoch geometry/pointcloud.h): points, normals,
colors and covariances as float32 tensors on one device, with normal
and covariance estimation. The other point-cloud operations
(down-sampling, outlier removal, clustering, segmentation) come with
the slices that use them."""
from __future__ import annotations

import numpy as np

from .. import knn as knn_mod
from ..knn import KDTreeSearchParam, KDTreeSearchParamKNN
from ..utility.shape import bucket_size, pad_axis0, valid_mask
from . import pointcloud_ops as ops
from .geometry import Geometry3D, GeometryType, as_f32


def _pad_cloud(points):
    """(points padded to their bucket size, validity mask)."""
    n = points.shape[0]
    cap = bucket_size(n)
    return pad_axis0(points, cap), valid_mask(n, cap, device=points.device)


class PointCloud(Geometry3D):
    def __init__(self, points=None, device=None):
        super().__init__(GeometryType.PointCloud, device)
        self.points = points if points is not None else np.zeros((0, 3))
        self.normals = None
        self.colors = None
        self.covariances = None

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

    @property
    def colors(self):
        return self._colors

    @colors.setter
    def colors(self, v):
        self._colors = None if v is None else as_f32(v, self.device)

    @property
    def covariances(self):
        return self._covariances

    @covariances.setter
    def covariances(self, v):
        self._covariances = None if v is None \
            else as_f32(v, self.device, (3, 3))

    def _has(self, field) -> bool:
        n = self.points.shape[0]
        return field is not None and field.shape[0] == n and n > 0

    def has_points(self) -> bool:
        return self.points.shape[0] > 0

    def has_normals(self) -> bool:
        return self._has(self.normals)

    def has_colors(self) -> bool:
        return self._has(self.colors)

    def has_covariances(self) -> bool:
        return self._has(self.covariances)

    def __len__(self):
        return int(self.points.shape[0])

    def __repr__(self):
        return f"PointCloud with {len(self)} points on {self.device}."

    def to(self, device) -> "PointCloud":
        """A copy of this cloud on `device`."""
        out = PointCloud(self.points, device=device)
        out.normals = self.normals
        out.colors = self.colors
        out.covariances = self.covariances
        return out

    def _neighbors(self, search_param: KDTreeSearchParam):
        # queries stay unpadded (padding would pile the zero fill into
        # one grid cell); the padded data side is masked instead
        pts, mask = _pad_cloud(self.points)
        idx, _ = knn_mod.search_neighbors(self.points, pts, search_param,
                                          data_mask=mask)
        return pts, idx

    def estimate_normals(self, search_param: KDTreeSearchParam = None):
        """Normals from the covariance of each point's neighbourhood
        (default: its 30 nearest neighbours); their sign is arbitrary."""
        pts, idx = self._neighbors(search_param or KDTreeSearchParamKNN(30))
        cov, cnt = ops.covariances_from_neighbors(pts, idx)
        self.normals = ops.normals_from_covariances(cov, cnt)[:len(self)]
        return True

    def estimate_covariances(self, search_param: KDTreeSearchParam = None):
        """Each point's neighbourhood covariance (default: 30 nearest
        neighbours)."""
        pts, idx = self._neighbors(search_param or KDTreeSearchParamKNN(30))
        cov, _ = ops.covariances_from_neighbors(pts, idx)
        self.covariances = cov[:len(self)]
        return True
