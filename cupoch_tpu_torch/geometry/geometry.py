"""Geometry base classes (cupoch geometry/geometry.h).

Containers hold `torch.Tensor` fields on one device; computation lives
in the functions of `knn` and `registration`.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from ..utility.device import resolve_device


class GeometryType(enum.IntEnum):
    """Matches cupoch's geometry.h values."""

    Unspecified = 0
    PointCloud = 1
    VoxelGrid = 2
    OccupancyGrid = 3
    DistanceTransform = 4
    LineSet = 5
    Graph = 6
    MeshBase = 7
    TriangleMesh = 8
    Image = 9
    RGBDImage = 10
    Map2D = 11
    OrientedBoundingBox = 12
    AxisAlignedBoundingBox = 13
    LaserScanBuffer = 14


def as_f32(x, device: torch.device, shape_suffix=(3,)) -> torch.Tensor:
    """Coerce input (list / numpy / tensor) to float32 [N, *suffix] on
    `device`."""
    if isinstance(x, torch.Tensor):
        a = x.to(device=device, dtype=torch.float32)
    else:
        # a copy: numpy views of other arrays may be read-only
        a = torch.tensor(np.asarray(x, np.float32), device=device)
    if a.ndim == 1 and a.numel() == 0:
        a = a.reshape((0,) + tuple(shape_suffix))
    return a


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, on the card and on the
    CPU alike: taken in float64 and rounded once (PyTorch's vectorised
    float32 sqrt on the CPU is off by an ulp on some inputs)."""
    return torch.sqrt(x.double()).to(torch.float32)


def norm_f32(*cols: torch.Tensor) -> torch.Tensor:
    """sqrt(c0^2 + c1^2 + ...) of float32 columns, summed left to right
    and rounded as `sqrt_f32`."""
    acc = cols[0] * cols[0]
    for c in cols[1:]:
        acc = acc + c * c
    return sqrt_f32(acc)


class Geometry:
    def __init__(self, geometry_type: GeometryType, dimension: int):
        self._geometry_type = GeometryType(geometry_type)
        self._dimension = dimension

    def get_geometry_type(self) -> GeometryType:
        return self._geometry_type

    def dimension(self) -> int:
        return self._dimension


class Geometry3D(Geometry):
    """Base for 3D geometries on one device (`device` defaults to
    "cuda", which must then be available), with the bounds of the
    points a subclass names in `_primary_points`."""

    def __init__(self, geometry_type: GeometryType, device=None):
        super().__init__(geometry_type, 3)
        self.device = resolve_device(device)

    def _primary_points(self) -> torch.Tensor:
        raise NotImplementedError

    def _reduce(self, fn) -> np.ndarray:
        pts = self._primary_points()
        if pts.shape[0] == 0:
            return np.zeros(3, np.float32)
        return fn(pts).cpu().numpy()

    def get_min_bound(self) -> np.ndarray:
        return self._reduce(lambda p: p.amin(0))

    def get_max_bound(self) -> np.ndarray:
        return self._reduce(lambda p: p.amax(0))

    def get_center(self) -> np.ndarray:
        return self._reduce(lambda p: p.mean(0))


class Geometry2D(Geometry):
    """Base for images on one device (`device` defaults to "cuda",
    which must then be available)."""

    def __init__(self, geometry_type: GeometryType, device=None):
        super().__init__(geometry_type, 2)
        self.device = resolve_device(device)
