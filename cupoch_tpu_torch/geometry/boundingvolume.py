"""Axis-aligned and oriented bounding boxes (counterpart of the JAX
package's `geometry/boundingvolume.py`; cupoch boundingvolume.h).

Bounds are f32 tensors on the box's device; `contains_mask` moves them
to the device of the points it tests.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utility import eigen as ueigen
from ..utility import transforms
from ..utility.device import resolve_device
from .geometry import Geometry3D, GeometryType, as_f32

_CORNERS = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
            [1, 1, 1], [0, 1, 1], [1, 0, 1], [1, 1, 0]]
_BIG = 3e38


def _points_on(points, device) -> torch.Tensor:
    """A tensor keeps its device; an array goes to `device` (default
    "cuda")."""
    if isinstance(points, torch.Tensor):
        return as_f32(points, points.device)
    return as_f32(points, resolve_device(device))


class AxisAlignedBoundingBox(Geometry3D):
    def __init__(self, min_bound=(0.0, 0.0, 0.0), max_bound=(0.0, 0.0, 0.0),
                 device=None):
        super().__init__(GeometryType.AxisAlignedBoundingBox, device)
        self.min_bound = as_f32(min_bound, self.device)
        self.max_bound = as_f32(max_bound, self.device)
        self.color = torch.ones(3, device=self.device)

    def _primary_points(self):
        return self.get_box_points()

    def clear(self):
        self.min_bound = torch.zeros(3, device=self.device)
        self.max_bound = torch.zeros(3, device=self.device)
        return self

    def is_empty(self) -> bool:
        return bool((self.max_bound <= self.min_bound).any())

    def get_min_bound(self) -> np.ndarray:
        return self.min_bound.cpu().numpy()

    def get_max_bound(self) -> np.ndarray:
        return self.max_bound.cpu().numpy()

    def get_center(self) -> np.ndarray:
        return ((self.min_bound + self.max_bound) * 0.5).cpu().numpy()

    def get_extent(self) -> np.ndarray:
        return (self.max_bound - self.min_bound).cpu().numpy()

    def get_half_extent(self) -> np.ndarray:
        return self.get_extent() * 0.5

    def get_max_extent(self) -> float:
        return float((self.max_bound - self.min_bound).max())

    def volume(self) -> float:
        return float((self.max_bound - self.min_bound).prod())

    def get_box_points(self) -> torch.Tensor:
        corners = torch.tensor(_CORNERS, dtype=torch.float32,
                               device=self.device)
        return self.min_bound + corners * (self.max_bound - self.min_bound)

    def contains_mask(self, points: torch.Tensor) -> torch.Tensor:
        mn = self.min_bound.to(points.device)
        mx = self.max_bound.to(points.device)
        return ((points >= mn) & (points <= mx)).all(-1)

    def get_point_indices_within_bounding_box(self, points) -> np.ndarray:
        pts = as_f32(points, self.device)
        return np.nonzero(self.contains_mask(pts).cpu().numpy())[0]

    def transform(self, T):
        """The AABB of the transformed corners."""
        pts = transforms.transform_points(as_f32(T, self.device, (4,)),
                                          self.get_box_points())
        self.min_bound = pts.amin(0)
        self.max_bound = pts.amax(0)
        return self

    def translate(self, translation, relative: bool = True):
        t = as_f32(translation, self.device)
        if relative:
            self.min_bound = self.min_bound + t
            self.max_bound = self.max_bound + t
        else:
            half = (self.max_bound - self.min_bound) * 0.5
            self.min_bound = t - half
            self.max_bound = t + half
        return self

    def scale(self, s, center: bool = True):
        if center:
            c = (self.min_bound + self.max_bound) * 0.5
            self.min_bound = (self.min_bound - c) * s + c
            self.max_bound = (self.max_bound - c) * s + c
        else:
            self.min_bound = self.min_bound * s
            self.max_bound = self.max_bound * s
        return self

    @staticmethod
    def create_from_points(points, mask: Optional[torch.Tensor] = None,
                           device=None) -> "AxisAlignedBoundingBox":
        """The box of `points` (the rows `mask` keeps), on the points'
        device when they are a tensor, else on `device`."""
        points = _points_on(points, device)
        if mask is not None:
            m = mask.to(points.device)[:, None]
            mn = torch.where(m, points, _BIG).amin(0)
            mx = torch.where(m, points, -_BIG).amax(0)
        else:
            mn, mx = points.amin(0), points.amax(0)
        return AxisAlignedBoundingBox(mn, mx, device=points.device)

    def __repr__(self):
        return (f"AxisAlignedBoundingBox(min={self.get_min_bound()}, "
                f"max={self.get_max_bound()})")


class OrientedBoundingBox(Geometry3D):
    def __init__(self, center=(0.0, 0.0, 0.0), R=None,
                 extent=(0.0, 0.0, 0.0), device=None):
        super().__init__(GeometryType.OrientedBoundingBox, device)
        self.center = as_f32(center, self.device)
        self.R = torch.eye(3, device=self.device) if R is None \
            else as_f32(R, self.device)
        self.extent = as_f32(extent, self.device)
        self.color = torch.ones(3, device=self.device)

    def _primary_points(self):
        return self.get_box_points()

    def clear(self):
        self.__init__(device=self.device)
        return self

    def is_empty(self) -> bool:
        return bool((self.extent <= 0).all())

    def get_center(self) -> np.ndarray:
        return self.center.cpu().numpy()

    def volume(self) -> float:
        return float(self.extent.prod())

    def get_box_points(self) -> torch.Tensor:
        signs = torch.tensor(_CORNERS, dtype=torch.float32,
                             device=self.device) * 2.0 - 1.0
        return self.center + (signs * (self.extent * 0.5)) @ self.R.T

    def contains_mask(self, points: torch.Tensor) -> torch.Tensor:
        local = (points - self.center.to(points.device)) \
            @ self.R.to(points.device)
        return (local.abs() <= (self.extent * 0.5).to(points.device)).all(-1)

    def get_point_indices_within_bounding_box(self, points) -> np.ndarray:
        pts = as_f32(points, self.device)
        return np.nonzero(self.contains_mask(pts).cpu().numpy())[0]

    def transform(self, T):
        T = as_f32(T, self.device, (4,))
        self.center = transforms.transform_points(T, self.center[None])[0]
        self.R = T[:3, :3] @ self.R
        return self

    def translate(self, translation, relative: bool = True):
        t = as_f32(translation, self.device)
        self.center = self.center + t if relative else t
        return self

    def rotate(self, R, center: bool = True):
        R = as_f32(R, self.device)
        self.R = R @ self.R
        if not center:
            self.center = R @ self.center
        return self

    def scale(self, s, center: bool = True):
        self.extent = self.extent * s
        if not center:
            self.center = self.center * s
        return self

    def get_axis_aligned_bounding_box(self) -> AxisAlignedBoundingBox:
        return AxisAlignedBoundingBox.create_from_points(
            self.get_box_points())

    @staticmethod
    def create_from_points(points, mask: Optional[torch.Tensor] = None,
                           device=None) -> "OrientedBoundingBox":
        """The box along the principal axes of `points` (cupoch
        OrientedBoundingBox::CreateFromPoints), made right-handed."""
        points = _points_on(points, device)
        m = torch.ones(points.shape[0], dtype=torch.bool,
                       device=points.device) if mask is None \
            else mask.to(points.device)
        w = m.to(torch.float32)
        n = w.sum().clamp(min=1.0)
        mean = (points * w[:, None]).sum(0) / n
        centered = (points - mean) * w[:, None]
        _, R = ueigen.symeig3x3(centered.T @ centered / n)
        R = torch.where(torch.linalg.det(R) < 0, -R, R)
        local = (points - mean) @ R
        mn = torch.where(m[:, None], local, _BIG).amin(0)
        mx = torch.where(m[:, None], local, -_BIG).amax(0)
        return OrientedBoundingBox(mean + R @ ((mn + mx) * 0.5), R, mx - mn,
                                   device=points.device)

    def __repr__(self):
        return (f"OrientedBoundingBox(center={self.get_center()}, "
                f"extent={self.extent.cpu().numpy()})")
