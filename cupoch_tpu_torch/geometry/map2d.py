"""Map2D: a 2D occupancy image with a metric cell size and origin
(cupoch geometry/map2d.h:27, map2d.cu), with the reference's few
operations."""
from __future__ import annotations

import numpy as np

from ..utility import console
from .geometry import Geometry2D, GeometryType
from .image import Image


class Map2D(Geometry2D):
    def __init__(self, map_image: Image = None, cell_size: float = 0.05,
                 origin=(0.0, 0.0), device=None):
        if device is None and map_image is not None:
            device = map_image.device
        super().__init__(GeometryType.Map2D, device)
        self.map = map_image if map_image is not None \
            else Image(device=self.device)
        self.cell_size = float(cell_size)
        self.origin = np.array(origin, np.float32)

    def clear(self):
        self.map.clear()
        return self

    def is_empty(self) -> bool:
        return not self.map.has_data()

    def get_min_bound(self):
        return np.zeros(2, np.float32)

    def get_max_bound(self):
        # map2d.cu:44-46, the width + width included
        return np.asarray([self.map.width + self.map.width,
                           self.map.height], np.float32)

    def get_center(self):
        return np.asarray([self.map.width, self.map.height],
                          np.float32) * 0.5 + self.origin

    def get_axis_aligned_bounding_box(self):
        console.log_error("Map2D::GetAxisAlignedBoundingBox is not supported")

    def transform(self, T):
        console.log_error("Map2D::Transform is not supported")

    def translate(self, translation, relative: bool = True):
        t = np.asarray(translation, np.float32)
        self.origin = self.origin + t if relative else t
        return self

    def scale(self, s: float, center: bool = True):
        self.cell_size *= float(s)
        return self

    def rotate(self, R, center: bool = True):
        console.log_error("Map2D::Rotate is not supported")

    def __repr__(self):
        return (f"Map2D of {self.map.width}x{self.map.height} cells, "
                f"cell_size {self.cell_size}")
