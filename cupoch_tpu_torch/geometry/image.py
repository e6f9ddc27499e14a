"""Image and RGBDImage containers (cupoch geometry/image.h,
rgbdimage.h).

An Image wraps one [H, W, C] tensor on one device: float images are
float32, raw sensor images keep uint8 / uint16. The filters come from
`image_ops` and return float32 images.
"""
from __future__ import annotations

import enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utility import console
from . import image_ops as ops
from .geometry import Geometry2D, GeometryType


class FilterType(enum.IntEnum):
    """cupoch image.h (same values)."""

    Gaussian3 = 0
    Gaussian5 = 1
    Gaussian7 = 2
    Sobel3Dx = 3
    Sobel3Dy = 4


_FILTERS = {
    FilterType.Gaussian3: ops.filter_gaussian3,
    FilterType.Gaussian5: ops.filter_gaussian5,
    FilterType.Gaussian7: ops.filter_gaussian7,
    FilterType.Sobel3Dx: ops.filter_sobel_dx,
    FilterType.Sobel3Dy: ops.filter_sobel_dy,
}


class Image(Geometry2D):
    """2D image over a [H, W, C] tensor (cupoch image.h). `data` may be
    a numpy array or a tensor; a 2-D one gets a channel axis. Without
    `device`, a tensor keeps its own device and other data goes to the
    card."""

    def __init__(self, data=None, device=None):
        if device is None and isinstance(data, torch.Tensor):
            device = data.device
        super().__init__(GeometryType.Image, device)
        if data is None:
            self.data = torch.zeros((0, 0, 1), dtype=torch.float32,
                                    device=self.device)
        else:
            d = data if isinstance(data, torch.Tensor) \
                else torch.from_numpy(np.array(data))
            d = d.to(self.device)
            self.data = d[..., None] if d.ndim == 2 else d

    def _new(self, data: torch.Tensor) -> "Image":
        return Image(data, device=self.device)

    def _f32(self) -> torch.Tensor:
        return self.data.to(torch.float32)

    # -- cupoch-compatible metadata ------------------------------------
    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def height(self) -> int:
        return int(self.data.shape[0])

    @property
    def num_of_channels(self) -> int:
        return int(self.data.shape[2])

    @property
    def bytes_per_channel(self) -> int:
        return int(self.data.element_size())

    def is_empty(self) -> bool:
        return self.width == 0 or self.height == 0

    def has_data(self) -> bool:
        return not self.is_empty()

    def clear(self):
        self.data = torch.zeros((0, 0, 1), dtype=torch.float32,
                                device=self.device)
        return self

    def __repr__(self):
        return (f"Image of size {self.width}x{self.height}, with "
                f"{self.num_of_channels} channels ({self.data.dtype}) on "
                f"{self.device}.")

    def get_min_bound(self):
        return np.zeros(2, np.float32)

    def get_max_bound(self):
        return np.asarray([self.width, self.height], np.float32)

    # -- conversions ----------------------------------------------------
    def create_float_image(self) -> "Image":
        """cupoch image_factory.cu CreateFloatImage: uint8 / uint16 scaled
        to [0, 1]; three channels become one intensity."""
        f = self._f32()
        if self.data.dtype == torch.uint8:
            f = f / 255.0
        elif self.data.dtype == torch.uint16:
            f = f / 65535.0
        if f.shape[2] >= 3:
            f = ops.color_to_intensity(f[..., :3])
        return self._new(f)

    def create_gray_image(self) -> "Image":
        f = self._f32()
        if f.shape[2] >= 3:
            f = ops.color_to_intensity(f[..., :3])
        return self._new(f)

    # -- ops ------------------------------------------------------------
    def filter(self, filter_type: FilterType) -> "Image":
        """cupoch image.cu Image::Filter."""
        if self.num_of_channels != 1:
            console.log_warning(
                "[filter] multi-channel filter applied per channel.")
        return self._new(_FILTERS[FilterType(filter_type)](self._f32()))

    def filter_bilateral(self, diameter: int = 5, sigma_color: float = 0.05,
                         sigma_space: float = 10.0) -> "Image":
        return self._new(ops.filter_bilateral(
            self._f32(), diameter, sigma_color, sigma_space))

    def downsample(self) -> "Image":
        return self._new(ops.downsample2(self._f32()))

    def dilate(self, half_kernel_size: int = 1) -> "Image":
        return self._new(ops.dilate(self._f32(), half_kernel_size))

    def flip_horizontal(self) -> "Image":
        return self._new(ops.flip_horizontal(self.data))

    def flip_vertical(self) -> "Image":
        return self._new(ops.flip_vertical(self.data))

    def transpose(self) -> "Image":
        return self._new(ops.transpose(self.data))

    def linear_transform(self, scale: float = 1.0,
                         offset: float = 0.0) -> "Image":
        return self._new(ops.linear_transform(self._f32(), scale, offset))

    def clip_intensity(self, min_v: float = 0.0,
                       max_v: float = 1.0) -> "Image":
        return self._new(ops.clip_intensity(self._f32(), min_v, max_v))

    def float_value_at(self, u: float, v: float) -> Tuple[bool, float]:
        ok = 0.0 <= u <= self.width - 1 and 0.0 <= v <= self.height - 1
        val = float(ops.float_value_at(self._f32(), np.float32(u),
                                       np.float32(v)))
        return ok, val

    def create_pyramid(self, num_of_levels: int,
                       with_gaussian_filter: bool = True) -> List["Image"]:
        """cupoch image.cu CreatePyramid: each level the last one
        (Gaussian3-filtered if asked) down-sampled 2x."""
        pyr = [self._new(self._f32())]
        for _ in range(1, num_of_levels):
            prev = pyr[-1]
            img = prev.filter(FilterType.Gaussian3) if with_gaussian_filter \
                else prev
            pyr.append(img.downsample())
        return pyr

    @staticmethod
    def filter_pyramid(pyramid: List["Image"],
                       filter_type: FilterType) -> List["Image"]:
        return [im.filter(filter_type) for im in pyramid]

    def create_depth_to_camera_distance_multiplier_float_image(
            self, intrinsic) -> "Image":
        return self._new(ops.depth_to_camera_distance_multiplier(
            self.width, self.height, intrinsic.intrinsic_matrix,
            self.device))

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    @staticmethod
    def from_numpy(arr, device=None) -> "Image":
        return Image(arr, device=device)


class RGBDImage(Geometry2D):
    """Colour + depth pair (cupoch rgbdimage.h). Without `device` the
    pair lies on the colour image's device, or on the card when there is
    no colour image."""

    def __init__(self, color: Optional[Image] = None,
                 depth: Optional[Image] = None, device=None):
        if device is None and color is not None:
            device = color.device
        super().__init__(GeometryType.RGBDImage, device)
        self.color = color if color is not None else Image(device=self.device)
        self.depth = depth if depth is not None else Image(device=self.device)

    def is_empty(self) -> bool:
        return self.color.is_empty() or self.depth.is_empty()

    def clear(self):
        self.color.clear()
        self.depth.clear()
        return self

    def __repr__(self):
        return (f"RGBDImage of size \nColor image : {self.color!r}\n"
                f"Depth image : {self.depth!r}")

    def to(self, device) -> "RGBDImage":
        """This pair on `device` (itself when it lies there already)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return RGBDImage(Image(self.color.data, device=device),
                         Image(self.depth.data, device=device), device)

    @staticmethod
    def create_from_color_and_depth(
            color: Image, depth: Image, depth_scale: float = 1000.0,
            depth_trunc: float = 3.0,
            convert_rgb_to_intensity: bool = True) -> "RGBDImage":
        """cupoch rgbdimage_factory.cu CreateFromColorAndDepth: depth /
        depth_scale in metres, 0 beyond depth_trunc."""
        if convert_rgb_to_intensity:
            c = color.create_float_image()
        else:
            c = color._f32()
            if color.data.dtype == torch.uint8:
                c = c / 255.0
            c = color._new(c)
        d = depth._f32() / torch.tensor(depth_scale, dtype=torch.float32,
                                        device=depth.device)
        d = torch.where(d > depth_trunc, 0.0, d)
        return RGBDImage(c, depth._new(d))

    @staticmethod
    def create_from_tum_format(color: Image, depth: Image,
                               convert_rgb_to_intensity: bool = True
                               ) -> "RGBDImage":
        """TUM: depth_scale 5000, truncated at 4 m."""
        return RGBDImage.create_from_color_and_depth(
            color, depth, 5000.0, 4.0, convert_rgb_to_intensity)

    @staticmethod
    def create_from_redwood_format(color: Image, depth: Image,
                                   convert_rgb_to_intensity: bool = True
                                   ) -> "RGBDImage":
        return RGBDImage.create_from_color_and_depth(
            color, depth, 1000.0, 4.0, convert_rgb_to_intensity)

    @staticmethod
    def create_from_nyu_format(color: Image, depth: Image,
                               convert_rgb_to_intensity: bool = True
                               ) -> "RGBDImage":
        return RGBDImage.create_from_color_and_depth(
            color, depth, 1000.0, 7.0, convert_rgb_to_intensity)

    def create_pyramid(self, num_of_levels: int,
                       with_gaussian_filter_for_color: bool = True,
                       with_gaussian_filter_for_depth: bool = False
                       ) -> List["RGBDImage"]:
        """cupoch rgbdimage.cu CreatePyramid (depth unsmoothed by
        default)."""
        cp = self.color.create_pyramid(num_of_levels,
                                       with_gaussian_filter_for_color)
        dp = self.depth.create_pyramid(num_of_levels,
                                       with_gaussian_filter_for_depth)
        return [RGBDImage(c, d) for c, d in zip(cp, dp)]
