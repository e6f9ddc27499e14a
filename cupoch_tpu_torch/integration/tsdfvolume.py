"""TSDF volume base (cupoch integration/tsdfvolume.h)."""
from __future__ import annotations

import enum


class TSDFVolumeColorType(enum.IntEnum):
    """cupoch tsdfvolume.h (same values)."""

    NoColor = 0
    RGB8 = 1
    Gray32 = 2


class TSDFVolume:
    """Abstract TSDF volume (cupoch tsdfvolume.h)."""

    def __init__(self, voxel_length: float, sdf_trunc: float,
                 color_type: TSDFVolumeColorType):
        self.voxel_length = float(voxel_length)
        self.sdf_trunc = float(sdf_trunc)
        self.color_type = TSDFVolumeColorType(color_type)

    def reset(self):
        raise NotImplementedError

    def integrate(self, image, intrinsic, extrinsic):
        raise NotImplementedError

    def extract_point_cloud(self):
        raise NotImplementedError

    def extract_triangle_mesh(self):
        raise NotImplementedError
