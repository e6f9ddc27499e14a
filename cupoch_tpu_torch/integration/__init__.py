"""Volumetric TSDF integration (cupoch integration/): the dense uniform
volume and the block-hashed scalable volume."""
from .scalable_tsdfvolume import ScalableTSDFVolume
from .tsdfvolume import TSDFVolume, TSDFVolumeColorType
from .uniform_tsdfvolume import UniformTSDFVolume

__all__ = ["ScalableTSDFVolume", "TSDFVolume", "TSDFVolumeColorType",
           "UniformTSDFVolume"]
