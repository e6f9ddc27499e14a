"""Volumetric TSDF integration (cupoch integration/): the dense uniform
volume."""
from .tsdfvolume import TSDFVolume, TSDFVolumeColorType
from .uniform_tsdfvolume import UniformTSDFVolume

__all__ = ["TSDFVolume", "TSDFVolumeColorType", "UniformTSDFVolume"]
