"""Geometry containers."""
from .geometry import Geometry, Geometry3D, GeometryType
from .pointcloud import PointCloud

__all__ = ["Geometry", "Geometry3D", "GeometryType", "PointCloud"]
