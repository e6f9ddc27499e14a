"""Geometry containers: the point cloud, images and RGB-D pairs, the
triangle mesh, bounding boxes and ISS keypoints."""
from .boundingvolume import AxisAlignedBoundingBox, OrientedBoundingBox
from .geometry import Geometry, Geometry2D, Geometry3D, GeometryType
from .image import FilterType, Image, RGBDImage
from .keypoint import compute_iss_keypoints
from .pointcloud import PointCloud
from .trianglemesh import MeshBase, TriangleMesh

# the KDTree classes, under geometry as well (cupoch's API)
from ..knn import (
    KDTreeFlann,
    KDTreeSearchParam,
    KDTreeSearchParamHybrid,
    KDTreeSearchParamKNN,
    KDTreeSearchParamRadius,
)

__all__ = [
    "Geometry",
    "Geometry2D",
    "Geometry3D",
    "GeometryType",
    "PointCloud",
    "TriangleMesh",
    "MeshBase",
    "Image",
    "RGBDImage",
    "FilterType",
    "AxisAlignedBoundingBox",
    "OrientedBoundingBox",
    "compute_iss_keypoints",
    "KDTreeFlann",
    "KDTreeSearchParam",
    "KDTreeSearchParamKNN",
    "KDTreeSearchParamRadius",
    "KDTreeSearchParamHybrid",
]
