"""Geometry containers: the point cloud, bounding boxes and ISS
keypoints."""
from .boundingvolume import AxisAlignedBoundingBox, OrientedBoundingBox
from .geometry import Geometry, Geometry3D, GeometryType
from .keypoint import compute_iss_keypoints
from .pointcloud import PointCloud

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
    "Geometry3D",
    "GeometryType",
    "PointCloud",
    "AxisAlignedBoundingBox",
    "OrientedBoundingBox",
    "compute_iss_keypoints",
    "KDTreeFlann",
    "KDTreeSearchParam",
    "KDTreeSearchParamKNN",
    "KDTreeSearchParamRadius",
    "KDTreeSearchParamHybrid",
]
