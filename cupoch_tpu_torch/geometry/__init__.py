"""Geometry containers: the point cloud, images and RGB-D pairs, the
triangle mesh, bounding boxes, ISS keypoints, voxel and occupancy grids,
the distance transform, laser scans, line sets, graphs and 2D maps."""
from . import intersection_test
from .boundingvolume import AxisAlignedBoundingBox, OrientedBoundingBox
from .distancetransform import DistanceTransform
from .geometry import Geometry, Geometry2D, Geometry3D, GeometryType
from .graph import Graph, SSSPResult
from .image import FilterType, Image, RGBDImage
from .keypoint import compute_iss_keypoints
from .laserscanbuffer import LaserScanBuffer
from .lineset import LineSet
from .map2d import Map2D
from .occupancygrid import OccupancyGrid, OccupancyVoxel
from .pointcloud import PointCloud
from .trianglemesh import MeshBase, TriangleMesh
from .voxelgrid import Voxel, VoxelGrid

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
    "Voxel",
    "VoxelGrid",
    "OccupancyGrid",
    "OccupancyVoxel",
    "DistanceTransform",
    "LaserScanBuffer",
    "Map2D",
    "compute_iss_keypoints",
    "LineSet",
    "Graph",
    "SSSPResult",
    "intersection_test",
    "KDTreeFlann",
    "KDTreeSearchParam",
    "KDTreeSearchParamKNN",
    "KDTreeSearchParamRadius",
    "KDTreeSearchParamHybrid",
]
