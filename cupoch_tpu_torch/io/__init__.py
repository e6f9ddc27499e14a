"""File and message IO (cupoch io/): point clouds, meshes, images, voxel
grids, camera JSON and trajectory logs by extension, and the ROS
message codecs. Readers put their result on `device` (None: the card);
writers take geometry on any device and convert to numpy at the file.
"""
from . import ros
from .image_io import read_image, write_image
from .json_io import (
    read_ijson_convertible_from_json,
    read_pinhole_camera_intrinsic,
    read_pinhole_camera_parameters,
    write_ijson_convertible_to_json,
    write_pinhole_camera_intrinsic,
    write_pinhole_camera_parameters,
)
from .pointcloud_io import read_point_cloud, write_point_cloud
from .trajectory_io import read_trajectory_log, write_trajectory_log
from .trianglemesh_io import read_triangle_mesh, write_triangle_mesh
from .voxelgrid_io import read_voxel_grid, write_voxel_grid

__all__ = [
    "read_voxel_grid",
    "write_voxel_grid",
    "read_point_cloud",
    "write_point_cloud",
    "read_triangle_mesh",
    "write_triangle_mesh",
    "read_image",
    "write_image",
    "read_pinhole_camera_intrinsic",
    "write_pinhole_camera_intrinsic",
    "read_pinhole_camera_parameters",
    "write_pinhole_camera_parameters",
    "read_ijson_convertible_from_json",
    "write_ijson_convertible_to_json",
    "read_trajectory_log",
    "write_trajectory_log",
    "ros",
]
