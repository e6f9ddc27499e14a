"""PointCloud container (cupoch geometry/pointcloud.h): points, normals,
colors and covariances as float32 tensors on one device, with the
point-cloud operations of the JAX package's `PointCloud`: transforms,
selection and cropping, down-sampling, outlier removal, filters,
normals and their orientation, DBSCAN and RANSAC plane segmentation,
and the depth, RGB-D and disparity factories (`pointcloud_factory`).
The methods call the functions of `pointcloud_ops` on the cloud's
device and return results at their exact size; index and label
results come back as numpy arrays, as in the JAX package."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import knn as knn_mod
from ..knn import KDTreeSearchParam, KDTreeSearchParamKNN
from ..utility import console, transforms
from ..utility.shape import bucket_size, pad_axis0, valid_mask
from . import pointcloud_ops as ops
from .boundingvolume import AxisAlignedBoundingBox, OrientedBoundingBox
from .geometry import Geometry3D, GeometryType, as_f32


def _pad_cloud(points):
    """(points padded to their bucket size, validity mask)."""
    n = points.shape[0]
    cap = bucket_size(n)
    return pad_axis0(points, cap), valid_mask(n, cap, device=points.device)


class PointCloud(Geometry3D):
    def __init__(self, points=None, device=None):
        super().__init__(GeometryType.PointCloud, device)
        self.points = points if points is not None else np.zeros((0, 3))
        self.normals = None
        self.colors = None
        self.covariances = None

    @property
    def points(self):
        return self._points

    @points.setter
    def points(self, v):
        self._points = as_f32(v, self.device)

    @property
    def normals(self):
        return self._normals

    @normals.setter
    def normals(self, v):
        self._normals = None if v is None else as_f32(v, self.device)

    @property
    def colors(self):
        return self._colors

    @colors.setter
    def colors(self, v):
        self._colors = None if v is None else as_f32(v, self.device)

    @property
    def covariances(self):
        return self._covariances

    @covariances.setter
    def covariances(self, v):
        self._covariances = None if v is None \
            else as_f32(v, self.device, (3, 3))

    def _primary_points(self):
        return self.points

    def _has(self, field) -> bool:
        n = self.points.shape[0]
        return field is not None and field.shape[0] == n and n > 0

    def has_points(self) -> bool:
        return self.points.shape[0] > 0

    def has_normals(self) -> bool:
        return self._has(self.normals)

    def has_colors(self) -> bool:
        return self._has(self.colors)

    def has_covariances(self) -> bool:
        return self._has(self.covariances)

    def __len__(self):
        return int(self.points.shape[0])

    def __repr__(self):
        return f"PointCloud with {len(self)} points on {self.device}."

    def clear(self):
        self.points = np.zeros((0, 3), np.float32)
        self.normals = self.colors = self.covariances = None
        return self

    def is_empty(self) -> bool:
        return not self.has_points()

    def to(self, device) -> "PointCloud":
        """A copy of this cloud on `device`."""
        out = PointCloud(self.points, device=device)
        out.normals = self.normals
        out.colors = self.colors
        out.covariances = self.covariances
        return out

    def _new(self, points) -> "PointCloud":
        return PointCloud(points, device=self.device)

    # -- simple ops -------------------------------------------------------
    def normalize_normals(self):
        if self.has_normals():
            n = self.normals
            self.normals = n / torch.linalg.norm(
                n, dim=-1, keepdim=True).clamp(min=1e-12)
        return self

    def paint_uniform_color(self, color):
        self.colors = as_f32(color, self.device).expand(len(self), 3) \
            .contiguous()
        return self

    def transform(self, T):
        """Apply a 4x4 transform: points move, normals and covariances
        turn with it."""
        T = as_f32(T, self.device, (4,))
        self.points = transforms.transform_points(T, self.points)
        if self.has_normals():
            self.normals = transforms.rotate_normals(T, self.normals)
        if self.has_covariances():
            R = T[:3, :3]
            self.covariances = torch.einsum("ij,njk,lk->nil", R,
                                            self.covariances, R)
        return self

    def translate(self, translation, relative: bool = True):
        t = as_f32(translation, self.device)
        if relative:
            self.points = self.points + t
        else:
            self.points = self.points - self.points.mean(0) + t
        return self

    def scale(self, s, center: bool = True):
        if center:
            c = self.points.mean(0)
            self.points = (self.points - c) * s + c
        else:
            self.points = self.points * s
        return self

    def rotate(self, R, center: bool = True):
        R = as_f32(R, self.device)
        if center:
            c = self.points.mean(0)
            self.points = (self.points - c) @ R.T + c
        else:
            self.points = self.points @ R.T
        if self.has_normals():
            self.normals = self.normals @ R.T
        return self

    def __iadd__(self, other: "PointCloud"):
        """In place, as `+`: covariances are dropped, as in the JAX
        package."""
        merged = self + other
        self.points = merged.points
        self.normals = merged.normals
        self.colors = merged.colors
        return self

    def __add__(self, other: "PointCloud") -> "PointCloud":
        out = self._new(torch.cat([self.points,
                                   other.points.to(self.device)], 0))
        if self.has_normals() and other.has_normals():
            out.normals = torch.cat([self.normals,
                                     other.normals.to(self.device)], 0)
        if self.has_colors() and other.has_colors():
            out.colors = torch.cat([self.colors,
                                    other.colors.to(self.device)], 0)
        return out

    # -- bounding volumes -------------------------------------------------
    def get_axis_aligned_bounding_box(self) -> AxisAlignedBoundingBox:
        return AxisAlignedBoundingBox.create_from_points(self.points)

    def get_oriented_bounding_box(self) -> OrientedBoundingBox:
        return OrientedBoundingBox.create_from_points(self.points)

    # -- selection / crop -------------------------------------------------
    def select_by_index(self, indices, invert: bool = False) -> "PointCloud":
        idx = np.asarray(indices, np.int64)
        if invert:
            keep = np.ones(len(self), bool)
            keep[idx] = False
            idx = np.nonzero(keep)[0]
        return self._gather(idx)

    def select_by_mask(self, mask, invert: bool = False) -> "PointCloud":
        m = torch.as_tensor(np.asarray(mask, bool) if not isinstance(
            mask, torch.Tensor) else mask).to(self.device, torch.bool)
        if invert:
            m = ~m
        return self._gather(torch.nonzero(m)[:, 0])

    def _gather(self, idx) -> "PointCloud":
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        out = self._new(self.points[idx])
        for name in ("normals", "colors", "covariances"):
            if self._has(getattr(self, name)):
                setattr(out, name, getattr(self, name)[idx])
        return out

    def crop(self, bbox) -> "PointCloud":
        return self.select_by_mask(bbox.contains_mask(self.points))

    # -- down-sampling ----------------------------------------------------
    def voxel_down_sample(self, voxel_size: float) -> "PointCloud":
        if voxel_size <= 0:
            console.log_warning("[voxel_down_sample] voxel_size <= 0.")
            return self._new(None)
        pts, normals, colors = ops.voxel_down_sample(
            self.points, voxel_size,
            self.normals if self.has_normals() else None,
            self.colors if self.has_colors() else None)
        out = self._new(pts)
        out.normals, out.colors = normals, colors
        return out

    def uniform_down_sample(self, every_k_points: int) -> "PointCloud":
        if every_k_points == 0:
            console.log_error("[uniform_down_sample] Illegal sample rate.")
        return self._gather(np.arange(0, len(self), every_k_points))

    def farthest_point_down_sample(self, num_samples: int) -> "PointCloud":
        num_samples = min(num_samples, len(self))
        return self._gather(ops.farthest_point_indices(self.points,
                                                       num_samples))

    # -- outlier removal --------------------------------------------------
    def _kept(self, keep) -> Tuple["PointCloud", np.ndarray]:
        idx = torch.nonzero(keep)[:, 0]
        return self._gather(idx), idx.cpu().numpy()

    def remove_radius_outliers(self, nb_points: int, search_radius: float):
        """(the cloud of points with more than `nb_points` neighbours
        within `search_radius`, their indices)."""
        if nb_points < 1 or search_radius <= 0:
            console.log_error(
                "[remove_radius_outliers] Illegal input parameters")
        return self._kept(ops.radius_outlier_mask(self.points, nb_points,
                                                  search_radius))

    def remove_statistical_outliers(self, nb_neighbors: int,
                                    std_ratio: float):
        """(the cloud of points whose mean k-NN distance passes the
        statistical test, their indices)."""
        if nb_neighbors < 1 or std_ratio <= 0:
            console.log_error(
                "[remove_statistical_outliers] Illegal input parameters")
        return self._kept(ops.statistical_outlier_mask(
            self.points, nb_neighbors, std_ratio))

    # -- filters ----------------------------------------------------------
    def gaussian_filter(self, search_radius: float, sigma2: float,
                        max_nn: int = 32) -> "PointCloud":
        res = self._new(ops.gaussian_filter(self.points, search_radius,
                                            sigma2, max_nn))
        res.normals, res.colors = self.normals, self.colors
        return res

    def pass_through_filter(self, axis_no: int, min_bound: float,
                            max_bound: float) -> "PointCloud":
        return self.select_by_mask(ops.pass_through_filter_mask(
            self.points, axis_no, min_bound, max_bound))

    # -- normals ----------------------------------------------------------
    def _neighbors(self, search_param: KDTreeSearchParam):
        # queries stay unpadded (padding would pile the zero fill into
        # one grid cell); the padded data side is masked instead
        pts, mask = _pad_cloud(self.points)
        idx, _ = knn_mod.search_neighbors(self.points, pts, search_param,
                                          data_mask=mask)
        return pts, idx

    def estimate_normals(self, search_param: KDTreeSearchParam = None):
        """Normals from the covariance of each point's neighbourhood
        (default: its 30 nearest neighbours); their sign is arbitrary."""
        pts, idx = self._neighbors(search_param or KDTreeSearchParamKNN(30))
        cov, cnt = ops.covariances_from_neighbors(pts, idx)
        self.normals = ops.normals_from_covariances(cov, cnt)[:len(self)]
        return True

    def estimate_covariances(self, search_param: KDTreeSearchParam = None):
        """Each point's neighbourhood covariance (default: 30 nearest
        neighbours)."""
        pts, idx = self._neighbors(search_param or KDTreeSearchParamKNN(30))
        cov, _ = ops.covariances_from_neighbors(pts, idx)
        self.covariances = cov[:len(self)]
        return True

    def _need_normals(self):
        if not self.has_normals():
            console.log_error("[orient_normals] No normals in the PointCloud.")

    def orient_normals_to_align_with_direction(
            self, orientation_reference=(0.0, 0.0, 1.0)):
        self._need_normals()
        self.normals = ops.orient_normals_to_align_with_direction(
            self.normals, orientation_reference)
        return True

    def orient_normals_towards_camera_location(
            self, camera_location=(0.0, 0.0, 0.0)):
        self._need_normals()
        self.normals = ops.orient_normals_towards_camera_location(
            self.points, self.normals, camera_location)
        return True

    # -- clustering / segmentation -----------------------------------------
    def cluster_dbscan(self, eps: float, min_points: int,
                       print_progress: bool = False) -> np.ndarray:
        """[N] cluster labels 0..C-1, -1 for noise."""
        return ops.densify_labels(
            ops.cluster_dbscan(self.points, eps, min_points).cpu().numpy())

    def segment_plane(self, distance_threshold: float, ransac_n: int = 3,
                      num_iterations: int = 100, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(plane [a, b, c, d] with ax + by + cz + d = 0, inlier indices)
        of the best of `num_iterations` planes through random triples,
        drawn on the host from `seed` (`pointcloud_ops.plane_triples`)."""
        triples = ops.plane_triples(len(self), num_iterations, seed)
        plane, inl = ops.score_planes(self.points, triples,
                                      distance_threshold)
        return (plane.cpu().numpy(),
                torch.nonzero(inl)[:, 0].cpu().numpy())

    # -- factories (pointcloud_factory) ----------------------------------
    @staticmethod
    def create_from_depth_image(depth, intrinsic, extrinsic=None,
                                depth_scale: float = 1000.0,
                                depth_trunc: float = 1000.0,
                                stride: int = 1, device=None
                                ) -> "PointCloud":
        from . import pointcloud_factory as factory

        return factory.create_from_depth_image(
            depth, intrinsic, extrinsic, depth_scale, depth_trunc, stride,
            device)

    @staticmethod
    def create_from_rgbd_image(image, intrinsic, extrinsic=None,
                               project_valid_depth_only: bool = True,
                               depth_cutoff: float = -1.0,
                               compute_normals: bool = False
                               ) -> "PointCloud":
        from . import pointcloud_factory as factory

        return factory.create_from_rgbd_image(
            image, intrinsic, extrinsic, project_valid_depth_only,
            depth_cutoff, compute_normals)

    @staticmethod
    def create_from_disparity(disp, color, left_intrinsic, right_intrinsic,
                              baseline: float, device=None) -> "PointCloud":
        from . import pointcloud_factory as factory

        return factory.create_from_disparity(
            disp, color, left_intrinsic, right_intrinsic, baseline, device)

    @staticmethod
    def create_from_laserscanbuffer(scan, min_range: float,
                                    max_range: float) -> "PointCloud":
        from . import pointcloud_factory as factory

        return factory.create_from_laserscanbuffer(scan, min_range,
                                                   max_range)

    @staticmethod
    def create_from_occupancygrid(occgrid) -> "PointCloud":
        from . import pointcloud_factory as factory

        return factory.create_from_occupancygrid(occgrid)

    # -- numpy bridge -------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return self.points.cpu().numpy()

    @staticmethod
    def from_numpy(arr, device=None) -> "PointCloud":
        return PointCloud(np.asarray(arr, np.float32), device=device)
