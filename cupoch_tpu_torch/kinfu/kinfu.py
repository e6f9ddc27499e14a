"""KinectFusion (cupoch kinfu/kinfu.h, kinfu.cpp).

Each frame: a bilateral-filtered RGB-D pyramid and a point cloud with
normals a level (surface measurement), coarse-to-fine frame-to-model
point-to-plane ICP against the model's raycast pyramid (pose
estimation), TSDF integration of the frame, and a new raycast of every
level. The device work is in the volume, the factories and
`registration_icp`; the host runs the levels and keeps the pose, a 4x4
f32 camera-to-world matrix.

Spans (`utility/trace.py`): `kinfu.frame` (root; `frame`, `tracked`)
holds `kinfu.surface`, `kinfu.track` with a `kinfu.track.level` a level
(`level`, `points`, `target_points`, `iterations`, `branch`, the
`registration.*` spans inside), `kinfu.integrate` and a `kinfu.raycast`
a level (`level`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..camera import PinholeCameraIntrinsic
from ..geometry import PointCloud, RGBDImage
from ..integration import TSDFVolumeColorType, UniformTSDFVolume
from ..registration import (
    ICPConvergenceCriteria,
    TransformationEstimationPointToPlane,
    TransformationEstimationType,
    registration_colored_icp,
    registration_icp,
)
from ..utility import console, trace


class KinfuOption:
    """cupoch kinfu.h (same defaults)."""

    def __init__(self,
                 num_pyramid_levels: int = 4,
                 diameter: int = 1,
                 sigma_depth: float = 1.0,
                 sigma_space: float = 10.0,
                 depth_cutoff: float = 3.0,
                 tsdf_length: float = 8.0,
                 tsdf_resolution: int = 512,
                 sdf_trunc: float = 0.05,
                 tsdf_color_type: TSDFVolumeColorType =
                 TSDFVolumeColorType.RGB8,
                 tsdf_origin=(0.0, 0.0, 0.0),
                 distance_threshold: float = 0.5,
                 icp_iterations: Optional[List[int]] = None,
                 tf_type: TransformationEstimationType =
                 TransformationEstimationType.PointToPlane):
        self.num_pyramid_levels = int(num_pyramid_levels)
        self.diameter = int(diameter)
        self.sigma_depth = float(sigma_depth)
        self.sigma_space = float(sigma_space)
        self.depth_cutoff = float(depth_cutoff)
        self.tsdf_length = float(tsdf_length)
        self.tsdf_resolution = int(tsdf_resolution)
        self.sdf_trunc = float(sdf_trunc)
        self.tsdf_color_type = tsdf_color_type
        self.tsdf_origin = np.asarray(tsdf_origin, np.float32)
        self.distance_threshold = float(distance_threshold)
        self.icp_iterations = (list(icp_iterations)
                               if icp_iterations is not None
                               else [20, 20, 20, 20])
        self.tf_type = tf_type


class KinfuPipeline:
    """cupoch KinfuPipeline, with its volume on `device` (None: the
    card)."""

    def __init__(self, intrinsic: PinholeCameraIntrinsic,
                 option: Optional[KinfuOption] = None, device=None):
        self.intrinsic = intrinsic
        self.option = option or KinfuOption()
        self.volume = UniformTSDFVolume(
            self.option.tsdf_length, self.option.tsdf_resolution,
            self.option.sdf_trunc, self.option.tsdf_color_type,
            self.option.tsdf_origin, device)
        self.device = self.volume.device
        self.model_pyramid: List[Optional[PointCloud]] = \
            [None] * self.option.num_pyramid_levels
        self.cur_pose = np.eye(4, dtype=np.float32)
        self.frame_id = 0

    def reset(self):
        """cupoch KinfuPipeline::Reset."""
        self.cur_pose = np.eye(4, dtype=np.float32)
        self.volume.reset()
        self.model_pyramid = [None] * self.option.num_pyramid_levels
        self.frame_id = 0

    def process_frame(self, image: RGBDImage) -> bool:
        """cupoch KinfuPipeline::ProcessFrame; False for an empty frame or
        a lost track."""
        with trace.span("kinfu.frame", frame=self.frame_id):
            tracked = self._process_frame(image)
            trace.set_attrs(tracked=tracked)
            return tracked

    def _process_frame(self, image: RGBDImage) -> bool:
        if image.color is None or image.depth is None \
                or not image.color.has_data() or not image.depth.has_data():
            return False
        with trace.span("kinfu.surface"):
            _, smooth_pyramid, pc_pyramid = self.surface_measurement(
                image.to(self.device))
        if self.frame_id > 0:
            # the frame's clouds are in the camera frame and the model
            # in the world frame: ICP gives the camera-to-world pose
            with trace.span("kinfu.track"):
                pose, ok = self.pose_estimation(
                    self.cur_pose, pc_pyramid, self.model_pyramid)
            if not ok:
                return False
            self.cur_pose = pose
        extrinsic = np.linalg.inv(self.cur_pose).astype(np.float32)
        with trace.span("kinfu.integrate"):
            self.volume.integrate(smooth_pyramid[0], self.intrinsic,
                                  extrinsic)
        for i in range(self.option.num_pyramid_levels):
            with trace.span("kinfu.raycast", level=i):
                self.model_pyramid[i] = self.volume.raycast(
                    self.intrinsic.scale(0.5 ** i), extrinsic,
                    self.option.sdf_trunc)
        self.frame_id += 1
        return True

    def extract_point_cloud(self) -> PointCloud:
        return self.volume.extract_point_cloud()

    def extract_triangle_mesh(self):
        return self.volume.extract_triangle_mesh()

    # -- stages --------------------------------------------------------
    def surface_measurement(self, image: RGBDImage
                            ) -> Tuple[list, list, list]:
        """The RGB-D pyramid, its depth bilateral-filtered, and a cloud
        with normals a level (cupoch SurfaceMeasurement)."""
        opt = self.option
        img_pyramid = image.create_pyramid(opt.num_pyramid_levels)
        smooth_pyramid = [
            RGBDImage(lvl.color,
                      lvl.depth.filter_bilateral(opt.diameter,
                                                 opt.sigma_depth,
                                                 opt.sigma_space))
            for lvl in img_pyramid
        ]
        pc_pyramid = [
            PointCloud.create_from_rgbd_image(
                smooth_pyramid[i], self.intrinsic.scale(0.5 ** i),
                np.eye(4, dtype=np.float32), True, opt.depth_cutoff, True)
            for i in range(opt.num_pyramid_levels)
        ]
        return img_pyramid, smooth_pyramid, pc_pyramid

    def pose_estimation(self, init_pose: np.ndarray,
                        frame_pyramid: List[PointCloud],
                        target_pyramid: List[Optional[PointCloud]]
                        ) -> Tuple[np.ndarray, bool]:
        """Coarse-to-fine frame-to-model ICP (cupoch PoseEstimation).
        Returns (the camera-to-world pose, whether it is finite)."""
        opt = self.option
        cur = np.asarray(init_pose, np.float32)
        for level in range(opt.num_pyramid_levels - 1, -1, -1):
            tgt = target_pyramid[level]
            src = frame_pyramid[level]
            if tgt is None or src.is_empty() or tgt.is_empty():
                continue
            criteria = ICPConvergenceCriteria(
                max_iteration=opt.icp_iterations[level])
            with trace.span("kinfu.track.level", level=level,
                            points=len(src), target_points=len(tgt)):
                if opt.tf_type == TransformationEstimationType.PointToPlane:
                    res = registration_icp(
                        src, tgt, opt.distance_threshold, cur,
                        TransformationEstimationPointToPlane(), criteria)
                elif opt.tf_type == TransformationEstimationType.ColoredICP:
                    res = registration_colored_icp(
                        src, tgt, opt.distance_threshold, cur, criteria,
                        lambda_geometric=0.968)
                else:
                    console.log_error("[KinfuPipeline::PoseEstimation] "
                                      "Unsupported transformation type.")
                trace.set_attrs(
                    iterations=res.iterations,
                    branch=trace.last_attr("registration.icp", "branch"))
            cur = np.asarray(res.transformation, np.float32)
            if not np.isfinite(cur).all():
                return cur, False
        return cur, True


# the name of cupoch's Python binding, `cupoch.kinfu.Pipeline`
Pipeline = KinfuPipeline
