"""Pinhole camera intrinsics (cupoch camera/pinhole_camera_intrinsic.h,
pinhole_camera_parameters.h, pinhole_camera_trajectory.h): fx, fy, cx,
cy in a 3x3 intrinsic matrix, the named presets and the JSON-style dict
round trip. These are host objects: the matrix is a numpy array, moved
to the device by the functions that use it.
"""
from __future__ import annotations

import enum
from typing import List

import numpy as np


class PinholeCameraIntrinsicParameters(enum.IntEnum):
    """cupoch pinhole_camera_intrinsic.h:37-43 (same presets)."""

    PrimeSenseDefault = 0
    Kinect2DepthCameraDefault = 1
    Kinect2ColorCameraDefault = 2


class PinholeCameraIntrinsic:
    """cupoch pinhole_camera_intrinsic.h:45-105."""

    def __init__(self, width: int = -1, height: int = -1,
                 fx: float = 0.0, fy: float = 0.0,
                 cx: float = 0.0, cy: float = 0.0):
        if isinstance(width, PinholeCameraIntrinsicParameters):
            preset = width
            if preset == PinholeCameraIntrinsicParameters.PrimeSenseDefault:
                self.set_intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5)
            elif preset == PinholeCameraIntrinsicParameters.Kinect2DepthCameraDefault:
                self.set_intrinsics(512, 424, 365.456, 365.456, 254.878, 205.395)
            else:
                self.set_intrinsics(1920, 1080, 1059.9718, 1059.9718, 975.7193, 545.9533)
            return
        self.width = int(width)
        self.height = int(height)
        self.intrinsic_matrix = np.asarray(
            [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)

    def set_intrinsics(self, width, height, fx, fy, cx, cy):
        self.width = int(width)
        self.height = int(height)
        self.intrinsic_matrix = np.asarray(
            [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)

    def get_focal_length(self):
        return (float(self.intrinsic_matrix[0, 0]),
                float(self.intrinsic_matrix[1, 1]))

    def get_principal_point(self):
        return (float(self.intrinsic_matrix[0, 2]),
                float(self.intrinsic_matrix[1, 2]))

    def get_skew(self) -> float:
        return float(self.intrinsic_matrix[0, 1])

    def is_valid(self) -> bool:
        return self.width > 0 and self.height > 0

    def scale(self, factor: float) -> "PinholeCameraIntrinsic":
        """Scaled intrinsic for pyramid level (used by odometry's
        CreateCameraMatrixPyramid, cupoch odometry.cu:332-346)."""
        fx, fy = self.get_focal_length()
        cx, cy = self.get_principal_point()
        return PinholeCameraIntrinsic(
            int(round(self.width * factor)), int(round(self.height * factor)),
            fx * factor, fy * factor, cx * factor, cy * factor)

    def __repr__(self):
        return (f"PinholeCameraIntrinsic(width={self.width}, "
                f"height={self.height}, fx={self.intrinsic_matrix[0,0]}, "
                f"fy={self.intrinsic_matrix[1,1]}, cx={self.intrinsic_matrix[0,2]}, "
                f"cy={self.intrinsic_matrix[1,2]})")

    # -- JSON round trip (cupoch ConvertToJsonValue/ConvertFromJsonValue)
    def to_dict(self) -> dict:
        return {
            "width": self.width,
            "height": self.height,
            "intrinsic_matrix": [float(x) for x in
                                 np.asarray(self.intrinsic_matrix).T.flatten()],
        }

    @staticmethod
    def from_dict(d: dict) -> "PinholeCameraIntrinsic":
        out = PinholeCameraIntrinsic()
        out.width = int(d["width"])
        out.height = int(d["height"])
        # column-major in the file; a contiguous copy, since a transposed
        # view makes the card's small products take another rounding
        out.intrinsic_matrix = np.ascontiguousarray(
            np.asarray(d["intrinsic_matrix"], np.float32).reshape(3, 3).T)
        return out


class PinholeCameraParameters:
    """Intrinsic + 4x4 world->camera extrinsic
    (cupoch camera/pinhole_camera_parameters.h)."""

    def __init__(self):
        self.intrinsic = PinholeCameraIntrinsic()
        self.extrinsic = np.eye(4, dtype=np.float32)

    def to_dict(self) -> dict:
        return {
            "class_name": "PinholeCameraParameters",
            "intrinsic": self.intrinsic.to_dict(),
            "extrinsic": [float(x) for x in
                          np.asarray(self.extrinsic).T.flatten()],
            "version_major": 1,
            "version_minor": 0,
        }

    @staticmethod
    def from_dict(d: dict) -> "PinholeCameraParameters":
        out = PinholeCameraParameters()
        out.intrinsic = PinholeCameraIntrinsic.from_dict(d["intrinsic"])
        out.extrinsic = np.ascontiguousarray(
            np.asarray(d["extrinsic"], np.float32).reshape(4, 4).T)
        return out


class PinholeCameraTrajectory:
    """cupoch camera/pinhole_camera_trajectory.h."""

    def __init__(self):
        self.parameters: List[PinholeCameraParameters] = []

    def to_dict(self) -> dict:
        return {
            "class_name": "PinholeCameraTrajectory",
            "parameters": [p.to_dict() for p in self.parameters],
            "version_major": 1,
            "version_minor": 0,
        }

    @staticmethod
    def from_dict(d: dict) -> "PinholeCameraTrajectory":
        out = PinholeCameraTrajectory()
        out.parameters = [PinholeCameraParameters.from_dict(p)
                          for p in d["parameters"]]
        return out
