"""Camera models: pinhole intrinsics, parameters and trajectories."""
from .pinhole_camera_intrinsic import (
    PinholeCameraIntrinsic,
    PinholeCameraIntrinsicParameters,
    PinholeCameraParameters,
    PinholeCameraTrajectory,
)

__all__ = [
    "PinholeCameraIntrinsic",
    "PinholeCameraIntrinsicParameters",
    "PinholeCameraParameters",
    "PinholeCameraTrajectory",
]
