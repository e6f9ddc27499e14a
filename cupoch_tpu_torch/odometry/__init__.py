"""RGB-D visual odometry (cupoch odometry/)."""
from .odometry import (
    OdometryOption,
    RGBDOdometryJacobian,
    RGBDOdometryJacobianFromColorTerm,
    RGBDOdometryJacobianFromHybridTerm,
    compute_rgbd_odometry,
    compute_weighted_rgbd_odometry,
)

__all__ = [
    "OdometryOption",
    "RGBDOdometryJacobian",
    "RGBDOdometryJacobianFromColorTerm",
    "RGBDOdometryJacobianFromHybridTerm",
    "compute_rgbd_odometry",
    "compute_weighted_rgbd_odometry",
]
