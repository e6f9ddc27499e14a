"""Transformation estimators for ICP (cupoch
registration/transformation_estimation.h): the estimator types and
their option holders. On the pooled-grid path the Gauss-Newton and
Kabsch updates are formed from reduced sums (`fused_icp.py`); the
per-pair update functions of the generic ICP loop are not ported yet.
"""
from __future__ import annotations

import enum


class TransformationEstimationType(enum.IntEnum):
    # values match cupoch's transformation_estimation.h
    Unspecified = 0
    PointToPoint = 1
    PointToPlane = 2
    SymmetricMethod = 3
    ColoredICP = 4
    GeneralizedICP = 5


class TransformationEstimation:
    def get_transformation_estimation_type(self) -> TransformationEstimationType:
        raise NotImplementedError


class TransformationEstimationPointToPoint(TransformationEstimation):
    def __init__(self, with_scaling: bool = False):
        self.with_scaling = with_scaling

    def get_transformation_estimation_type(self):
        return TransformationEstimationType.PointToPoint


class TransformationEstimationPointToPlane(TransformationEstimation):
    def __init__(self, det_thresh: float = 1e-6):
        self.det_thresh = det_thresh

    def get_transformation_estimation_type(self):
        return TransformationEstimationType.PointToPlane


class TransformationEstimationSymmetricMethod(TransformationEstimation):
    def __init__(self, det_thresh: float = 1e-6):
        self.det_thresh = det_thresh

    def get_transformation_estimation_type(self):
        return TransformationEstimationType.SymmetricMethod


class TransformationEstimationForColoredICP(TransformationEstimation):
    """cupoch colored_icp.cu (lambda clamp included)."""

    def __init__(self, lambda_geometric: float = 0.968,
                 det_thresh: float = 1e-6):
        if lambda_geometric < 0.0 or lambda_geometric > 1.0:
            lambda_geometric = 0.968
        self.lambda_geometric = float(lambda_geometric)
        self.det_thresh = det_thresh

    def get_transformation_estimation_type(self):
        return TransformationEstimationType.ColoredICP


class TransformationEstimationForGeneralizedICP(TransformationEstimation):
    """cupoch generalized_icp.h (epsilon = covariance along the
    normal)."""

    def __init__(self, epsilon: float = 1e-3):
        self.epsilon = float(epsilon)

    def get_transformation_estimation_type(self):
        return TransformationEstimationType.GeneralizedICP
