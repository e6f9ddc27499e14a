"""Registration: the pooled-grid ICP path."""
from .estimation import (
    TransformationEstimation,
    TransformationEstimationForColoredICP,
    TransformationEstimationForGeneralizedICP,
    TransformationEstimationPointToPlane,
    TransformationEstimationPointToPoint,
    TransformationEstimationSymmetricMethod,
    TransformationEstimationType,
)
from .registration import (
    ICPConvergenceCriteria,
    RegistrationResult,
    registration_icp,
)

__all__ = [
    "ICPConvergenceCriteria",
    "RegistrationResult",
    "registration_icp",
    "TransformationEstimation",
    "TransformationEstimationForColoredICP",
    "TransformationEstimationForGeneralizedICP",
    "TransformationEstimationPointToPlane",
    "TransformationEstimationPointToPoint",
    "TransformationEstimationSymmetricMethod",
    "TransformationEstimationType",
]
