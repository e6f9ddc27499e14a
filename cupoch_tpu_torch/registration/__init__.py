"""Registration: ICP (pooled grid, run grid, brute force),
EvaluateRegistration and FilterReg."""
from .estimation import (
    TransformationEstimation,
    TransformationEstimationForColoredICP,
    TransformationEstimationForGeneralizedICP,
    TransformationEstimationPointToPlane,
    TransformationEstimationPointToPoint,
    TransformationEstimationSymmetricMethod,
    TransformationEstimationType,
)
from .filterreg import FilterRegOption, FilterRegResult, registration_filterreg
from .registration import (
    ICPConvergenceCriteria,
    RegistrationResult,
    evaluate_registration,
    registration_icp,
)

__all__ = [
    "FilterRegOption",
    "FilterRegResult",
    "ICPConvergenceCriteria",
    "RegistrationResult",
    "evaluate_registration",
    "registration_filterreg",
    "registration_icp",
    "TransformationEstimation",
    "TransformationEstimationForColoredICP",
    "TransformationEstimationForGeneralizedICP",
    "TransformationEstimationPointToPlane",
    "TransformationEstimationPointToPoint",
    "TransformationEstimationSymmetricMethod",
    "TransformationEstimationType",
]
