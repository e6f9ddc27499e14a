"""Registration: ICP for every estimator (pooled grid, run grid, roll
and cell grids, brute force, hash grid), Colored ICP, Generalized ICP,
EvaluateRegistration and FilterReg."""
from .colored_icp import compute_color_gradient, registration_colored_icp
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
from .generalized_icp import (
    covariances_from_normals,
    registration_generalized_icp,
)
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
    "compute_color_gradient",
    "covariances_from_normals",
    "evaluate_registration",
    "registration_colored_icp",
    "registration_filterreg",
    "registration_generalized_icp",
    "registration_icp",
    "TransformationEstimation",
    "TransformationEstimationForColoredICP",
    "TransformationEstimationForGeneralizedICP",
    "TransformationEstimationPointToPlane",
    "TransformationEstimationPointToPoint",
    "TransformationEstimationSymmetricMethod",
    "TransformationEstimationType",
]
