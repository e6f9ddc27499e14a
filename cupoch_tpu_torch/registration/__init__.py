"""Registration: ICP for every estimator (pooled grid, run grid, roll
and cell grids, brute force, hash grid), Colored ICP, Generalized ICP,
EvaluateRegistration, FilterReg, Kabsch, FPFH and SHOT features and
Fast Global Registration."""
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
from .fast_global_registration import (
    FastGlobalRegistrationOption,
    fast_global_registration,
)
from .feature import (
    Feature,
    compute_fpfh_feature,
    correspondences_from_features,
)
from .filterreg import FilterRegOption, FilterRegResult, registration_filterreg
from .generalized_icp import (
    covariances_from_normals,
    registration_generalized_icp,
)
from .kabsch import kabsch, kabsch_weighted
from .registration import (
    ICPConvergenceCriteria,
    RegistrationResult,
    evaluate_registration,
    registration_icp,
)
from .shot import compute_shot_feature

__all__ = [
    "FastGlobalRegistrationOption",
    "fast_global_registration",
    "Feature",
    "compute_fpfh_feature",
    "compute_shot_feature",
    "FilterRegOption",
    "FilterRegResult",
    "registration_filterreg",
    "correspondences_from_features",
    "ICPConvergenceCriteria",
    "RegistrationResult",
    "registration_icp",
    "evaluate_registration",
    "kabsch",
    "kabsch_weighted",
    "registration_colored_icp",
    "registration_generalized_icp",
    "compute_color_gradient",
    "covariances_from_normals",
    "TransformationEstimation",
    "TransformationEstimationForColoredICP",
    "TransformationEstimationForGeneralizedICP",
    "TransformationEstimationPointToPoint",
    "TransformationEstimationPointToPlane",
    "TransformationEstimationSymmetricMethod",
    "TransformationEstimationType",
]
