"""Generalized ICP (Segal, Haehnel, Thrun, RSS 2009; cupoch
generalized_icp.cu).

Per-point covariances regularised to a plane (spectrum (epsilon, 1, 1)
turned onto the normal) are batched products; the plane-to-plane
Gauss-Newton runs in `registration_icp`'s loops (the pooled grid's
epilogue, or the generic loop through `estimation.gicp_system`), with
the source covariances turned by the current pose every iteration.
"""
from __future__ import annotations

import torch

from ..knn import KDTreeSearchParamKNN
from ..utility.eigen import rotation_e1_to_x


def covariances_from_normals(normals: torch.Tensor, epsilon) -> torch.Tensor:
    """C = R diag(eps, 1, 1) R^T with R turning e1 onto the normal."""
    Rx = rotation_e1_to_x(normals)
    d = torch.ones(normals.shape[:-1] + (3,), dtype=torch.float32,
                   device=normals.device)
    d[..., 0] = torch.as_tensor(epsilon, dtype=torch.float32)
    return torch.einsum("...ij,...j,...kj->...ik", Rx, d, Rx)


def initialize_cloud_for_gicp(pcd, epsilon: float) -> torch.Tensor:
    """[N, 3, 3] covariances for GICP: the cloud's own when it has them,
    else from its normals, else from normals estimated from its 20
    nearest neighbours (cupoch InitializePointCloudForGeneralizedICP)."""
    if pcd.has_covariances():
        return pcd.covariances
    if pcd.has_normals():
        normals = pcd.normals
    else:
        from ..geometry.pointcloud import PointCloud

        tmp = PointCloud(pcd.points, device=pcd.device)
        tmp.estimate_normals(KDTreeSearchParamKNN(20))
        normals = tmp.normals
    return covariances_from_normals(normals, epsilon)


def registration_generalized_icp(source, target, max_distance: float,
                                 init=None, estimation=None, criteria=None):
    """cupoch RegistrationGeneralizedICP: `registration_icp` with the
    GICP estimator."""
    from .estimation import TransformationEstimationForGeneralizedICP
    from .registration import registration_icp

    estimation = estimation or TransformationEstimationForGeneralizedICP()
    return registration_icp(source, target, max_distance, init, estimation,
                            criteria)
