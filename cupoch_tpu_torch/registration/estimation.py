"""Transformation estimators for ICP (cupoch
registration/transformation_estimation.h): the estimator types, their
option holders, and the per-pair updates of the generic ICP loop.

  PointToPoint    - Kabsch SVD (kabsch.py)
  PointToPlane    - Gauss-Newton on r = (vs - vt) . nt, J = [vs x nt, nt]
  SymmetricMethod - r = (vs - vt) . (ns + nt), J = [(vs + vt) x n, n]
  ColoredICP      - point-to-plane rows plus photometric rows
                    (`colored_system`)
  GeneralizedICP  - whitened plane-to-plane rows (`gicp_system`)

Each update is split in two: `normal_system` (or `colored_system`,
`gicp_system`) reduces the pairs to a few floats on their device (the
Kabsch statistics, or JTJ and JTr), and
`solve_normal_system` turns them into a 4x4 update on the host. The ICP
loop reads the system together with its convergence statistics, in one
device-to-host copy an iteration. On the grid paths the same updates
come from the reduced sums of `fused_icp.py`.
"""
from __future__ import annotations

import enum

import torch

from ..utility import eigen as ueigen
from .kabsch import kabsch_solve, kabsch_stats


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


# ---------------------------------------------------------------------------
# per-pair updates; inputs are gathered correspondence pairs with a
# validity weight w per pair
# ---------------------------------------------------------------------------

def _gn_system(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
    Jw = J * w[:, None]
    return torch.cat([(Jw.T @ J).reshape(-1), Jw.T @ r])


def normal_system(est_type, src, dst, dst_normals, src_normals, w):
    """The update's inputs reduced on the device of the pairs: the
    Kabsch statistics (PointToPoint) or JTJ [36] and JTr [6]."""
    if est_type == TransformationEstimationType.PointToPoint:
        return kabsch_stats(src, dst, w)
    if est_type == TransformationEstimationType.PointToPlane:
        n = dst_normals
        r = ((src - dst) * n).sum(-1)
        J = torch.cat([torch.linalg.cross(src, n, dim=-1), n], -1)
        return _gn_system(J, r, w)
    if est_type == TransformationEstimationType.SymmetricMethod:
        n = src_normals + dst_normals
        r = ((src - dst) * n).sum(-1)
        J = torch.cat([torch.linalg.cross(src + dst, n, dim=-1), n], -1)
        return _gn_system(J, r, w)
    raise ValueError(f"normal_system takes PointToPoint, PointToPlane or "
                     f"SymmetricMethod, not {est_type!r}: Colored and "
                     f"Generalized ICP have colored_system / gicp_system")


def colored_system(src_t, dst, dst_normals, src_intensity, dst_intensity,
                   dst_grad, w, sqrt_lg, sqrt_lp):
    """Joint geometric + photometric system (cupoch colored_icp.cu
    compute_jacobian_and_residual_functor): 2N rows, the point-to-plane
    rows scaled by sqrt(lambda_g), then the photometric rows scaled by
    sqrt(lambda_p). Intensities are precomputed (they do not move)."""
    nt = dst_normals
    d = src_t - dst
    dn = (d * nt).sum(-1)
    r_g = sqrt_lg * dn
    J_g = sqrt_lg * torch.cat([torch.linalg.cross(src_t, nt, dim=-1), nt],
                              -1)
    # the source projected onto the target's tangent plane, against the
    # target intensity extrapolated along its gradient
    vs_proj = src_t - dn[:, None] * nt
    is0_proj = (dst_grad * (vs_proj - dst)).sum(-1) + dst_intensity
    # M = I - nt nt^T projects the gradient into the tangent plane
    ditM = -(dst_grad - (dst_grad * nt).sum(-1, keepdim=True) * nt)
    r_p = sqrt_lp * (src_intensity - is0_proj)
    J_p = sqrt_lp * torch.cat(
        [torch.linalg.cross(src_t, ditM, dim=-1), ditM], -1)
    return _gn_system(torch.cat([J_g, J_p], 0), torch.cat([r_g, r_p], 0),
                      torch.cat([w, w], 0))


def gicp_system(src_t, src_cov_t, dst, dst_cov, w):
    """Plane-to-plane Mahalanobis system (cupoch generalized_icp.cu):
    W = sqrtm((Ct + Cs)^-1) whitens the 3-row point residual and its
    Jacobian [-skew(vs) | I], as the JAX package computes it."""
    d = src_t - dst
    M_inv, _ = torch.linalg.inv_ex(dst_cov + src_cov_t)     # [K, 3, 3]
    W = ueigen.sqrtm_psd3(M_inv)
    x, y, z = src_t[:, 0], src_t[:, 1], src_t[:, 2]
    zero = torch.zeros_like(x)
    skew = torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], 1)
    eye = torch.eye(3, dtype=src_t.dtype, device=src_t.device)
    J0 = torch.cat([-skew, eye.expand_as(skew)], -1)        # [K, 3, 6]
    J = W @ J0
    r = (W @ d[..., None])[..., 0]
    return _gn_system(J.reshape(-1, 6), r.reshape(-1),
                      w.repeat_interleave(3))


def solve_normal_system(est_type, system) -> torch.Tensor:
    """[4, 4] f32 update, on the device of `system` (the host, as a
    rule), from `normal_system`."""
    if est_type == TransformationEstimationType.PointToPoint:
        return kabsch_solve(system)
    ok, T = ueigen.solve_jacobian_system(system[:36].reshape(6, 6),
                                         system[36:42])
    return T


def _update(est_type, src, dst, dst_normals, src_normals, w):
    return solve_normal_system(est_type, normal_system(
        est_type, src, dst, dst_normals, src_normals, w).cpu())


def update_point_to_point(src, dst, dst_normals, src_normals, w):
    return _update(TransformationEstimationType.PointToPoint, src, dst,
                   dst_normals, src_normals, w)


def _gn_update(J, r, w):
    return solve_normal_system(TransformationEstimationType.PointToPlane,
                               _gn_system(J, r, w).cpu())


def update_point_to_plane(src, dst, dst_normals, src_normals, w):
    """cupoch pt2pl_jacobian_residual_functor."""
    return _update(TransformationEstimationType.PointToPlane, src, dst,
                   dst_normals, src_normals, w)


def update_symmetric(src, dst, dst_normals, src_normals, w):
    """cupoch symmetric_jacobian_residual_functor."""
    return _update(TransformationEstimationType.SymmetricMethod, src, dst,
                   dst_normals, src_normals, w)


def update_colored(src_t, dst, dst_normals, src_intensity, dst_intensity,
                   dst_grad, w, sqrt_lg, sqrt_lp):
    """Colored ICP step (`colored_system`, solved on the host)."""
    return solve_normal_system(
        TransformationEstimationType.ColoredICP, colored_system(
            src_t, dst, dst_normals, src_intensity, dst_intensity,
            dst_grad, w, sqrt_lg, sqrt_lp).cpu())


def update_gicp(src_t, src_cov_t, dst, dst_cov, w):
    """Generalized ICP step (`gicp_system`, solved on the host)."""
    return solve_normal_system(
        TransformationEstimationType.GeneralizedICP,
        gicp_system(src_t, src_cov_t, dst, dst_cov, w).cpu())
