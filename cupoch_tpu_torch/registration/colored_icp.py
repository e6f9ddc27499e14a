"""Colored ICP (Park, Zhou, Koltun, ICCV 2017; cupoch colored_icp.cu).

The per-point colour-gradient precompute is one [N, max_nn] batch with a
batched 3x3 solve; the joint geometric + photometric Gauss-Newton runs
in `registration_icp`'s loops (the pooled grid's epilogue, or the
generic loop through `estimation.colored_system`).
"""
from __future__ import annotations

import torch

from ..knn import KDTreeSearchParamRadius, search_neighbors
from ..utility import console


def intensity(colors: torch.Tensor) -> torch.Tensor:
    """Scalar intensity, the mean of R, G and B ([N, 3] in [0, 1])."""
    return colors.mean(-1)


def _color_gradient_kernel(points, normals, intens, idx):
    """cupoch compute_color_gradient_functor: the intensity gradient in
    each point's tangent plane, from its neighbours (-1 invalid, the
    point itself ignored); 0 with fewer than 4 neighbours."""
    N = points.shape[0]
    self_idx = torch.arange(N, device=points.device)[:, None]
    valid = (idx >= 0) & (idx != self_idx)
    safe = idx.clamp(0, N - 1).long()
    vt = points[:, None, :]                                # [N, 1, 3]
    nt = normals
    vt_adj = points[safe]                                  # [N, K, 3]
    it_adj = intens[safe]                                  # [N, K]
    # neighbours projected into the tangent plane of vt
    off = vt_adj - vt
    vt_proj = vt_adj - (off * nt[:, None, :]).sum(-1, keepdim=True) \
        * nt[:, None, :]
    vtmp = vt_proj - vt
    w = valid.to(points.dtype)[..., None]
    AtA = torch.einsum("nki,nkj->nij", vtmp * w, vtmp)
    Atb = torch.einsum("nk,nki->ni", (it_adj - intens[:, None]) * w[..., 0],
                       vtmp)
    nn = valid.sum(-1).to(points.dtype)
    # orthogonality constraint along the normal
    AtA = AtA + ((nn - 1.0) ** 2)[:, None, None] \
        * torch.einsum("ni,nj->nij", nt, nt)
    AtA = AtA + 1e-6 * torch.eye(3, dtype=points.dtype, device=points.device)
    grad = torch.linalg.solve_ex(AtA, Atb[..., None])[0][..., 0]
    return torch.where((nn >= 4.0)[:, None], grad, 0.0)


def compute_color_gradient(target, radius: float, max_nn: int = 30):
    """[M, 3] colour gradient of every target point (cupoch
    InitializePointCloudForColoredICP), from a radius search with at
    most `max_nn` neighbours."""
    if not target.has_colors() or not target.has_normals():
        console.log_error("[ColoredICP] target needs both colors and normals.")
    idx, _ = search_neighbors(target.points, target.points,
                              KDTreeSearchParamRadius(radius, max_nn))
    return _color_gradient_kernel(target.points, target.normals,
                                  intensity(target.colors), idx)


def registration_colored_icp(source, target, max_distance: float, init=None,
                             criteria=None, lambda_geometric: float = 0.968,
                             det_thresh: float = 1e-6):
    """cupoch RegistrationColoredICP: `registration_icp` with the
    Colored ICP estimator."""
    from .estimation import TransformationEstimationForColoredICP
    from .registration import registration_icp

    return registration_icp(
        source, target, max_distance, init,
        TransformationEstimationForColoredICP(lambda_geometric, det_thresh),
        criteria)
