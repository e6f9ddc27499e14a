"""SHOT descriptor, 352 bins (counterpart of the JAX package's
`registration/shot.py`; cupoch shot.cu).

Every [N, k] neighbour emits five (bin, weight) pairs: its main bin and
its interpolations into the adjacent cosine bin, husk, vertical and
horizontal volume. They are added per point by one `index_add_` into
an [N * 352] vector. The local reference frame is a distance-weighted
covariance's eigenvectors (`symeig3x3`) with majority-vote signs.
"""
from __future__ import annotations

import math

import torch

from ..knn import KDTreeSearchParam, KDTreeSearchParamRadius, search_neighbors
from ..utility import console
from ..utility import eigen as ueigen
from .feature import Feature

_RAD_45 = math.pi / 4.0
_RAD_90 = math.pi / 2.0
_RAD_135 = 3.0 * math.pi / 4.0
_RAD_PI_7_8 = 7.0 * math.pi / 8.0

_N_BINS = 10
_MIN_NEIGHBORS = 5
_MAX_SECTORS = 32
_DIM = _MAX_SECTORS * (_N_BINS + 1)  # 352


def _lrf(points, nbr_idx, nbr_d2, radius):
    """Local reference frames (cupoch compute_shot_lrf): the weighted
    covariance's axes, each sign set by the majority of neighbours."""
    N = nbr_idx.shape[0]
    self_idx = torch.arange(N, device=points.device)[:, None]
    valid = (nbr_idx >= 0) & (nbr_idx != self_idx)
    idx = nbr_idx.clamp(0, N - 1).long()
    q = points[idx] - points[:, None, :]                     # [N, k, 3]
    w = torch.where(valid, radius - torch.sqrt(nbr_d2.clamp(min=0.0)), 0.0)
    cov = torch.einsum("nk,nki,nkj->nij", w, q, q)
    cov = cov / w.sum(-1).clamp(min=1e-30)[:, None, None]
    _, vecs = ueigen.symeig3x3(cov)
    zaxis = vecs[..., :, 0]            # the least eigenvalue's direction
    xaxis = vecs[..., :, 2]            # the largest's
    n_nb = valid.sum(-1)
    n_px = (valid & (torch.einsum("nki,ni->nk", q, xaxis) >= 0)).sum(-1)
    n_pz = (valid & (torch.einsum("nki,ni->nk", q, zaxis) >= 0)).sum(-1)
    xaxis = torch.where((n_px < n_nb - n_px)[:, None], -xaxis, xaxis)
    zaxis = torch.where((n_pz < n_nb - n_pz)[:, None], -zaxis, zaxis)
    yaxis = torch.linalg.cross(zaxis, xaxis, dim=-1)
    return xaxis, yaxis, zaxis, n_nb, valid, q


def _tiny_to_zero(x):
    return torch.where(x.abs() < 1e-30, 0.0, x)


def _shot(points, normals, nbr_idx, nbr_d2, radius: float) -> torch.Tensor:
    """[N, 352] SHOT histograms, unit length (cupoch
    compute_shot_functor)."""
    N, k = nbr_idx.shape
    # the radius and its fractions in f32, as the reference computes them
    radius = torch.tensor(radius, dtype=torch.float32, device=points.device)
    r12, r34, r14 = radius * 0.5, radius * 0.75, radius * 0.25
    xaxis, yaxis, zaxis, n_nb, valid, q = _lrf(points, nbr_idx, nbr_d2,
                                               radius)
    dist = torch.sqrt(nbr_d2.clamp(min=0.0))
    valid = valid & (dist > 0)

    cos_desc = (zaxis * normals).sum(-1).clamp(-1.0, 1.0)
    bindist = ((1.0 + cos_desc) * _N_BINS / 2.0)[:, None].expand(N, k)

    x_lrf = _tiny_to_zero(torch.einsum("nki,ni->nk", q, xaxis))
    y_lrf = _tiny_to_zero(torch.einsum("nki,ni->nk", q, yaxis))
    z_lrf = _tiny_to_zero(torch.einsum("nki,ni->nk", q, zaxis))

    bit4 = ((y_lrf > 0) | ((y_lrf == 0.0) & (x_lrf < 0))).long()
    bit3 = torch.where((x_lrf > 0) | ((x_lrf == 0.0) & (y_lrf > 0)),
                       1 - bit4, bit4)
    desc = ((bit4 << 3) + (bit3 << 2)) << 1
    quad = torch.where((x_lrf * y_lrf > 0) | (x_lrf == 0.0),
                       torch.where(x_lrf.abs() >= y_lrf.abs(), 0, 4),
                       torch.where(x_lrf.abs() > y_lrf.abs(), 4, 0))
    desc = desc + quad + (z_lrf > 0).long()
    outer = dist > r12
    desc = desc + torch.where(outer, 2, 0)                    # [N, k]

    step = torch.where(bindist < 0.0, torch.ceil(bindist - 0.5),
                       torch.floor(bindist + 0.5)).long()
    volume = desc * (_N_BINS + 1)
    bd = bindist - step
    init_w = 1.0 - bd.abs()

    # (1) the adjacent cosine bin
    cos_bin = torch.where(bd > 0, (step + 1) % _N_BINS,
                          (step - 1 + _N_BINS) % _N_BINS)
    cos_idx = volume + cos_bin
    cos_w = bd.abs()

    # (2) the adjacent husk
    rd_out = (dist - r34) / r12
    rd_in = (dist - r14) / r12
    init_w = init_w + torch.where(
        outer, torch.where(dist > r34, 1.0 - rd_out, 1.0 + rd_out),
        torch.where(dist < r14, 1.0 + rd_in, 1.0 - rd_in))
    rad_active = torch.where(outer, dist <= r34, dist >= r14)
    rad_idx = torch.where(outer, (desc - 2) * (_N_BINS + 1) + step,
                          (desc + 2) * (_N_BINS + 1) + step)
    rad_w = torch.where(rad_active, torch.where(outer, -rd_out, rd_in), 0.0)

    # (3) the adjacent vertical volume
    incl = torch.arccos((z_lrf / dist.clamp(min=1e-30)).clamp(-1.0, 1.0))
    lower = (incl > _RAD_90) | (((incl - _RAD_90).abs() < 1e-30)
                                & (z_lrf <= 0))
    id_lo = (incl - _RAD_135) / _RAD_90
    id_hi = (incl - _RAD_45) / _RAD_90
    init_w = init_w + torch.where(
        lower, torch.where(incl > _RAD_135, 1.0 - id_lo, 1.0 + id_lo),
        torch.where(incl < _RAD_45, 1.0 + id_hi, 1.0 - id_hi))
    incl_active = torch.where(lower, incl <= _RAD_135, incl >= _RAD_45)
    incl_idx = torch.where(lower, (desc + 1) * (_N_BINS + 1) + step,
                           (desc - 1) * (_N_BINS + 1) + step)
    incl_w = torch.where(incl_active, torch.where(lower, -id_lo, id_hi),
                         0.0)

    # (4) the adjacent horizontal volume
    az_ok = (y_lrf != 0.0) | (x_lrf != 0.0)
    az_dist = ((torch.atan2(y_lrf, x_lrf)
                - (-_RAD_PI_7_8 + _RAD_45 * (desc >> 2))) / _RAD_45) \
        .clamp(-0.5, 0.5)
    init_w = init_w + torch.where(az_ok, 1.0 - az_dist.abs(), 0.0)
    az_idx = torch.where(az_dist > 0, (desc + 4) % _MAX_SECTORS,
                         (desc - 4 + _MAX_SECTORS) % _MAX_SECTORS) \
        * (_N_BINS + 1) + step
    az_w = torch.where(az_ok, az_dist.abs(), 0.0)

    all_idx = torch.stack([volume + step, cos_idx, rad_idx, incl_idx,
                           az_idx], -1).clamp(0, _DIM - 1)
    all_w = torch.stack([init_w, cos_w, rad_w, incl_w, az_w], -1)
    all_w = torch.where(valid[..., None], all_w, 0.0)
    row = torch.arange(N, device=points.device)[:, None, None] * _DIM
    ft = points.new_zeros(N * _DIM)
    ft.index_add_(0, (all_idx + row).reshape(-1), all_w.reshape(-1))
    ft = torch.where((n_nb >= _MIN_NEIGHBORS)[:, None],
                     ft.reshape(N, _DIM), 0.0)
    nrm = torch.linalg.norm(ft, dim=-1, keepdim=True)
    return torch.where(nrm > 0, ft / nrm.clamp(min=1e-30), ft)


def compute_shot_feature(input, radius: float,
                         search_param: KDTreeSearchParam = None) -> Feature:
    """352-bin SHOT descriptors of a cloud with normals (cupoch
    ComputeSHOTFeature), on the cloud's device; the neighbours within
    `radius` by default."""
    if not input.has_normals():
        console.log_error(
            "[ComputeSHOTFeature] Failed because input point cloud has no "
            "normal.")
    search_param = search_param or KDTreeSearchParamRadius(radius)
    points = input.points
    idx, d2 = search_neighbors(points, points, search_param)
    return Feature(_shot(points, input.normals, idx, d2, float(radius)).T)
