"""Kabsch rigid alignment (cupoch registration/kabsch.h, kabsch.cu).

The centroids and the cross-covariance are reduced on the device of
the inputs; those 17 floats come to the host in one copy, where the
3x3 SVD runs in f32. As in the JAX package, the sums are normalised by
the weight sum (the correspondence count), not the cloud size.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utility.transforms import make_transform

N_STATS = 17  # weight sum, source mean (3), target mean (3), H (9), count


def kabsch_stats(src: torch.Tensor, dst: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """[N_STATS] on the device of the inputs: the clamped weight sum,
    both weighted means, the weighted 3x3 cross-covariance H and the
    number of positive weights."""
    w = weights.to(src.dtype)
    wsum = w.sum().clamp(min=1e-12)
    src_c = (src * w[:, None]).sum(0) / wsum
    dst_c = (dst * w[:, None]).sum(0) / wsum
    H = ((src - src_c) * w[:, None]).T @ (dst - dst_c) / wsum
    return torch.cat([wsum.reshape(1), src_c, dst_c, H.reshape(-1),
                      (w > 0).sum().to(src.dtype).reshape(1)])


def kabsch_solve(stats: torch.Tensor) -> torch.Tensor:
    """[4, 4] f32 on the device of `stats` (the host, as a rule) from
    `kabsch_stats`; the identity when fewer than 3 weights are positive
    or the result is not finite."""
    src_c, dst_c = stats[1:4], stats[4:7]
    U, S, Vh = torch.linalg.svd(stats[7:16].reshape(3, 3))
    V = Vh.T
    det = torch.linalg.det(V @ U.T)
    D = torch.diag(torch.stack([det.new_ones(()), det.new_ones(()), det]))
    R = (V @ D) @ U.T
    T = make_transform(R, dst_c - R @ src_c)
    ok = (stats[16] >= 3) & torch.isfinite(T).all()
    return torch.where(ok, T, torch.eye(4, dtype=T.dtype, device=T.device))


def kabsch_weighted(src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Best-fit rigid transform T (f32, on the host) with T @ src ~=
    dst; src, dst [N, 3], weights [N] (0 for invalid pairs)."""
    return kabsch_solve(kabsch_stats(src, dst, weights).cpu())


def kabsch(model: torch.Tensor, target: torch.Tensor,
           corres: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference-style entry: corres is [K, 2] (model_idx, target_idx)
    with -1 rows invalid; None means identity correspondence."""
    if corres is None:
        return kabsch_weighted(model, target,
                               torch.ones(model.shape[0], dtype=model.dtype,
                                          device=model.device))
    mi = corres[:, 0].clamp(0, model.shape[0] - 1).long()
    ti = corres[:, 1].clamp(0, target.shape[0] - 1).long()
    w = (corres[:, 0] >= 0).to(model.dtype)
    return kabsch_weighted(model[mi], target[ti], w)
