"""Normals from each point's exact hybrid neighbourhood, plain PyTorch
(cupoch PointCloud::EstimateNormals with KDTreeSearchParamHybrid).

A point's neighbourhood is its `max_nn` nearest points within `radius`
(itself among them), ties to the smaller index, found by `grid_nn`'s
exact cell search. The normal is the eigenvector of the neighbourhood's
covariance with the least eigenvalue, computed in float64 on the host
(a batch of 10^5 matrices is past the card's batched solver); a point with
fewer than three neighbours gets (0, 0, 1). The sign is arbitrary, as
in cupoch: point-to-plane ICP does not depend on it.
"""
from __future__ import annotations

import torch

from . import grid_nn


def hybrid_neighbours(points, radius: float, max_nn: int):
    """[N, max_nn] indices of each point's nearest points within
    `radius`, nearest first, -1 where there are fewer."""
    n = points.shape[0]
    grid = grid_nn.Grid(points, radius)
    out = torch.full((n, max_nn), -1, dtype=torch.int64,
                     device=points.device)
    r2 = float(radius) ** 2
    for q0, qi, ti, d2 in grid.pairs(points):
        ok = d2.to(torch.float32) <= r2
        qi, key = qi[ok], grid_nn._packed(d2[ok], ti[ok])
        order = torch.argsort(key, stable=True)
        order = order[torch.argsort(qi[order], stable=True)]
        qi, key = qi[order], key[order]
        first = torch.searchsorted(qi, qi, right=False)
        rank = torch.arange(qi.numel(), device=qi.device) - first
        keep = rank < max_nn
        out[q0 + qi[keep], rank[keep]] = key[keep] & 0xFFFFFFFF
    return out


def estimate(points, radius: float, max_nn: int):
    """[N, 3] float32 unit normals of `points` [N, 3]."""
    idx = hybrid_neighbours(points, radius, max_nn)
    have = idx >= 0
    cnt = have.sum(1, keepdim=True).to(torch.float64)
    nb = points.to(torch.float64)[idx.clamp(min=0)] * have[..., None]
    mean = nb.sum(1) / cnt.clamp(min=1)
    d = (nb - mean[:, None]) * have[..., None]
    cov = d.transpose(1, 2) @ d / cnt.clamp(min=1)[..., None]
    _, vec = torch.linalg.eigh(cov.cpu())
    normal = vec[:, :, 0]
    normal[cnt[:, 0].cpu() < 3] = torch.tensor([0.0, 0.0, 1.0],
                                               dtype=torch.float64)
    return normal.to(points.device, torch.float32)
