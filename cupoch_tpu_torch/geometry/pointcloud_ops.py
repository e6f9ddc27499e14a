"""Point-cloud operations on tensors (counterpart of the JAX package's
`geometry/pointcloud_ops.py`; cupoch estimate_normals.cu). Ported so
far: the neighbourhood covariances and the normals taken from them."""
from __future__ import annotations

from typing import Tuple

import torch

from ..utility import eigen as ueigen


def covariances_from_neighbors(points: torch.Tensor, nbr_idx: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point covariance over [N, k] neighbour indices (-1 invalid):
    (cov [N, 3, 3] f32, counts [N]), from one gather (cupoch
    compute_cumulant_functor): E[x x^T] - mean mean^T.

    That difference cancels most of its digits on flat neighbourhoods,
    where the least eigenvalue (the normal's) is tiny, so its rounding
    decides the normal. The neighbours are summed in order, and every
    product is added with one rounding (a fused multiply-add, done in
    f64 and rounded to f32), as the JAX package's compiled CPU code
    does: the result is the same on every device and equal to the
    reference's bit for bit."""
    valid = nbr_idx >= 0
    idx = nbr_idx.clamp(0, points.shape[0] - 1).long()
    nbr = points[idx] * valid[..., None].to(torch.float32)  # [N, k, 3]
    cnt = valid.sum(-1)
    denom = cnt.clamp(min=1).to(torch.float32)
    total = torch.zeros_like(nbr[:, 0])
    second = total.new_zeros(nbr.shape[:1] + (3, 3))
    for j in range(nbr.shape[1]):
        x = nbr[:, j]
        total = total + x
        x = x.double()
        second = (x[:, :, None] * x[:, None, :] + second).to(torch.float32)
    mean = (total / denom[:, None]).double()
    cov = (second / denom[:, None, None]).double() \
        - mean[:, None, :] * mean[:, :, None]
    return cov.to(torch.float32), cnt


def normals_from_covariances(cov: torch.Tensor, counts: torch.Tensor
                             ) -> torch.Tensor:
    """Unit eigenvectors of the least eigenvalue; (0, 0, 1) where fewer
    than 3 neighbours were found or the vector degenerates."""
    _, vecs = ueigen.symeig3x3(cov)
    n = vecs[..., :, 0]
    nrm = torch.sqrt((n * n).sum(-1, keepdim=True))
    default = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype,
                           device=n.device).expand_as(n)
    bad = (counts < 3)[:, None] | (nrm < 1e-12)
    return torch.where(bad, default, n / nrm.clamp(min=1e-12))
