"""Tiled brute-force nearest-neighbour search (counterpart of the JAX
package's `knn/bruteforce.py`; cupoch knn/kdtree_flann.h, bruteforce_nn.h).

Pairwise squared distances are |q|^2 + |p|^2 - 2 q.p with the cross
term as one `torch.matmul` per query tile, in full f32 (the package
turns TF32 off at import). Outputs follow the reference contract:
dense [Q, k] index / squared-distance tensors padded with -1 / +inf.

`nn_search` is exact in f32 where the JAX package splits the operands
into 8+8+8-bit bf16 parts for the TPU's matrix unit; so the two may
pick different winners on ties at about 2^-24 relative, and the
returned distance is recomputed exactly in both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utility.shape import INVALID_INDEX

_DEFAULT_TILE = 1024


def _tiles(q: torch.Tensor, tile: int):
    return [q[i:i + tile] for i in range(0, max(q.shape[0], 1), tile)]


def _pairwise_dist2(q_tile: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[T, D] x [N, D] -> [T, N] squared distances, clamped at 0."""
    qn = (q_tile * q_tile).sum(-1, keepdim=True)
    dn = (data * data).sum(-1)
    d2 = qn + dn[None, :] - 2.0 * (q_tile @ data.T)
    return d2.clamp(min=0.0)


def knn_search(queries: torch.Tensor, data: torch.Tensor, k: int,
               data_mask: Optional[torch.Tensor] = None,
               tile: int = _DEFAULT_TILE
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN: (indices [Q, k] int32, dist2 [Q, k] f32), sorted by
    distance, -1 / inf past the valid data points."""
    N = data.shape[0]
    Q = queries.shape[0]
    k_eff = min(k, N)
    idxs, d2s = [], []
    for q in _tiles(queries, tile):
        d2 = _pairwise_dist2(q, data)
        if data_mask is not None:
            d2 = torch.where(data_mask[None, :], d2, float("inf"))
        v, i = torch.topk(d2, k_eff, dim=-1, largest=False, sorted=True)
        idxs.append(i.to(torch.int32))
        d2s.append(v)
    idx = torch.cat(idxs)[:Q]
    d2 = torch.cat(d2s)[:Q]
    if k_eff < k:
        idx = torch.cat([idx, idx.new_full((Q, k - k_eff), INVALID_INDEX)],
                        -1)
        d2 = torch.cat([d2, d2.new_full((Q, k - k_eff), float("inf"))], -1)
    idx = torch.where(torch.isfinite(d2), idx, INVALID_INDEX)
    return idx, d2


def hybrid_search(queries: torch.Tensor, data: torch.Tensor, radius,
                  max_nn: int, data_mask: Optional[torch.Tensor] = None,
                  tile: int = _DEFAULT_TILE):
    """Radius-bounded k-NN (cupoch SearchHybrid): (indices [Q, max_nn],
    dist2 [Q, max_nn], counts [Q] int32); slots beyond the radius are
    -1 / inf."""
    idx, d2 = knn_search(queries, data, max_nn, data_mask=data_mask,
                         tile=tile)
    r2 = torch.as_tensor(radius, dtype=torch.float32) ** 2
    within = d2 <= r2.to(d2.device)
    idx = torch.where(within, idx, INVALID_INDEX)
    d2 = torch.where(within, d2, float("inf"))
    return idx, d2, within.sum(-1).to(torch.int32)


def nn_search(queries: torch.Tensor, data: torch.Tensor,
              data_mask: Optional[torch.Tensor] = None, tile: int = 4096
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN: (index [Q] int32, dist2 [Q]); dist2 is inf when the winner
    is masked out (no valid data point)."""
    Q = queries.shape[0]
    pn = (data * data).sum(-1)
    if data_mask is not None:
        pn = torch.where(data_mask, pn, 1e30)
    idxs, d2s = [], []
    for q in _tiles(queries, tile):
        # |q|^2 does not change the argmin
        i = torch.argmin(pn[None, :] - 2.0 * (q @ data.T), -1)
        d = q - data[i]
        d2 = (d * d).sum(-1)
        if data_mask is not None:
            d2 = torch.where(data_mask[i], d2, float("inf"))
        idxs.append(i.to(torch.int32))
        d2s.append(d2)
    return torch.cat(idxs)[:Q], torch.cat(d2s)[:Q]
