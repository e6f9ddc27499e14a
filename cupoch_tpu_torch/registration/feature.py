"""Point-cloud features: FPFH (33 bins) and feature-space
correspondences (counterpart of the JAX package's
`registration/feature.py`; cupoch feature.h, fpfh.cu).

The pair features of each point and its [N, K] neighbours are computed
at once; the three 11-bin histograms are one `index_add_` of the pair
weights into an [N * 33] vector (the JAX package builds an
[N, K, 3, 33] one-hot for its matrix unit, 4 GB at 100k points and 100
neighbours). Feature-space nearest neighbours are the expansion
|q|^2 + |d|^2 - 2 q.d (in f64, see `_feature_nn`) over row tiles of
the query features, with the first least index.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..knn import KDTreeSearchParam, KDTreeSearchParamKNN, search_neighbors
from ..utility import console
from ..utility.device import resolve_device

_BINS = 11
_DIM = 3 * _BINS
# elements of one [tile, N] distance block of `_feature_nn` (2 GiB f64)
_NN_BLOCK = 1 << 28
# rows of one [rows, K, 33] gather of `_fpfh`
_FPFH_ROWS = 8192


class Feature:
    """Dense feature matrix (cupoch Feature<Dim>): `data` is
    [dim, num] f32 (one column a point) on `device` (default "cuda";
    a tensor keeps its own)."""

    def __init__(self, data=None, device=None):
        if isinstance(data, torch.Tensor):
            self.device = data.device
        else:
            self.device = resolve_device(device)
        self.data = np.zeros((0, 0), np.float32) if data is None else data

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @data.setter
    def data(self, v):
        if isinstance(v, torch.Tensor):
            self._data = v.to(device=self.device, dtype=torch.float32)
        else:
            self._data = torch.tensor(np.asarray(v, np.float32),
                                      device=self.device)

    def resize(self, dim: int, n: int):
        self._data = torch.zeros((dim, n), device=self.device)

    def dimension(self) -> int:
        return int(self._data.shape[0])

    def num(self) -> int:
        return int(self._data.shape[1])

    def is_empty(self) -> bool:
        return self._data.numel() == 0

    def __repr__(self):
        return (f"Feature class with dimension = {self.dimension()} and "
                f"num = {self.num()}.")


# ---------------------------------------------------------------------------
# FPFH (cupoch fpfh.cu)
# ---------------------------------------------------------------------------

def _pair_features(p1, n1, p2, n2):
    """Darboux-frame pair features (cupoch ComputePairFeatures); every
    argument [..., 3]. Returns (f0, f1, f2, d)."""
    dp = p2 - p1
    d = torch.linalg.norm(dp, dim=-1)
    safe_d = d.clamp(min=1e-20)
    angle1 = (n1 * dp).sum(-1) / safe_d
    angle2 = (n2 * dp).sum(-1) / safe_d
    # acos(|a1|) > acos(|a2|)  <=>  |a1| < |a2|: swap the two roles
    swap = angle1.abs() < angle2.abs()
    sw = swap[..., None]
    n1c = torch.where(sw, n2, n1)
    n2c = torch.where(sw, n1, n2)
    dpc = torch.where(sw, -dp, dp)
    f2 = torch.where(swap, -angle2, angle1)
    v = torch.linalg.cross(dpc, n1c, dim=-1)
    v_norm = torch.linalg.norm(v, dim=-1)
    v = v / v_norm.clamp(min=1e-20)[..., None]
    w = torch.linalg.cross(n1c, v, dim=-1)
    f1 = (v * n2c).sum(-1)
    f0 = torch.atan2((w * n2c).sum(-1), (n1c * n2c).sum(-1))
    degenerate = (d == 0.0) | (v_norm == 0.0)
    zero = torch.zeros_like(f0)
    return (torch.where(degenerate, zero, f0),
            torch.where(degenerate, zero, f1),
            torch.where(degenerate, zero, f2), d)


def _hist33(f0, f1, f2, weight):
    """[N, 33]: the weights [N, K] of each pair added into the bins of
    f0 (over [-pi, pi]), f1 and f2 (over [-1, 1]), 11 each, by one
    `index_add_` (cupoch fpfh.cu's scattered adds)."""
    N = f0.shape[0]
    b0 = torch.floor(11.0 * (f0 + math.pi) / (2.0 * math.pi)).clamp(0, 10)
    b1 = torch.floor(11.0 * (f1 + 1.0) * 0.5).clamp(0, 10)
    b2 = torch.floor(11.0 * (f2 + 1.0) * 0.5).clamp(0, 10)
    row = torch.arange(N, device=f0.device)[:, None, None] * _DIM
    bins = torch.stack([b0, b1 + 11.0, b2 + 22.0], -1).long() + row
    w = weight[..., None].expand(bins.shape)
    out = f0.new_zeros(N * _DIM)
    out.index_add_(0, bins.reshape(-1), w.reshape(-1))
    return out.reshape(N, _DIM)


def _spfh(points, normals, idx):
    """[N, 33] SPFH from an [N, K] neighbour table, -1 padded (cupoch
    compute_spfh_functor): each neighbour other than the point itself
    adds 100 / (neighbours - 1) to its three bins."""
    N = points.shape[0]
    self_idx = torch.arange(N, device=points.device)[:, None]
    valid = idx >= 0
    use = valid & (idx != self_idx)
    safe = idx.clamp(0, N - 1).long()
    f0, f1, f2, _ = _pair_features(points[:, None, :], normals[:, None, :],
                                   points[safe], normals[safe])
    cnt = valid.sum(-1).to(torch.float32)
    hist_incr = 100.0 / (cnt - 1.0).clamp(min=1.0)
    return _hist33(f0, f1, f2, use.to(torch.float32) * hist_incr[:, None])


def _fpfh(spfh, idx, d2):
    """cupoch compute_fpfh_functor: the neighbours' SPFH weighted by
    1 / d2 (the squared distance, as the reference does), each 11-bin
    block scaled to 100, plus the point's own SPFH. The neighbours are
    gathered in row chunks of `_FPFH_ROWS`."""
    N = spfh.shape[0]
    self_idx = torch.arange(N, device=spfh.device)[:, None]
    use = (idx >= 0) & (idx != self_idx) & (d2 > 0.0) & torch.isfinite(d2)
    w = torch.where(use, 1.0 / d2.clamp(min=1e-20), 0.0)
    safe = idx.clamp(0, N - 1).long()
    ft = torch.cat([(spfh[safe[r:r + _FPFH_ROWS]]
                     * w[r:r + _FPFH_ROWS, :, None]).sum(1)
                    for r in range(0, N, _FPFH_ROWS)]) if N else spfh
    block = ft.reshape(N, 3, _BINS).sum(-1)
    scale = torch.where(block != 0.0, 100.0 / block, 0.0)
    return ft * scale.repeat_interleave(_BINS, -1) + spfh


def compute_fpfh_feature(input, search_param: Optional[
        KDTreeSearchParam] = None) -> Feature:
    """33-bin Fast Point Feature Histograms of a cloud with normals
    (cupoch ComputeFPFHFeature), on the cloud's device."""
    if not input.has_normals():
        console.log_error(
            "[ComputeFPFHFeature] Failed because input point cloud has no "
            "normal.")
    search_param = search_param or KDTreeSearchParamKNN()
    pts = input.points
    idx, d2 = search_neighbors(pts, pts, search_param)
    ft = _fpfh(_spfh(pts, input.normals, idx), idx, d2)
    return Feature(ft.T)


# ---------------------------------------------------------------------------
# feature-space correspondences
# ---------------------------------------------------------------------------

def _feature_nn(query_f: torch.Tensor, data_f: torch.Tensor) -> torch.Tensor:
    """1-NN in feature space: [Q, D] x [N, D] -> [Q] int64, the first
    least |q|^2 + |d|^2 - 2 q.d (as |d|^2 - 2 q.d, one fused product a
    tile), in row tiles whose [tile, N] block stays within `_NN_BLOCK`
    elements.

    The expansion is evaluated in f64. FPFH of flat regions are nearly
    equal, so many queries have two targets within f32 rounding of
    each other (about 0.01 at squared norms near 1e5), and an f32
    product rounds differently on the card, on the CPU and in the JAX
    package: the picks would differ. In f64 the card and the CPU pick
    the same target; the reference's pick differs only on such
    f32 near-ties."""
    N = data_f.shape[0]
    tile = max(1, min(8192, _NN_BLOCK // max(N, 1)))
    data = data_f.double()
    dn = (data * data).sum(-1)
    out = []
    for q in query_f.double().split(tile):
        # |q|^2 is the same along a row; left out, it moves a pick only
        # on an f64 near-tie
        out.append(torch.argmin(torch.addmm(dn, q, data.T, alpha=-2.0),
                                -1))
    return torch.cat(out) if out else torch.zeros(
        0, dtype=torch.int64, device=query_f.device)


def correspondences_from_features(source_features: Feature,
                                  target_features: Feature,
                                  mutual_filter: bool = False,
                                  mutual_consistency_ratio: float = 0.1
                                  ) -> np.ndarray:
    """[K, 2] int32 (source, target) pairs of feature-space nearest
    neighbours (cupoch CorrespondencesFromFeatures); with
    `mutual_filter`, only pairs that are each other's nearest, unless
    fewer than `mutual_consistency_ratio` of the sources keep one."""
    src = source_features.data.T
    tgt = target_features.data.T.to(src.device)
    n_src = src.shape[0]
    nn_st = _feature_nn(src, tgt).cpu().numpy()
    corres = np.stack([np.arange(n_src), nn_st], -1).astype(np.int32)
    if not mutual_filter:
        return corres
    nn_ts = _feature_nn(tgt, src).cpu().numpy()
    mutual = nn_ts[corres[:, 1]] == corres[:, 0]
    if mutual.sum() >= mutual_consistency_ratio * n_src:
        return corres[mutual]
    console.log_warning(
        "Too few correspondences after mutual filter, fall back to "
        "original correspondences.")
    return corres
