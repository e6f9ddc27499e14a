"""Point-cloud operations on tensors (counterpart of the JAX package's
`geometry/pointcloud_ops.py`; cupoch down_sample.cu,
estimate_normals.cu, pointcloud_cluster.cu, segmentation.cu).

Each function runs on the device of its inputs. Where the JAX package
carries fixed-capacity arrays and a validity mask through `jit`, these
take the rows to use (an optional `mask`) and return results at their
exact size, reading at most a few scalars from the device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..knn import bruteforce, gridhash
from ..utility import eigen as ueigen
from ..utility.shape import INVALID_INDEX


def _all(points: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(points.shape[0], dtype=torch.bool,
                          device=points.device)
    return mask.to(device=points.device, dtype=torch.bool)


# ---------------------------------------------------------------------------
# voxel down-sample (cupoch down_sample.cu VoxelDownSample)
# ---------------------------------------------------------------------------

def voxel_down_sample(points: torch.Tensor, voxel_size: float,
                      normals: Optional[torch.Tensor] = None,
                      colors: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None):
    """The mean of the points (and of their normals and colours) in
    each occupied voxel, ordered by voxel key (x, then y, then z), as
    the JAX package's `lexsort` orders them. Returns (points [M, 3],
    normals or None (renormalised), colors or None).

    Three stable sorts give that order for any extent of the voxel
    indices. Each voxel's sum is the difference of an f64 running sum
    over the sorted rows at its two ends: the same on every run and
    device (atomic adds would sum in a different order each run, and
    the least bit of a mean moves the normals, the features and FGR's
    matches after it), and within 1e-6 relative of the reference's f32
    segment sums."""
    if mask is not None:
        keep = _all(points, mask)
        points = points[keep]
        normals = None if normals is None else normals[keep]
        colors = None if colors is None else colors[keep]
    dev = points.device
    if points.shape[0] == 0:
        empty = points.new_zeros((0, 3))
        return (empty, None if normals is None else empty,
                None if colors is None else empty)
    v = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    min_bound = points.amin(0) - v * 0.5
    cells = torch.floor((points - min_bound) / v).to(torch.int32)
    order = torch.arange(points.shape[0], device=dev)
    for axis in (2, 1, 0):
        order = order[torch.argsort(cells[order, axis], stable=True)]
    sc = cells[order]
    last = torch.ones(sc.shape[0], dtype=torch.bool, device=dev)
    last[:-1] = (sc[1:] != sc[:-1]).any(-1)
    ends = torch.nonzero(last)[:, 0]                 # each voxel's last row
    cnt = torch.diff(ends, prepend=ends.new_tensor([-1])).double()

    def seg_mean(x):
        # [3, N] rows: a scan along the inner dimension runs wide
        run = torch.cumsum(x[order].double().T.contiguous(), 1)[:, ends]
        sums = torch.diff(run, dim=1, prepend=run.new_zeros((3, 1)))
        return (sums / cnt).T.to(torch.float32)

    out_n = None
    if normals is not None:
        out_n = seg_mean(normals)
        out_n = out_n / torch.linalg.norm(out_n, dim=-1,
                                          keepdim=True).clamp(min=1e-12)
    return (seg_mean(points), out_n,
            None if colors is None else seg_mean(colors))


# ---------------------------------------------------------------------------
# farthest point down-sample (cupoch down_sample.cu FarthestPointDownSample)
# ---------------------------------------------------------------------------

def farthest_point_indices(points: torch.Tensor, num_samples: int,
                           start_index: int = 0,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Iterative farthest-point sampling: [num_samples] int64 indices,
    the first `start_index`. The loop stays on the device: the last
    pick is a 0-d tensor and no step reads it back. `argmax` keeps the
    first maximum, as the reference's does."""
    valid = _all(points, mask)
    min_d2 = torch.where(valid, float("inf"), float("-inf"))
    last = torch.tensor(start_index, dtype=torch.int64, device=points.device)
    picked = []
    for _ in range(num_samples):
        picked.append(last)
        d = points - points[last]
        min_d2 = torch.minimum(min_d2, (d * d).sum(-1))
        min_d2 = torch.where(valid, min_d2, float("-inf"))
        last = torch.argmax(min_d2)
    if not picked:
        return torch.zeros(0, dtype=torch.int64, device=points.device)
    return torch.stack(picked)


# ---------------------------------------------------------------------------
# normals (cupoch estimate_normals.cu)
# ---------------------------------------------------------------------------

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


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x, dim=-1, keepdim=True)


def orient_normals_to_align_with_direction(normals: torch.Tensor,
                                           direction) -> torch.Tensor:
    """Flip normals against `direction`; zero normals become it
    (cupoch align_normals_direction_functor)."""
    direction = torch.as_tensor(direction, dtype=normals.dtype) \
        .to(normals.device)
    zero = _norm(normals) < 1e-12
    flipped = torch.where((normals @ direction < 0)[:, None], -normals,
                          normals)
    return torch.where(zero, direction.expand_as(normals), flipped)


def orient_normals_towards_camera_location(points: torch.Tensor,
                                           normals: torch.Tensor,
                                           camera) -> torch.Tensor:
    """Flip normals to face `camera`; zero normals point at it."""
    camera = torch.as_tensor(camera, dtype=points.dtype).to(points.device)
    to_cam = camera - points
    zero = _norm(normals) < 1e-12
    tc_unit = to_cam / _norm(to_cam).clamp(min=1e-12)
    flipped = torch.where(((normals * to_cam).sum(-1) < 0)[:, None],
                          -normals, normals)
    return torch.where(zero, tc_unit, flipped)


# ---------------------------------------------------------------------------
# outlier removal (cupoch down_sample.cu RemoveRadius/StatisticalOutliers)
# ---------------------------------------------------------------------------

def radius_outlier_mask(points: torch.Tensor, nb_points: int, radius,
                        mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Keep points with more than `nb_points` neighbours (self
    included) within `radius`, counted over the hash grid."""
    mask = _all(points, mask)
    grid = gridhash.build_grid(points, radius, mask=mask)
    counts = gridhash.query_radius_count(grid, points, radius)
    return mask & (counts > nb_points)


def statistical_outlier_mask(points: torch.Tensor, nb_neighbors: int,
                             std_ratio, mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Keep points whose mean distance to their `nb_neighbors` nearest
    (self included, brute force over every point: O(N^2)) is at most
    the mean of those distances plus `std_ratio` standard deviations."""
    mask = _all(points, mask)
    _, d2 = bruteforce.knn_search(points, points, nb_neighbors,
                                  data_mask=mask)
    fin = torch.isfinite(d2)
    d = torch.sqrt(torch.where(fin, d2, 0.0))
    cnt = fin.sum(-1)
    avg = d.sum(-1) / cnt.clamp(min=1)
    valid = mask & (cnt > 0)
    vm = valid.to(torch.float32)
    n_valid = vm.sum().clamp(min=1.0)
    mean = (avg * vm).sum() / n_valid
    var = ((avg - mean) ** 2 * vm).sum() / (n_valid - 1.0).clamp(min=1.0)
    thresh = mean + torch.tensor(std_ratio, dtype=torch.float32,
                                 device=points.device) * torch.sqrt(var)
    return valid & (avg <= thresh)


# ---------------------------------------------------------------------------
# filters (cupoch down_sample.cu GaussianFilter / PassThroughFilter)
# ---------------------------------------------------------------------------

def gaussian_filter(points: torch.Tensor, radius, sigma2, max_nn: int = 32,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each point replaced by the Gaussian-weighted mean of its (up to
    `max_nn`) neighbours within `radius`."""
    mask = _all(points, mask)
    grid = gridhash.build_grid(points, radius, mask=mask)
    idx, d2, _ = gridhash.query_hybrid(grid, points, radius, max_nn)
    valid = idx >= 0
    nb = points[idx.clamp(0, points.shape[0] - 1).long()]
    w = torch.exp(-0.5 * d2 / torch.tensor(sigma2, dtype=torch.float32,
                                           device=points.device))
    w = torch.where(valid, w, 0.0)
    wsum = w.sum(-1, keepdim=True).clamp(min=1e-12)
    out = (nb * w[..., None]).sum(1) / wsum
    return torch.where(mask[:, None], out, points)


def pass_through_filter_mask(points: torch.Tensor, axis_no: int, min_bound,
                             max_bound, mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    v = points[:, axis_no]
    return _all(points, mask) & (v >= min_bound) & (v <= max_bound)


# ---------------------------------------------------------------------------
# RANSAC plane segmentation (cupoch segmentation.cu SegmentPlane)
# ---------------------------------------------------------------------------

def plane_triples(n: int, num_iterations: int, seed: int = 0
                  ) -> torch.Tensor:
    """[num_iterations, 3] int64 triples of distinct indices below `n`,
    drawn on the host from `torch.Generator` seeded with `seed`, so the
    card and the CPU score the same hypotheses. (The JAX package draws
    with `jax.random.gumbel` and `top_k`; those draws cannot be
    reproduced here, and its tests feed them to `score_planes`.)"""
    if n < 3:
        raise ValueError("segment_plane needs at least 3 points")
    g = torch.Generator().manual_seed(int(seed))
    a = torch.randint(0, n, (num_iterations,), generator=g)
    b = torch.randint(0, n - 1, (num_iterations,), generator=g)
    c = torch.randint(0, n - 2, (num_iterations,), generator=g)
    b = b + (b >= a).to(torch.int64)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    c = c + (c >= lo).to(torch.int64)
    c = c + (c >= hi).to(torch.int64)
    return torch.stack([a, b, c], -1)


def score_planes(points: torch.Tensor, triples: torch.Tensor,
                 distance_threshold, mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score the planes through the given [B, 3] point triples against
    every point in one [N, B] pass and keep the one with the most
    inliers (the first on ties; a degenerate triple never wins).
    Returns (plane [4]: n.x + d = 0, inlier mask [N])."""
    mask = _all(points, mask)
    triples = triples.to(points.device).long()
    p0, p1, p2 = (points[triples[:, i]] for i in range(3))
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    nn = _norm(n)
    n = n / nn.clamp(min=1e-12)
    d = -(n * p0).sum(-1)
    dist = (points @ n.T + d[None, :]).abs()             # [N, B]
    thr = torch.tensor(distance_threshold, dtype=torch.float32,
                       device=points.device)
    inl = (dist <= thr) & mask[:, None]
    counts = torch.where(nn[:, 0] > 1e-12, inl.sum(0), -1)
    best = torch.argmax(counts)
    return torch.cat([n[best], d[best][None]]), inl[:, best]


def segment_plane(points: torch.Tensor, mask: Optional[torch.Tensor],
                  distance_threshold, num_iterations: int, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC with every hypothesis scored at once (the JAX package's
    `segment_plane`): `num_iterations` triples of distinct points among
    the rows `mask` keeps, drawn as `plane_triples` draws them from
    `seed` (the JAX package draws from a `jax.random` key). Returns
    (plane [4]: n.x + d = 0, inlier mask [N])."""
    mask = _all(points, mask)
    rows = torch.nonzero(mask).reshape(-1)
    triples = rows[plane_triples(int(rows.numel()), num_iterations,
                                 seed).to(rows.device)]
    return score_planes(points, triples, distance_threshold, mask)


# ---------------------------------------------------------------------------
# DBSCAN (cupoch pointcloud_cluster.cu, G-DBSCAN)
# ---------------------------------------------------------------------------

def cluster_dbscan(points: torch.Tensor, eps, min_points: int,
                   max_nn: int = 64, mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[N] int64 cluster roots (noise -1) by min-label propagation over
    the eps-graph of core points, with pointer jumping: the clusters of
    BFS from each core point. A host loop of device sweeps, with one
    scalar read a sweep (whether any label changed)."""
    N = points.shape[0]
    mask = _all(points, mask)
    grid = gridhash.build_grid(points, eps, mask=mask)
    idx, _, cnt = gridhash.query_hybrid(grid, points, eps, max_nn)
    core = mask & (cnt >= min_points)            # the counts include self
    nbr_valid = idx >= 0
    idx_c = idx.clamp(0, N - 1).long()
    nbr_core = core[idx_c] & nbr_valid
    labels = torch.where(core, torch.arange(N, device=points.device), N)
    while True:
        nbr_min = torch.where(nbr_core, labels[idx_c], N).amin(-1)
        # core points take their core neighbours' least label, border
        # points that of their nearest-labelled core neighbour
        new = torch.where(mask, torch.minimum(labels, nbr_min), labels)
        new = torch.where(new < N, new[new.clamp(0, max(N - 1, 0))], new)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return torch.where(labels >= N, INVALID_INDEX, labels)


def densify_labels(labels) -> np.ndarray:
    """Renumber cluster roots to 0..C-1 in ascending root order (noise
    stays -1)."""
    lab = np.asarray(labels)
    out = np.full_like(lab, -1)
    keep = lab >= 0
    out[keep] = np.unique(lab[keep], return_inverse=True)[1]
    return out
