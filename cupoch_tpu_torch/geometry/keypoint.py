"""ISS keypoint detection (counterpart of the JAX package's
`geometry/keypoint.py`; cupoch keypoint.h, iss_keypoints.cu).

Intrinsic Shape Signatures: each point's covariance over a
salient-radius neighbourhood, the eigenvalue-ratio test (l2/l1 < g21,
l3/l2 < g32 with l1 >= l2 >= l3), saliency l3, then non-maximum
suppression over a non-max-radius neighbourhood. Both neighbourhoods
are [N, max_nn] index tensors from `knn.search_neighbors`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..knn import NUM_MAX_NN, KDTreeSearchParamHybrid, search_neighbors
from ..knn.bruteforce import knn_search
from ..utility import console
from ..utility import eigen as ueigen
from . import pointcloud_ops as ops


def compute_model_resolution(points: torch.Tensor, mask=None) -> float:
    """Mean nearest-neighbour distance (cupoch ComputeModelResolution):
    the square root of the mean squared distance to each point's
    nearest other point, by brute force."""
    idx, d2 = knn_search(points, points, 2, data_mask=mask)
    valid = idx[:, 1] >= 0
    if not bool(valid.any()):
        return 0.0
    return float(torch.sqrt(d2[:, 1][valid].mean()))


def _nms(saliency: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """Points with a saliency and none greater among their neighbours
    (cupoch is_local_maxima_functor)."""
    valid = nbr_idx >= 0
    idx = nbr_idx.clamp(0, saliency.shape[0] - 1).long()
    nbr_sal = torch.where(valid, saliency[idx], float("-inf"))
    return (saliency >= 0) & (saliency[:, None] >= nbr_sal).all(-1)


def compute_iss_keypoints(pcd, salient_radius: float = 0.0,
                          non_max_radius: float = 0.0,
                          gamma_21: float = 0.975, gamma_32: float = 0.975,
                          min_neighbors: int = 5,
                          max_neighbors: int = NUM_MAX_NN
                          ) -> Tuple["object", np.ndarray]:
    """(keypoint PointCloud, [N] bool keep mask as numpy). With either
    radius 0, both come from the model resolution (6x and 4x)."""
    from .pointcloud import PointCloud

    if pcd.is_empty():
        console.log_warning("[ComputeISSKeypoints] Input PointCloud is "
                            "empty!")
        return PointCloud(device=pcd.device), np.zeros(0, bool)
    points = pcd.points
    if salient_radius == 0.0 or non_max_radius == 0.0:
        resolution = compute_model_resolution(points)
        salient_radius = 6.0 * resolution
        non_max_radius = 4.0 * resolution
        console.log_debug(
            "[ComputeISSKeypoints] Computed salient_radius = %g, "
            "non_max_radius = %g from input model", salient_radius,
            non_max_radius)
    nbr_idx, _ = search_neighbors(
        points, points, KDTreeSearchParamHybrid(salient_radius,
                                                max_neighbors))
    cov, cnt = ops.covariances_from_neighbors(points, nbr_idx)
    eigs, _ = ueigen.symeig3x3(cov)          # ascending: e0 <= e1 <= e2
    e0, e1, e2 = eigs[..., 0], eigs[..., 1], eigs[..., 2]
    ok = ((cnt >= min_neighbors) & (e2 > 0)
          & (e1 / e2.clamp(min=1e-30) < gamma_21)
          & (e0 / e1.clamp(min=1e-30) < gamma_32))
    saliency = torch.where(ok, e0, -1.0)
    nms_idx, _ = search_neighbors(
        points, points, KDTreeSearchParamHybrid(non_max_radius,
                                                max_neighbors))
    keep = _nms(saliency, nms_idx)
    out = pcd._gather(torch.nonzero(keep)[:, 0])
    out.covariances = None
    console.log_debug("[ComputeISSKeypoints] Extracted %d keypoints",
                      int(keep.sum()))
    return out, keep.cpu().numpy()
