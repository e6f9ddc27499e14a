"""ICP registration entry point (cupoch RegistrationICP,
registration.cu).

Only the pooled-grid branch is ported: targets of more than
`_GRID_THRESHOLD` points with a PointToPoint, PointToPlane or
SymmetricMethod estimator whose grid plan is accepted. The other
branches of the JAX package's `registration_icp` (brute force for
small targets, the run-grid fallback for a rejected plan, Colored and
Generalized ICP) raise NotImplementedError naming the branch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..knn import poolgrid
from ..utility import console
from ..utility.shape import bucket_size, pad_axis0, valid_mask
from . import fused_icp
from .estimation import (
    TransformationEstimation,
    TransformationEstimationPointToPoint,
    TransformationEstimationType,
)


class ICPConvergenceCriteria:
    """cupoch registration.h (same defaults)."""

    def __init__(self, relative_fitness: float = 1e-6,
                 relative_rmse: float = 1e-6, max_iteration: int = 30):
        self.relative_fitness = float(relative_fitness)
        self.relative_rmse = float(relative_rmse)
        self.max_iteration = int(max_iteration)


class RegistrationResult:
    """cupoch registration.h, plus the capacity-drop counts of the
    pooled grid and the number of ICP iterations run."""

    def __init__(self, transformation=None):
        self.transformation = (
            np.eye(4, dtype=np.float32) if transformation is None
            else np.asarray(transformation, np.float32))
        self.correspondence_set = np.zeros((0, 2), np.int32)
        self.inlier_rmse = 0.0
        self.fitness = 0.0
        # target points dropped by per-cell caps and source queries
        # dropped by per-supertile pool caps
        self.n_dropped_target = 0
        self.n_dropped_queries = 0
        self.iterations = 0

    def __repr__(self):
        return (f"RegistrationResult with fitness={self.fitness:.6f}, "
                f"inlier_rmse={self.inlier_rmse:.6f}, and correspondence_set "
                f"of size {len(self.correspondence_set)}.")


_GRID_THRESHOLD = 20000  # the pooled grid serves targets above this size
_POOL_ESTIMATORS = (TransformationEstimationType.PointToPoint,
                    TransformationEstimationType.PointToPlane,
                    TransformationEstimationType.SymmetricMethod)


def _prep(pcd, need_normals: bool):
    pts = pcd.points
    cap = bucket_size(pts.shape[0])
    mask = valid_mask(pts.shape[0], cap, device=pts.device)
    pts = pad_axis0(pts, cap)
    if need_normals and pcd.has_normals():
        normals = pad_axis0(pcd.normals, cap)
    else:
        normals = torch.zeros_like(pts)
    return pts, mask, normals


def _make_result(T, idx, fit, rmse, n_src):
    res = RegistrationResult(T.cpu().numpy())
    res.fitness = float(fit)
    res.inlier_rmse = float(rmse)
    idx = idx[:n_src].cpu().numpy()
    src_i = np.nonzero(idx >= 0)[0]
    res.correspondence_set = np.stack(
        [src_i, idx[src_i]], -1).astype(np.int32)
    return res


def registration_icp(
    source,
    target,
    max_correspondence_distance: float,
    init=None,
    estimation: Optional[TransformationEstimation] = None,
    criteria: Optional[ICPConvergenceCriteria] = None,
) -> RegistrationResult:
    """Iterative closest point on the device of the two clouds."""
    if max_correspondence_distance <= 0.0:
        console.log_error("Invalid max_correspondence_distance.")
    estimation = estimation or TransformationEstimationPointToPoint()
    criteria = criteria or ICPConvergenceCriteria()
    est_type = estimation.get_transformation_estimation_type()
    if est_type not in _POOL_ESTIMATORS:
        raise NotImplementedError(
            f"registration_icp: the {est_type.name} branch is not ported "
            f"yet")
    if source.points.device != target.points.device:
        raise ValueError("source and target must lie on one device")
    need_tgt_normals = est_type in (
        TransformationEstimationType.PointToPlane,
        TransformationEstimationType.SymmetricMethod)
    if need_tgt_normals and not target.has_normals():
        console.log_error(
            "TransformationEstimationPointToPlane and ColoredICP "
            "require pre-computed target normal vectors.")
    if est_type == TransformationEstimationType.SymmetricMethod \
            and not source.has_normals():
        console.log_error("SymmetricMethod requires source normals.")
    n_tgt = len(target)
    if n_tgt <= _GRID_THRESHOLD:
        raise NotImplementedError(
            f"registration_icp: the brute-force branch for targets of "
            f"{_GRID_THRESHOLD} points or fewer is not ported yet "
            f"(target has {n_tgt})")

    init_T = torch.eye(4, dtype=torch.float32) if init is None \
        else torch.as_tensor(np.asarray(init, np.float32))
    src, src_mask, src_normals = _prep(source, True)
    tgt, tgt_mask, tgt_normals = _prep(target, need_tgt_normals)

    src_np = source.points.cpu().numpy()
    initn = init_T.numpy()
    src_np_t = src_np @ initn[:3, :3].T + initn[:3, 3]
    attrs, est_code = fused_icp.make_target_attrs(
        est_type, tgt, tgt_normals)
    tgt_np = target.points.cpu().numpy()
    pplan = poolgrid.plan_poolgrid(
        tgt_np, max_correspondence_distance, query_points=src_np_t,
        est=est_code)
    if pplan is None:
        raise NotImplementedError(
            "registration_icp: the run-grid fallback for a rejected pool "
            "plan is not ported yet")

    def build(plan):
        return poolgrid.make_poolgrid(
            tgt, attrs, plan["origin"], plan["cell_size"], plan["dims"],
            plan["cap"], plan["kc"], est=est_code, tile=plan["tile"],
            mask=tgt_mask, active_cells=plan.get("active_cells"))

    grid = build(pplan)
    nd_t = int(grid.n_dropped)
    if nd_t > max(64, 0.002 * n_tgt):
        # the drop-bounded cap lost a meaningful fraction of the target:
        # retry once at the occupancy maximum before accepting it
        console.log_warning(
            "pool grid dropped %d target points; regrowing cell capacity",
            nd_t)
        regrown = poolgrid.plan_poolgrid(
            tgt_np, max_correspondence_distance, query_points=src_np_t,
            est=est_code, cap_percentile=100.0)
        if regrown is not None:
            pplan = regrown
            grid = build(pplan)
            nd_t = int(grid.n_dropped)
    T, idx, fit, rmse, it, nq_drop = fused_icp.icp_core_pool(
        src, src_mask, src_normals, grid, init_T,
        max_correspondence_distance, pplan["rebin_margin"],
        criteria.relative_fitness, criteria.relative_rmse, pplan["qp"],
        est_type, criteria.max_iteration)
    console.log_debug("pooled ICP finished after %s iterations", it)
    res = _make_result(T, idx, fit, rmse, len(source))
    res.n_dropped_target = nd_t
    res.n_dropped_queries = int(nq_drop)
    res.iterations = it
    if res.n_dropped_queries:
        console.log_warning("pool query binning dropped %d source points",
                            res.n_dropped_queries)
    return res
