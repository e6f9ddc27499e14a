"""ICP registration entry points (cupoch RegistrationICP and
EvaluateRegistration, registration.cu).

`registration_icp` takes, for every estimator, the branch the JAX
package takes (`_choose_grid`):
- targets of at most `_GRID_THRESHOLD` points: brute-force 1-NN in the
  generic loop (`_icp_core`);
- larger targets: the pooled grid when its plan is accepted (all five
  estimators); for PT2PT, PT2PL and SYM the run grid when only that
  plan is accepted;
- else the generic loop over the dense roll grid, the active-cell grid
  (both reduced by kernel 4), brute force up to `_BRUTE_FALLBACK_MAX`
  target points, or the hash grid.
Every branch then runs through one path: its loop, each a backend of
`fused_icp.icp_loop`, then the result. Colored ICP and GICP precompute
their estimator inputs first: the target's colour gradient, or both
clouds' covariances. `evaluate_registration` makes one correspondence
pass: over the run grid above the threshold when its plan is accepted,
else brute force.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..knn import (bruteforce, cellgrid, gridhash, poolgrid, rollgrid,
                   rungrid, rungrid_fused)
from ..utility import console, trace
from ..utility.shape import bucket_size, pad_axis0, valid_mask
from ..utility.transforms import transform_points
from . import fused_icp
from .estimation import (
    TransformationEstimation,
    TransformationEstimationPointToPoint,
    TransformationEstimationType,
    colored_system,
    gicp_system,
    normal_system,
    solve_normal_system,
)

_ET = TransformationEstimationType


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


_GRID_THRESHOLD = 20000  # below this, brute-force 1-NN is faster than a grid
# When every grid plan rejects a target (a surface scan with a search
# radius that piles it into a few cells), tiled brute force serves up
# to this many target points, as in the JAX package, and the exact hash
# grid beyond.
_BRUTE_FALLBACK_MAX = 200_000
_RUN_GRID_ESTIMATORS = (_ET.PointToPoint, _ET.PointToPlane,
                        _ET.SymmetricMethod)


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
    res = RegistrationResult(trace.to_host(T).numpy())
    res.fitness = float(trace.to_host(fit))
    res.inlier_rmse = float(trace.to_host(rmse))
    idx = trace.to_host(idx[:n_src]).numpy()
    src_i = np.nonzero(idx >= 0)[0]
    res.correspondence_set = np.stack(
        [src_i, idx[src_i]], -1).astype(np.int32)
    return res


def _correspondence_fn(tgt, tgt_mask, max_dist, use_grid, grid, counts):
    """1-NN within max_dist for transformed source points: (idx, d2),
    -1 / inf where none. `use_grid` names the backend: "roll", "cell" or
    "hash" (or True) over `grid`, or "brute" (or False), brute force over
    the prefixes `counts` = (source, target points) of the padded
    clouds."""
    if use_grid not in ("brute", False):
        query = {"roll": rollgrid.query_nn_rollgrid,
                 "cell": cellgrid.query_nn_cellgrid}.get(use_grid,
                                                         gridhash.query_nn)
        return lambda src_t: query(grid, src_t, max_dist)
    r2 = torch.tensor(max_dist, dtype=torch.float32) ** 2

    def corres(src_t):
        idx, d2 = bruteforce.nn_search(src_t, tgt, data_mask=tgt_mask,
                                       n_queries=counts[0],
                                       n_data=counts[1])
        ok = d2 <= r2.to(d2.device)
        return torch.where(ok, idx, -1), torch.where(ok, d2, float("inf"))

    return corres


def _icp_core(src, src_mask, src_normals, tgt, tgt_mask, tgt_normals,
              init_T, max_dist, relative_fitness, relative_rmse,
              est_type: TransformationEstimationType, max_iteration: int,
              use_grid=False, aux=None, grid=None, *, counts):
    """The generic ICP loop on the device of the clouds: `icp_loop` over
    correspondence (`_correspondence_fn`) and the estimator's normal
    system, solved on the host. Each pass reads the system and the
    fitness statistics in one device-to-host copy; the final evaluation
    is the pass that converged, or one more pass when the iterations ran
    out. `aux` carries Colored ICP's intensities, target gradient and
    square-rooted weights, or GICP's padded covariances. `counts`: the
    clouds' point counts (source, target), the prefixes their masks keep;
    brute force scores no padding.
    Returns (T [4, 4] f32 on the host, idx [Np] int32 on the device,
    fitness, rmse (host 0-d tensors), iterations run)."""
    dev = src.device
    corres_fn = _correspondence_fn(tgt, tgt_mask, max_dist, use_grid, grid,
                                   counts)
    M = tgt.shape[0]
    n_src = fused_icp._n_source(src_mask, None)

    def eval_state(T):
        src_t = transform_points(T.to(dev), src)
        idx, d2 = corres_fn(src_t)
        idx = torch.where(src_mask, idx, -1)
        ok = idx >= 0
        head = torch.stack([ok.sum().to(torch.float32),
                            torch.where(ok, d2, 0.0).sum()])
        return src_t, idx, ok, head

    def system(T, src_t, idx, ok):
        # the source's normals and covariances turn with the pose; the
        # reference transforms the whole cloud each iteration instead
        ti = idx.clamp(0, M - 1).long()
        w = ok.to(torch.float32)
        R = T[:3, :3].to(dev)
        if est_type == _ET.ColoredICP:
            return colored_system(
                src_t, tgt[ti], tgt_normals[ti], aux["src_intensity"],
                aux["tgt_intensity"][ti], aux["tgt_color_gradient"][ti], w,
                aux["sqrt_lambda_geometric"], aux["sqrt_lambda_photometric"])
        if est_type == _ET.GeneralizedICP:
            src_cov_t = torch.einsum("ij,njk,lk->nil", R, aux["src_cov"], R)
            return gicp_system(src_t, src_cov_t, tgt[ti],
                               aux["tgt_cov"][ti], w)
        src_n = src_normals @ R.T if est_type == _ET.SymmetricMethod \
            else None
        return normal_system(est_type, src_t, tgt[ti], tgt_normals[ti],
                             src_n, w)

    last_idx = None

    def step(T):
        nonlocal last_idx
        src_t, last_idx, ok, head = eval_state(T)
        return trace.to_host(torch.cat([head,
                                        system(T, src_t, last_idx, ok)]))

    def final(T, stats):
        if stats is not None:   # the pass that converged was at T
            return (last_idx, *stats)
        _, idx, _, head = eval_state(T)
        host = trace.to_host(head)
        return (idx, *fused_icp.fit_rmse(host[0], host[1], n_src))

    T, (idx, fit, rmse), it, converged = fused_icp.icp_loop(
        step, (0, 1), lambda sums: solve_normal_system(est_type, sums[2:]),
        final, n_src, init_T, relative_fitness, relative_rmse, max_iteration)
    # the JAX while_loop counts updates, the grid loops count passes: the
    # pass that finds convergence makes no update
    return T, idx, fit, rmse, it - converged


def _choose_grid(target, tgt, tgt_mask, attrs, est_code, est_type, src_t,
                 max_dist):
    """The branch of `registration_icp` for a target above the grid
    threshold, with its grid built: the pooled grid when its plan is
    accepted; for PT2PT, PT2PL and SYM the run grid when only that plan
    is; else the generic loop over the dense roll grid (compact volumes),
    the active-cell grid (sparse, surface clouds), brute force up to
    `_BRUTE_FALLBACK_MAX` target points, or the hash grid. `src_t`: the
    source at the initial pose, the pool and run plans' queries.
    Returns (branch, grid, plan, target points the pooled grid
    dropped)."""
    points = target.points
    plan = poolgrid.plan_poolgrid(points, max_dist, query_points=src_t,
                                  est=est_code)
    if plan is not None:
        return ("pool", *_build_pool(target, tgt, tgt_mask, attrs, est_code,
                                     src_t, plan, max_dist))
    if est_type in _RUN_GRID_ESTIMATORS:
        plan = rungrid.plan_rungrid(points, max_dist, query_points=src_t,
                                    nch=attrs.shape[1])
        if plan is not None:
            with trace.span("registration.build", branch="run"):
                return "run", rungrid.make_rungrid(
                    tgt, attrs, plan["origin"], plan["cell_size"],
                    plan["dims"], plan["cap"], mask=tgt_mask, est=est_code,
                    kc=plan["kc"]), plan, 0
    plan = rollgrid.plan_rollgrid(points, max_dist)
    if plan is not None:
        with trace.span("registration.build", branch="roll"):
            return "roll", rollgrid.build_rollgrid(
                tgt, plan["origin"], plan["cell_size"], plan["dims"],
                plan["cap"], mask=tgt_mask), plan, 0
    plan = cellgrid.plan_cellgrid(points, max_dist)
    if plan is not None:
        with trace.span("registration.build", branch="cell"):
            return "cell", cellgrid.build_cellgrid(
                tgt, plan["origin"], plan["cell_size"], plan["active"],
                plan["dims"], plan["cap"], plan["n_active"],
                mask=tgt_mask), plan, 0
    if len(target) <= _BRUTE_FALLBACK_MAX:
        return "brute", None, None, 0
    with trace.span("registration.build", branch="hash"):
        return "hash", gridhash.build_grid(tgt, max_dist,
                                           mask=tgt_mask), None, 0


def _build_pool(target, tgt, tgt_mask, attrs, est_code, src_t, plan,
                max_dist):
    """The pooled grid of `plan`, with one regrow of the cell capacity
    when the planned cap drops too many targets. Returns (grid, plan,
    target points dropped)."""

    def build(plan):
        with trace.span("registration.build", branch="pool"):
            return poolgrid.make_poolgrid(
                tgt, attrs, plan["origin"], plan["cell_size"], plan["dims"],
                plan["cap"], plan["kc"], est=est_code, tile=plan["tile"],
                mask=tgt_mask, active_cells=plan.get("active_cells"))

    grid = build(plan)
    nd_t = int(trace.to_host(grid.n_dropped))
    if nd_t > max(64, 0.002 * len(target)):
        # the drop-bounded cap lost a meaningful fraction of the target:
        # retry once at the occupancy maximum before accepting it
        console.log_warning(
            "pool grid dropped %d target points; regrowing cell capacity",
            nd_t)
        regrown = poolgrid.plan_poolgrid(
            target.points, max_dist, query_points=src_t, est=est_code,
            cap_percentile=100.0)
        if regrown is not None:
            plan = regrown
            grid = build(plan)
            nd_t = int(trace.to_host(grid.n_dropped))
    return grid, plan, nd_t


def _pad_cov(cov, cap):
    """Covariances padded to `cap` rows with identity: inv(Ct + Cs) must
    stay finite on padded rows (a zero weight times nan is nan)."""
    n = cov.shape[0]
    padded = pad_axis0(cov, cap)
    pad_rows = (torch.arange(cap, device=cov.device) >= n)[:, None, None]
    return padded + pad_rows * torch.eye(3, dtype=cov.dtype,
                                         device=cov.device)


def _estimator_aux(est_type, estimation, source, target, max_dist,
                   cap_src, cap_tgt) -> dict:
    """Colored ICP's and GICP's precomputed inputs (cupoch colored_icp.cu
    InitializePointCloudForColoredICP, generalized_icp.cu
    InitializePointCloudForGeneralizedICP), padded with the clouds."""
    if est_type == _ET.ColoredICP:
        from .colored_icp import compute_color_gradient, intensity

        if not source.has_colors() or not target.has_colors():
            console.log_error("ColoredICP requires colors on both clouds.")
        grad = compute_color_gradient(target, max_dist * 2.0, 30)
        lam = estimation.lambda_geometric

        def f32_sqrt(x):
            return float(torch.tensor(x, dtype=torch.float32) ** 0.5)

        return {
            "src_intensity": pad_axis0(intensity(source.colors), cap_src),
            "tgt_intensity": pad_axis0(intensity(target.colors), cap_tgt),
            "tgt_color_gradient": pad_axis0(grad, cap_tgt),
            "sqrt_lambda_geometric": f32_sqrt(lam),
            "sqrt_lambda_photometric": f32_sqrt(1.0 - lam),
        }
    if est_type == _ET.GeneralizedICP:
        from .generalized_icp import initialize_cloud_for_gicp

        eps = getattr(estimation, "epsilon", 1e-3)
        return {
            "src_cov": _pad_cov(initialize_cloud_for_gicp(source, eps),
                                cap_src),
            "tgt_cov": _pad_cov(initialize_cloud_for_gicp(target, eps),
                                cap_tgt),
        }
    return {}


def registration_icp(
    source,
    target,
    max_correspondence_distance: float,
    init=None,
    estimation: Optional[TransformationEstimation] = None,
    criteria: Optional[ICPConvergenceCriteria] = None,
) -> RegistrationResult:
    """Iterative closest point on the device of the two clouds."""
    with trace.span("registration.icp", source_points=len(source),
                    target_points=len(target)):
        return _registration_icp(source, target, max_correspondence_distance,
                                 init, estimation, criteria)


def _registration_icp(source, target, max_correspondence_distance, init,
                      estimation, criteria):
    if max_correspondence_distance <= 0.0:
        console.log_error("Invalid max_correspondence_distance.")
    estimation = estimation or TransformationEstimationPointToPoint()
    criteria = criteria or ICPConvergenceCriteria()
    est_type = estimation.get_transformation_estimation_type()
    if est_type == _ET.Unspecified:
        raise ValueError("registration_icp needs an estimator type")
    if source.points.device != target.points.device:
        raise ValueError("source and target must lie on one device")
    need_tgt_normals = est_type in (_ET.PointToPlane, _ET.SymmetricMethod,
                                    _ET.ColoredICP)
    if need_tgt_normals and not target.has_normals():
        console.log_error(
            "TransformationEstimationPointToPlane and ColoredICP "
            "require pre-computed target normal vectors.")
    if est_type == _ET.SymmetricMethod and not source.has_normals():
        console.log_error("SymmetricMethod requires source normals.")
    max_dist = max_correspondence_distance
    init_T = torch.eye(4, dtype=torch.float32) if init is None \
        else torch.as_tensor(np.asarray(init, np.float32))
    src, src_mask, src_normals = _prep(source, True)
    tgt, tgt_mask, tgt_normals = _prep(target, need_tgt_normals)
    aux = _estimator_aux(est_type, estimation, source, target, max_dist,
                         src.shape[0], tgt.shape[0])
    branch, grid, plan, nd_t = "brute", None, None, 0
    src_aux, extra_params = src_normals, (0.0, 0.0)
    if len(target) > _GRID_THRESHOLD:
        src_t = transform_points(init_T.to(source.points.device),
                                 source.points)
        tgt_aux = None
        if est_type == _ET.ColoredICP:
            tgt_aux = {"intensity": aux["tgt_intensity"],
                       "gradient": aux["tgt_color_gradient"]}
            src_aux = aux["src_intensity"][:, None]
            extra_params = (aux["sqrt_lambda_geometric"],
                            aux["sqrt_lambda_photometric"])
        elif est_type == _ET.GeneralizedICP:
            tgt_aux = {"cov": aux["tgt_cov"]}
            src_aux = fused_icp.cov_upper6(aux["src_cov"])
        attrs, est_code = fused_icp.make_target_attrs(
            est_type, tgt, tgt_normals, tgt_aux)
        branch, grid, plan, nd_t = _choose_grid(
            target, tgt, tgt_mask, attrs, est_code, est_type, src_t,
            max_dist)
    rel = (criteria.relative_fitness, criteria.relative_rmse)
    with trace.span("registration.loop", branch=branch):
        if branch == "pool":
            T, idx, fit, rmse, it, nq_drop = fused_icp.icp_core_pool(
                src, src_mask, src_aux, grid, init_T, max_dist,
                plan["rebin_margin"], *rel, plan["qp"], est_type,
                criteria.max_iteration, extra_params=extra_params)
        elif branch == "run":
            T, idx, fit, rmse, it = fused_icp.icp_core_rungrid(
                src, src_mask, src_normals, grid, init_T, max_dist,
                plan["rebin_margin"], *rel, plan["qcap"], est_type,
                criteria.max_iteration)
        else:
            T, idx, fit, rmse, it = _icp_core(
                src, src_mask, src_normals, tgt, tgt_mask, tgt_normals,
                init_T, max_dist, *rel, est_type, criteria.max_iteration,
                branch, aux=aux, grid=grid,
                counts=(len(source), len(target)))
    console.log_debug("%s ICP finished after %s iterations", branch, it)
    res = _make_result(T, idx, fit, rmse, len(source))
    res.iterations = it
    if branch == "pool":
        res.n_dropped_target = nd_t
        res.n_dropped_queries = int(trace.to_host(nq_drop))
        if res.n_dropped_queries:
            console.log_warning("pool query binning dropped %d source "
                                "points", res.n_dropped_queries)
    # on the `registration.icp` span, and counted
    trace.set_attrs(branch=branch, iterations=it)
    trace.count(f"registration.branch.{branch}")
    trace.count("registration.iterations", it)
    return res


def evaluate_registration(source, target,
                          max_correspondence_distance: float,
                          transformation=None) -> RegistrationResult:
    """cupoch EvaluateRegistration: fitness, inlier rmse and the
    correspondence set of `source` under `transformation`. One
    correspondence pass: a run-grid pass (kernel 2) for targets above
    the grid threshold, brute force otherwise."""
    if source.points.device != target.points.device:
        raise ValueError("source and target must lie on one device")
    T = torch.eye(4, dtype=torch.float32) if transformation is None \
        else torch.as_tensor(np.asarray(transformation, np.float32))
    src, src_mask, _ = _prep(source, False)
    tgt, tgt_mask, _ = _prep(target, False)
    if len(target) > _GRID_THRESHOLD:
        plan = rungrid.plan_rungrid(
            target.points, max_correspondence_distance, margin=0.0,
            query_points=transform_points(T.to(src.device), source.points),
            nch=0)
        if plan is not None:
            grid = rungrid.make_rungrid(
                tgt, tgt.new_zeros((tgt.shape[0], 0)), plan["origin"],
                plan["cell_size"], plan["dims"], plan["cap"], mask=tgt_mask)
            idx, d2 = rungrid_fused.query_nn_rungrid(
                grid, transform_points(T.to(src.device), src),
                max_correspondence_distance, plan["qcap"],
                query_mask=src_mask)
            n_src = torch.tensor(max(len(source), 1), dtype=torch.float32)
            _, fit, rmse = fused_icp._final_stats(d2, idx, n_src, None)
            return _make_result(T, idx, fit, rmse, len(source))
    zeros = torch.zeros_like(src)
    T_out, idx, fit, rmse, _ = _icp_core(
        src, src_mask, zeros, tgt, tgt_mask, torch.zeros_like(tgt), T,
        max_correspondence_distance, 0.0, 0.0, _ET.PointToPoint, 0,
        counts=(len(source), len(target)))
    return _make_result(T_out, idx, fit, rmse, len(source))
