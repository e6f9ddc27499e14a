"""ICP registration entry points (cupoch RegistrationICP and
EvaluateRegistration, registration.cu).

`registration_icp` takes, for every estimator, the branch the JAX
package takes:
- targets of at most `_GRID_THRESHOLD` points: brute-force 1-NN in the
  generic loop (`_icp_core`);
- larger targets: the pooled grid when its plan is accepted (all five
  estimators); for PT2PT, PT2PL and SYM the run grid when only that
  plan is accepted;
- else the generic loop over the dense roll grid, the active-cell grid
  (both reduced by kernel 4), brute force up to `_BRUTE_FALLBACK_MAX`
  target points, or the hash grid (`_choose_corres`).
Colored ICP and GICP precompute their estimator inputs first: the
target's colour gradient, or both clouds' covariances.
`evaluate_registration` makes one correspondence pass: over the run
grid above the threshold when its plan is accepted, else brute force.
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

_HOST = torch.device("cpu")
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
# the generic loop's `use_grid` as a branch of `registration_icp`
_BRANCHES = {False: "brute", True: "hash"}


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


def _host_float(x) -> float:
    """A number, or a 0-d tensor read from its device."""
    return float(trace.to_host(x)) if torch.is_tensor(x) else float(x)


def _make_result(T, idx, fit, rmse, n_src):
    res = RegistrationResult(trace.to_host(T).numpy())
    res.fitness = _host_float(fit)
    res.inlier_rmse = _host_float(rmse)
    idx = trace.to_host(idx[:n_src]).numpy()
    src_i = np.nonzero(idx >= 0)[0]
    res.correspondence_set = np.stack(
        [src_i, idx[src_i]], -1).astype(np.int32)
    return res


def _correspondence_fn(tgt, tgt_mask, max_dist, use_grid, grid, counts):
    """1-NN within max_dist for transformed source points: (idx, d2),
    -1 / inf where none. `use_grid`: "roll" or "cell" (over `grid`),
    True (a hash grid built here) or False (brute force, over the
    prefixes `counts` = (source, target points) of the padded clouds)."""
    if use_grid == "roll":
        return lambda src_t: rollgrid.query_nn_rollgrid(grid, src_t,
                                                        max_dist)
    if use_grid == "cell":
        return lambda src_t: cellgrid.query_nn_cellgrid(grid, src_t,
                                                        max_dist)
    if use_grid:
        with trace.span("registration.build", branch="hash"):
            hgrid = gridhash.build_grid(tgt, max_dist, mask=tgt_mask)
        return lambda src_t: gridhash.query_nn(hgrid, src_t, max_dist)
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
    """The generic ICP loop on the device of the clouds: correspondence
    (`_correspondence_fn`), the estimator's normal system, a host solve
    and the pose composition, then the convergence test. Each iteration
    reads the system and the fitness statistics in one device-to-host
    copy. `aux` carries Colored ICP's intensities, target gradient and
    square-rooted weights, or GICP's padded covariances. `counts`: the
    clouds' point counts (source, target), the prefixes their masks keep;
    brute force scores no padding.
    Returns (T [4, 4] f32 on the host, idx [Np] int32 on the device,
    fitness, rmse (host 0-d tensors), iterations run)."""
    dev = src.device
    corres_fn = _correspondence_fn(tgt, tgt_mask, max_dist, use_grid, grid,
                                   counts)
    M = tgt.shape[0]
    rel_fit = torch.tensor(relative_fitness, dtype=torch.float32)
    rel_rmse = torch.tensor(relative_rmse, dtype=torch.float32)

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

    with trace.span("registration.loop",
                    branch=_BRANCHES.get(use_grid, use_grid)):
        n_src = trace.to_host(
            src_mask.sum().to(torch.float32).clamp(min=1.0))
        T = torch.as_tensor(init_T, dtype=torch.float32).to(_HOST)
        src_t, idx, ok, head = eval_state(T)
        fit = rmse = None
        it = 0
        while True:
            more = it < max_iteration
            parts = [head, system(T, src_t, idx, ok)] if more else [head]
            host = trace.to_host(torch.cat(parts))  # the iteration's read
            cnt, err = host[0], host[1]
            fit2 = cnt / n_src
            rmse2 = torch.where(cnt > 0,
                                torch.sqrt(err / cnt.clamp(min=1.0)), 0.0)
            if fit is not None and bool(((fit - fit2).abs() < rel_fit)
                                        & ((rmse - rmse2).abs() < rel_rmse)):
                fit, rmse = fit2, rmse2
                break
            fit, rmse = fit2, rmse2
            if not more:
                break
            T = solve_normal_system(est_type, host[2:]) @ T
            it += 1
            src_t, idx, ok, head = eval_state(T)
    return T, idx, fit, rmse, it


def _choose_corres(target, tgt_padded, tgt_mask, max_dist):
    """The generic loop's correspondence backend for `target`: brute
    force for small targets, the dense roll grid for compact volumes,
    the active-cell grid for sparse (surface) clouds, brute force up to
    `_BRUTE_FALLBACK_MAX` points when both plans reject the target, the
    hash grid beyond. Returns (use_grid, grid)."""
    n = len(target)
    if n <= _GRID_THRESHOLD:
        return False, None
    plan = rollgrid.plan_rollgrid(target.points, max_dist)
    if plan is not None:
        with trace.span("registration.build", branch="roll"):
            return "roll", rollgrid.build_rollgrid(
                tgt_padded, plan["origin"], plan["cell_size"], plan["dims"],
                plan["cap"], mask=tgt_mask)
    cplan = cellgrid.plan_cellgrid(target.points, max_dist)
    if cplan is not None:
        with trace.span("registration.build", branch="cell"):
            return "cell", cellgrid.build_cellgrid(
                tgt_padded, cplan["origin"], cplan["cell_size"],
                cplan["active"], cplan["dims"], cplan["cap"],
                cplan["n_active"], mask=tgt_mask)
    if n <= _BRUTE_FALLBACK_MAX:
        return False, None
    return True, None


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


def _traced_result(res: RegistrationResult, branch: str):
    """`res`, with the branch taken and the iterations run set on the
    `registration.icp` span and counted."""
    trace.set_attrs(branch=branch, iterations=res.iterations)
    trace.count(f"registration.branch.{branch}")
    trace.count("registration.iterations", res.iterations)
    return res


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
    n_tgt = len(target)
    init_T = torch.eye(4, dtype=torch.float32) if init is None \
        else torch.as_tensor(np.asarray(init, np.float32))
    src, src_mask, src_normals = _prep(source, True)
    tgt, tgt_mask, tgt_normals = _prep(target, need_tgt_normals)
    aux = _estimator_aux(est_type, estimation, source, target, max_dist,
                         src.shape[0], tgt.shape[0])

    def generic(use_grid, grid):
        T, idx, fit, rmse, it = _icp_core(
            src, src_mask, src_normals, tgt, tgt_mask, tgt_normals, init_T,
            max_dist, criteria.relative_fitness, criteria.relative_rmse,
            est_type, criteria.max_iteration, use_grid, aux=aux, grid=grid,
            counts=(len(source), n_tgt))
        console.log_debug("ICP finished after %s iterations", it)
        res = _make_result(T, idx, fit, rmse, len(source))
        res.iterations = it
        return _traced_result(res, _BRANCHES.get(use_grid, use_grid))

    if n_tgt <= _GRID_THRESHOLD:
        return generic(False, None)

    # the plans' queries: the source at the initial pose, on the device
    src_t = transform_points(init_T.to(source.points.device), source.points)
    tgt_aux, src_aux, extra_params = None, src_normals, (0.0, 0.0)
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
    pplan = poolgrid.plan_poolgrid(target.points, max_dist,
                                   query_points=src_t, est=est_code)
    if pplan is not None:
        return _registration_icp_pool(
            source, target, src, src_mask, src_aux, tgt, tgt_mask, attrs,
            est_code, src_t, pplan, init_T, max_dist, est_type, criteria,
            extra_params)
    if est_type in _RUN_GRID_ESTIMATORS:
        plan = rungrid.plan_rungrid(target.points, max_dist,
                                    query_points=src_t, nch=attrs.shape[1])
        if plan is not None:
            return _registration_icp_rungrid(
                source, src, src_mask, src_normals, tgt, tgt_mask, attrs,
                est_code, plan, init_T, max_dist, est_type, criteria)
    return generic(*_choose_corres(target, tgt, tgt_mask, max_dist))


def _registration_icp_pool(source, target, src, src_mask, src_aux, tgt,
                           tgt_mask, attrs, est_code, src_t, pplan, init_T,
                           max_dist, est_type, criteria, extra_params):
    """The pooled-grid branch of `registration_icp`, with one regrow of
    the cell capacity when the planned cap drops too many targets."""

    def build(plan):
        with trace.span("registration.build", branch="pool"):
            return poolgrid.make_poolgrid(
                tgt, attrs, plan["origin"], plan["cell_size"], plan["dims"],
                plan["cap"], plan["kc"], est=est_code, tile=plan["tile"],
                mask=tgt_mask, active_cells=plan.get("active_cells"))

    grid = build(pplan)
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
            pplan = regrown
            grid = build(pplan)
            nd_t = int(trace.to_host(grid.n_dropped))
    with trace.span("registration.loop", branch="pool"):
        T, idx, fit, rmse, it, nq_drop = fused_icp.icp_core_pool(
            src, src_mask, src_aux, grid, init_T, max_dist,
            pplan["rebin_margin"], criteria.relative_fitness,
            criteria.relative_rmse, pplan["qp"], est_type,
            criteria.max_iteration, extra_params=extra_params)
    console.log_debug("pooled ICP finished after %s iterations", it)
    res = _make_result(T, idx, fit, rmse, len(source))
    res.n_dropped_target = nd_t
    res.n_dropped_queries = int(trace.to_host(nq_drop))
    res.iterations = it
    if res.n_dropped_queries:
        console.log_warning("pool query binning dropped %d source points",
                            res.n_dropped_queries)
    return _traced_result(res, "pool")


def _registration_icp_rungrid(source, src, src_mask, src_normals, tgt,
                              tgt_mask, attrs, est_code, plan, init_T,
                              max_dist, est_type, criteria):
    """The run-grid branch of `registration_icp` (PT2PT, PT2PL, SYM), for
    targets whose pool plan is rejected (pool cells that would need a
    cap above 128)."""
    with trace.span("registration.build", branch="run"):
        grid = rungrid.make_rungrid(
            tgt, attrs, plan["origin"], plan["cell_size"], plan["dims"],
            plan["cap"], mask=tgt_mask, est=est_code, kc=plan["kc"])
    with trace.span("registration.loop", branch="run"):
        T, idx, fit, rmse, it = fused_icp.icp_core_rungrid(
            src, src_mask, src_normals, grid, init_T, max_dist,
            plan["rebin_margin"], criteria.relative_fitness,
            criteria.relative_rmse, plan["qcap"], est_type,
            criteria.max_iteration)
    console.log_debug("run-grid ICP finished after %s iterations", it)
    res = _make_result(T, idx, fit, rmse, len(source))
    res.iterations = it
    return _traced_result(res, "run")


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
            ok = idx >= 0
            cnt, err = torch.stack([ok.sum().to(torch.float32),
                                    torch.where(ok, d2, 0.0).sum()]) \
                .to(_HOST).numpy()
            fit = float(cnt) / max(len(source), 1)
            rmse = float(np.sqrt(err / cnt)) if cnt else 0.0
            return _make_result(T, idx, fit, rmse, len(source))
    zeros = torch.zeros_like(src)
    T_out, idx, fit, rmse, _ = _icp_core(
        src, src_mask, zeros, tgt, tgt_mask, torch.zeros_like(tgt), T,
        max_correspondence_distance, 0.0, 0.0, _ET.PointToPoint, 0,
        counts=(len(source), len(target)))
    return _make_result(T_out, idx, fit, rmse, len(source))
