"""Grid ICP loops (cupoch RegistrationICP, registration.cu): over the
pooled grid (`icp_core_pool`, every estimator) and over the run grid
(`icp_core_rungrid`, the PT2PT/PT2PL/SYM fallback when the pool plan is
rejected).

Each iteration is one pass over the grid: on the pooled grid the slot
kernel picks correspondences and the epilogue reduces the Gauss-Newton
(or Kabsch) sums on the device; on the run grid one fused kernel does
both. Only those 32 floats come back to the host. The loop is a Python
loop: every iteration reads the sums, and the host decides whether to
re-bin (the pose has moved past the grid margin since the last
binning, bounded exactly over the source AABB corners), forms the 6x6
solve or the 3x3 Kabsch SVD in f32, composes the pose and tests
convergence. So the pose, the
re-binning bound and the solve live on the host, where their few
hundred scalar operations cost microseconds; the point clouds, the
grid and both passes stay on the device.

With a `mesh` (`parallel.collectives.Mesh`, JAX's `axis_name`), each
loop is the body one rank runs on its shard of the source: the source
box is reduced with pmin / pmax, the source count, the Gauss-Newton sums
and the final count and error with psum, so that every rank takes the
same pose, the same re-binning and the same convergence decision.
`icp_core_pool_ring` also shards the pooled grid's score table by
supertile and passes the shards round the ring.
"""
from __future__ import annotations

import numpy as np
import torch

from ..knn import poolgrid, rungrid, rungrid_fused
from ..utility import eigen as ueigen
from ..utility import trace
from ..utility.transforms import transform_points
from .estimation import TransformationEstimationType
from .kabsch import kabsch_solve

_HOST = torch.device("cpu")


def _displacement_bound(T, T_bin, corners):
    """max_x in AABB |(T - T_bin) @ [x,1]|: affine in x, so the max
    over the box is attained at a corner. corners: [8, 3]."""
    D = T - T_bin
    d = corners @ D[:3, :3].T + D[:3, 3]
    return torch.sqrt((d * d).sum(-1).max())


def _aabb_corners(src, src_mask, mesh=None):
    big = 1e30
    lo = torch.where(src_mask[:, None], src, big).min(0).values
    hi = torch.where(src_mask[:, None], src, -big).max(0).values
    if mesh is not None:
        lo, hi = mesh.pmin(lo), mesh.pmax(hi)
    return torch.stack([
        torch.stack([hi[0] if i & 1 else lo[0],
                     hi[1] if i & 2 else lo[1],
                     hi[2] if i & 4 else lo[2]])
        for i in range(8)])


def _est_code(est_type: TransformationEstimationType) -> int:
    return {
        TransformationEstimationType.PointToPoint: rungrid.EST_PT2PT,
        TransformationEstimationType.PointToPlane: rungrid.EST_PT2PL,
        TransformationEstimationType.SymmetricMethod: rungrid.EST_SYM,
        TransformationEstimationType.ColoredICP: poolgrid.EST_COLORED,
        TransformationEstimationType.GeneralizedICP: poolgrid.EST_GICP,
    }[est_type]


def cov_upper6(cov):
    """[N, 3, 3] symmetric -> [N, 6] upper triangle (c00, c01, c02,
    c11, c12, c22)."""
    return torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                        cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], -1)


def make_target_attrs(est_type, tgt_pts, tgt_normals, tgt_aux=None):
    """Per-target attribute channels for the grid build; returns
    (attrs, est_code).

    tgt_aux: ColoredICP: dict with "intensity" [M] and "gradient"
    [M, 3]; GeneralizedICP: dict with "cov" [M, 3, 3]."""
    est = _est_code(est_type)
    if est_type == TransformationEstimationType.PointToPoint:
        return tgt_pts.new_zeros((tgt_pts.shape[0], 0)), est
    if est_type == TransformationEstimationType.PointToPlane:
        d = (tgt_normals * tgt_pts).sum(-1, keepdim=True)
        return torch.cat([tgt_normals, d], -1), est
    if est_type == TransformationEstimationType.SymmetricMethod:
        return tgt_normals, est
    if est_type == TransformationEstimationType.ColoredICP:
        return torch.cat([tgt_normals, tgt_aux["intensity"][:, None],
                          tgt_aux["gradient"]], -1), est
    if est_type == TransformationEstimationType.GeneralizedICP:
        return cov_upper6(tgt_aux["cov"]), est
    raise ValueError(f"unsupported estimator {est_type}")


def kabsch_from_sums(sums) -> torch.Tensor:
    """Weighted Kabsch update from the reduced statistics (slot layout:
    rungrid.N_SUMS): normalised and centred into `kabsch_stats` form."""
    cnt = sums[0].clamp(min=1e-12)
    t_mean = sums[1:4] / cnt
    p_mean = sums[4:7] / cnt
    H = sums[7:16].reshape(3, 3) / cnt - torch.outer(t_mean, p_mean)
    return kabsch_solve(torch.cat([cnt.reshape(1), t_mean, p_mean,
                                   H.reshape(-1), sums[0:1]]))


def gn_from_sums(sums) -> torch.Tensor:
    """6-DoF GN update from the JTJ/JTr sums."""
    iu = torch.triu_indices(6, 6, device=sums.device)
    JTJ = sums.new_zeros((6, 6))
    JTJ[iu[0], iu[1]] = sums[:21]
    JTJ = JTJ + torch.triu(JTJ, 1).T
    ok, T = ueigen.solve_jacobian_system(JTJ, sums[21:27])
    return T


def _update_from_sums(est_type, sums):
    if est_type == TransformationEstimationType.PointToPoint:
        return kabsch_from_sums(sums)
    return gn_from_sums(sums)


def _n_source(src_mask, mesh):
    """Source points over every rank (at least 1), on the host."""
    n = src_mask.sum().to(torch.float32)
    if mesh is not None:
        n = mesh.psum(n)
    return trace.to_host(n.clamp(min=1.0))


def _psum(x, mesh):
    return x if mesh is None else mesh.psum(x)


def _final_stats(d2, qidx, n_src, mesh):
    """(ok mask, fitness, rmse) of a correspondence pass over every
    rank."""
    ok = torch.isfinite(d2) & (qidx >= 0)
    cnt = _psum(ok.sum().to(torch.float32), mesh)
    err = _psum(torch.where(ok, d2, 0.0).sum(), mesh)
    fit = cnt / n_src.to(cnt.device)
    rmse = torch.where(cnt > 0, torch.sqrt(err / cnt.clamp(min=1.0)), 0.0)
    return ok, fit, rmse


def _stats_from_sums(est_type, sums, n_src):
    if est_type == TransformationEstimationType.PointToPoint:
        cnt, err = sums[0], sums[16]
    else:
        cnt, err = sums[27], sums[28]
    fit = cnt / n_src
    rmse = torch.sqrt(err / cnt.clamp(min=1.0))
    rmse = torch.where(cnt > 0, rmse, 0.0)
    return fit, rmse


def icp_core_pool(src, src_mask, src_aux, grid: poolgrid.PoolGrid,
                  init_T, max_dist, rebin_margin, relative_fitness,
                  relative_rmse, qp: int,
                  est_type: TransformationEstimationType,
                  max_iteration: int, extra_params=(0.0, 0.0), mesh=None):
    """Pooled-grid ICP loop on the device of `src` and `grid`.

    src [Np, 3] padded source points, src_mask [Np], src_aux [Np, E]
    estimator extras pooled with the queries (SYM: source normals;
    Colored: source intensity; GICP: the source covariance's upper
    triangle), extra_params Colored ICP's (sqrt lambda_geometric, sqrt
    lambda_photometric). Returns (T [4, 4] f32 on the host, idx [Np]
    int32 on the device (-1 none), fitness, rmse (0-d tensors on the
    device), iterations run, n_dropped_queries (0-d tensor, the max
    over every binning)). With `mesh`, src is this rank's shard and the
    grid is replicated; idx is local and n_dropped_queries summed over
    the ranks."""
    est = _est_code(est_type)

    def query(qpool, params, corres):
        return poolgrid.fused_pool_query(grid, qpool, params, est, corres)

    return _pool_loop(src, src_mask, src_aux, grid, init_T, max_dist,
                      rebin_margin, relative_fitness, relative_rmse, qp,
                      est_type, max_iteration, extra_params, mesh, 1, query)


def _pool_loop(src, src_mask, src_aux, grid, init_T, max_dist,
               rebin_margin, relative_fitness, relative_rmse, qp: int,
               est_type, max_iteration: int, extra_params, mesh,
               shards: int, query):
    """The pooled-grid loop of `icp_core_pool` and `icp_core_pool_ring`:
    `query(qpool, params, corres)` is one pass over the grid (the [N_SUMS]
    GN sums, or (d2, idx) [G, QP] when `corres`), `shards` the blocks of
    supertiles the grid's table is split into."""
    Np = src.shape[0]
    est = _est_code(est_type)
    n_src = _n_source(src_mask, mesh)
    n_extra = poolgrid.n_query_extra(est)
    corners = trace.to_host(_aabb_corners(src, src_mask, mesh))
    r2 = torch.tensor(max_dist, dtype=torch.float32) ** 2
    margin = float(np.float32(rebin_margin))
    rel_fit = torch.tensor(relative_fitness, dtype=torch.float32)
    rel_rmse = torch.tensor(relative_rmse, dtype=torch.float32)

    def rebin(T):
        return poolgrid.bin_queries_pool(
            src, T, grid.origin, grid.cell_size, grid.dims, qp, grid.tile,
            extra=src_aux, n_extra=n_extra, mask=src_mask, shards=shards,
            cell_map=grid.cell_map,
            n_rank_pad=grid.n_tiles * shards * grid.tile)

    T = torch.as_tensor(init_T, dtype=torch.float32).to(_HOST)
    T_bin = T
    qpool, qidx, nq = rebin(T)
    fit = rmse = torch.tensor(-1.0)
    it = 0
    while it < max_iteration:
        if _displacement_bound(T, T_bin, corners) > margin:
            qpool, qidx, nq2 = rebin(T)
            T_bin = T
            nq = torch.maximum(nq, nq2)
        params = poolgrid.make_params(T, r2, grid, *extra_params)
        sums = trace.to_host(_psum(query(qpool, params, False), mesh))
        fit2, rmse2 = _stats_from_sums(est_type, sums, n_src)
        converged = bool(((fit - fit2).abs() < rel_fit)
                         & ((rmse - rmse2).abs() < rel_rmse)) and it > 0
        it += 1
        if converged:
            break
        T = _update_from_sums(est_type, sums) @ T
        fit, rmse = fit2, rmse2

    # final evaluation at the returned transform, in exact mode
    if _displacement_bound(T, T_bin, corners) > margin:
        qpool, qidx, nqf = rebin(T)
        nq = torch.maximum(nq, nqf)
    params = poolgrid.make_params(T, r2, grid)
    d2, idxf = query(qpool, params, True)
    ok, fit, rmse = _final_stats(d2, qidx, n_src, mesh)

    idx_bin = torch.where(ok, idxf, rungrid.INVALID_INDEX)
    idx_src = rungrid.scatter_to_source(qidx, idx_bin, Np,
                                        rungrid.INVALID_INDEX)
    return T, idx_src, fit, rmse, it, _psum(nq, mesh)


def icp_core_rungrid(src, src_mask, src_normals, grid: rungrid.RunGrid,
                     init_T, max_dist, rebin_margin, relative_fitness,
                     relative_rmse, qcap: int,
                     est_type: TransformationEstimationType,
                     max_iteration: int, mesh=None):
    """Run-grid ICP loop on the device of `src` and `grid`: each
    iteration is one fused GN pass (kernel 2), then one final
    correspondence pass at the returned pose.

    src [Np, 3] padded source points, src_mask [Np], src_normals
    [Np, 3] (SymmetricMethod only). Returns (T [4, 4] f32 on the host,
    idx [Np] int32 on the device (-1 none), fitness, rmse (0-d tensors
    on the device), iterations run). With `mesh`, src is this rank's
    shard, the grid is replicated and idx is local."""
    Np = src.shape[0]
    est = _est_code(est_type)
    n_src = _n_source(src_mask, mesh)
    sym = est_type == TransformationEstimationType.SymmetricMethod
    corners = trace.to_host(_aabb_corners(src, src_mask, mesh))
    r2 = torch.tensor(max_dist, dtype=torch.float32) ** 2
    margin = float(np.float32(rebin_margin))
    rel_fit = torch.tensor(relative_fitness, dtype=torch.float32)
    rel_rmse = torch.tensor(relative_rmse, dtype=torch.float32)

    def rebin(T):
        pos = transform_points(T.to(src.device), src)
        return rungrid.bin_queries(
            src, pos, grid.origin, grid.cell_size, grid.dims, qcap,
            extra=src_normals if sym else None, n_extra=3 if sym else 0,
            mask=src_mask)

    T = torch.as_tensor(init_T, dtype=torch.float32).to(_HOST)
    T_bin = T
    qsoa, qidx = rebin(T)
    fit = rmse = torch.tensor(-1.0)
    it = 0
    while it < max_iteration:
        if _displacement_bound(T, T_bin, corners) > margin:
            qsoa, qidx = rebin(T)
            T_bin = T
        params = rungrid.make_params(T, r2, grid)
        sums = trace.to_host(_psum(rungrid_fused.fused_query(
            grid, qsoa, qidx, params, est, False), mesh))
        fit2, rmse2 = _stats_from_sums(est_type, sums, n_src)
        converged = bool(((fit - fit2).abs() < rel_fit)
                         & ((rmse - rmse2).abs() < rel_rmse)) and it > 0
        it += 1
        if converged:
            break
        T = _update_from_sums(est_type, sums) @ T
        fit, rmse = fit2, rmse2

    # final evaluation at the returned transform
    if _displacement_bound(T, T_bin, corners) > margin:
        qsoa, qidx = rebin(T)
    params = rungrid.make_params(T, r2, grid)
    d2, nidx = rungrid_fused.fused_query(grid, qsoa, qidx, params,
                                         rungrid.EST_NONE, True)
    ok, fit, rmse = _final_stats(d2, qidx, n_src, mesh)
    idx_bin = torch.where(ok, -nidx, float(rungrid.INVALID_INDEX)) \
        .to(torch.int32)
    idx_src = rungrid.scatter_to_source(qidx, idx_bin, Np,
                                        rungrid.INVALID_INDEX)
    return T, idx_src, fit, rmse, it


def icp_core_pool_ring(src, src_mask, src_aux, grid: poolgrid.PoolGrid,
                       init_T, max_dist, rebin_margin, relative_fitness,
                       relative_rmse, qp: int,
                       est_type: TransformationEstimationType,
                       max_iteration: int, mesh, extra_params=(0.0, 0.0)):
    """Pooled-grid ICP with the score table sharded by supertile over the
    mesh's D ranks (JAX `icp_core_pool_ring`), so that a target map is
    bounded by the memory of all the cards, not of one.

    src [Nd, 3] / src_mask / src_aux: this rank's source shard; grid:
    `table` holds this rank's n_tiles supertiles of the D * n_tiles
    (rank r holds global supertiles r * n_tiles ...), `binfields` and
    the cell map are global. Queries stay where they were loaded: each
    pass runs D rounds, each scoring the query block of the shard this
    rank holds (kernel 1 on the shard) and then passing the shard one
    step round the ring. The rounds of a pass
    rotate D - 1 times: the next pass starts from the shard this one
    ended with (JAX rotates D times, back to the start), so each pass
    sums its D blocks in another order. The GN sums, and the final
    count and error, are psum'd as in the replicated loop.

    Returns (T [4, 4] on the host, idx [Nd] int32 local, fitness, rmse,
    iterations, n_dropped_queries (summed over the ranks))."""
    D = mesh.size
    est = _est_code(est_type)
    Gd = grid.n_tiles
    held = {"table": grid.table, "sid": mesh.rank}

    def ring_pass(qpool, params, corres):
        qb = qpool.reshape(D, Gd, *qpool.shape[1:])
        out = [None] * D
        for r in range(D):
            sid = held["sid"]
            shard = poolgrid.PoolGrid(
                held["table"], grid.binfields, grid.origin, grid.cell_size,
                grid.off, grid.dims, grid.cap, grid.kc, grid.est, grid.tile,
                cell_map=grid.cell_map)
            out[sid] = poolgrid.fused_pool_query(shard, qb[sid], params, est,
                                                 corres)
            if r < D - 1:
                held["table"] = mesh.ppermute(held["table"])
                held["sid"] = (sid - 1) % D
        if corres:
            return (torch.cat([b[0] for b in out]),
                    torch.cat([b[1] for b in out]))
        return torch.stack(out).sum(0)

    return _pool_loop(src, src_mask, src_aux, grid, init_T, max_dist,
                      rebin_margin, relative_fitness, relative_rmse, qp,
                      est_type, max_iteration, extra_params, mesh, D,
                      ring_pass)
