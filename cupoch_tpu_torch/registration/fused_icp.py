"""The ICP loop (cupoch RegistrationICP, registration.cu): one
iteration, `icp_loop`, under every loop of the port, and its grid
backends: the pooled grid (`icp_core_pool`, every estimator) and the run
grid (`icp_core_rungrid`, the PT2PT/PT2PL/SYM fallback when the pool
plan is rejected). The generic backend, correspondence and normal
system over brute force or a k-NN grid, is `registration._icp_core`.

Each iteration is one pass: on the pooled grid the slot kernel picks
correspondences and the epilogue reduces the Gauss-Newton (or Kabsch)
sums on the device; on the run grid one fused kernel does both. Only
those 32 floats come back to the host. The loop is a Python loop: every
iteration reads the sums, and the host decides whether to re-bin (the
pose has moved past the grid margin since the last binning, bounded
exactly over the source AABB corners), forms the 6x6 solve or the 3x3
Kabsch SVD in f32, composes the pose and tests convergence. So the
pose, the re-binning bound and the solve live on the host, where their
few hundred scalar operations cost microseconds; the point clouds, the
grid and both passes stay on the device.

With a `mesh` (`parallel.collectives.Mesh`, JAX's `axis_name`), each
grid loop is the body one rank runs on its shard of the source: the
source box is reduced with pmin / pmax, the source count, the
Gauss-Newton sums and the final count and error with psum, so that
every rank takes the same pose, the same re-binning and the same
convergence decision. `icp_core_pool_ring` also shards the pooled
grid's score table by supertile and passes the shards round the ring.
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


def fit_rmse(cnt, err, n_src):
    """Fitness and inlier RMSE of a pass from its inlier count `cnt` and
    squared error `err` (0-d f32 tensors on any device), over the host
    tensor `n_src` source points."""
    fit = cnt / n_src.to(cnt.device)
    rmse = torch.where(cnt > 0, torch.sqrt(err / cnt.clamp(min=1.0)), 0.0)
    return fit, rmse


def _final_stats(d2, qidx, n_src, mesh):
    """(ok mask, fitness, rmse) of a correspondence pass over every
    rank."""
    ok = torch.isfinite(d2) & (qidx >= 0)
    cnt = _psum(ok.sum().to(torch.float32), mesh)
    err = _psum(torch.where(ok, d2, 0.0).sum(), mesh)
    return (ok, *fit_rmse(cnt, err, n_src))


def icp_loop(step, at, update, final, n_src, init_T, relative_fitness,
             relative_rmse, max_iteration: int):
    """The ICP iteration of every loop (`registration._icp_core`,
    `icp_core_pool`, `icp_core_pool_ring`, `icp_core_rungrid`): up to
    `max_iteration` passes, each `step(T)`, the pass at pose T and its
    one read of sums to the host; fitness and RMSE from the count and
    squared error at indices `at` of the sums; the relative test against
    the previous pass, which ends the loop at that pass's pose; else the
    update `update(sums)` composed onto the pose on the host.
    `final(T, stats)` evaluates the returned pose T, with `stats` the
    (fitness, rmse) of the pass that converged there, or None when the
    passes ran out. Returns (T [4, 4] f32 on the host, final's result,
    passes run, whether a pass converged)."""
    rel_fit = torch.tensor(relative_fitness, dtype=torch.float32)
    rel_rmse = torch.tensor(relative_rmse, dtype=torch.float32)
    T = torch.as_tensor(init_T, dtype=torch.float32).to(_HOST)
    fit = rmse = stats = None
    it = 0
    while it < max_iteration:
        sums = step(T)
        fit2, rmse2 = fit_rmse(sums[at[0]], sums[at[1]], n_src)
        it += 1
        if fit is not None and bool(((fit - fit2).abs() < rel_fit)
                                    & ((rmse - rmse2).abs() < rel_rmse)):
            stats = fit2, rmse2
            break
        T = update(sums) @ T
        fit, rmse = fit2, rmse2
    return T, final(T, stats), it, stats is not None


def _binning(rebin, src, src_mask, rebin_margin, mesh=None):
    """`rebin(T)`'s binning of the source for pose T, made again only
    when T has moved a source point more than `rebin_margin` since the
    last binning: |(T - T_bin) @ [x, 1]| is affine in x, so its maximum
    over the source box (over every rank, read to the host here) is at
    a corner."""
    big = 1e30
    lo = torch.where(src_mask[:, None], src, big).min(0).values
    hi = torch.where(src_mask[:, None], src, -big).max(0).values
    if mesh is not None:
        lo, hi = mesh.pmin(lo), mesh.pmax(hi)
    corners = trace.to_host(torch.stack([
        torch.stack([hi[0] if i & 1 else lo[0], hi[1] if i & 2 else lo[1],
                     hi[2] if i & 4 else lo[2]]) for i in range(8)]))
    margin = float(np.float32(rebin_margin))
    last = {}

    def moved(T):
        D = T - last["T"]
        d = corners @ D[:3, :3].T + D[:3, 3]
        return torch.sqrt((d * d).sum(-1).max()) > margin

    def binned(T):
        if not last or moved(T):
            last["T"], last["bins"] = T, rebin(T)
        return last["bins"]

    return binned


def _grid_loop(grid_pass, est_type, n_src, mesh, Np, init_T,
               relative_fitness, relative_rmse, max_iteration):
    """`icp_loop` over a grid backend's `grid_pass(T, corres)`, the pass
    at pose T: its [N_SUMS] sums, psum'd and read here, with the count
    and error where the estimator's slot layout holds them and the
    Kabsch or GN update; with `corres`, the exact final pass (d2, target
    index, qidx) a binned query. Returns (T, idx [Np] int32 a source
    point (-1 none), fitness, rmse, passes run)."""

    def final(T, _):
        d2, idx_bin, qidx = grid_pass(T, True)
        ok, fit, rmse = _final_stats(d2, qidx, n_src, mesh)
        idx_bin = torch.where(ok, idx_bin, rungrid.INVALID_INDEX)
        return (rungrid.scatter_to_source(qidx, idx_bin, Np,
                                          rungrid.INVALID_INDEX), fit, rmse)

    at = (0, 16) if est_type == TransformationEstimationType.PointToPoint \
        else (27, 28)
    T, out, it, _ = icp_loop(
        lambda T: trace.to_host(_psum(grid_pass(T, False), mesh)), at,
        lambda sums: _update_from_sums(est_type, sums), final, n_src,
        init_T, relative_fitness, relative_rmse, max_iteration)
    return (T, *out, it)


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
    """The pooled-grid backend of `icp_core_pool` and `icp_core_pool_ring`:
    `query(qpool, params, corres)` is one pass over the grid (the [N_SUMS]
    GN sums, or (d2, idx) [G, QP] when `corres`), `shards` the blocks of
    supertiles the grid's table is split into."""
    n_src = _n_source(src_mask, mesh)
    n_extra = poolgrid.n_query_extra(_est_code(est_type))
    r2 = torch.tensor(max_dist, dtype=torch.float32) ** 2
    dropped = None   # the most queries a binning dropped

    def rebin(T):
        nonlocal dropped
        qpool, qidx, nq = poolgrid.bin_queries_pool(
            src, T, grid.origin, grid.cell_size, grid.dims, qp, grid.tile,
            extra=src_aux, n_extra=n_extra, mask=src_mask, shards=shards,
            cell_map=grid.cell_map,
            n_rank_pad=grid.n_tiles * shards * grid.tile)
        dropped = nq if dropped is None else torch.maximum(dropped, nq)
        return qpool, qidx

    binned = _binning(rebin, src, src_mask, rebin_margin, mesh)

    def grid_pass(T, corres):
        qpool, qidx = binned(T)
        if corres:   # at the returned pose, in exact mode
            params = poolgrid.make_params(T, r2, grid)
            return (*query(qpool, params, True), qidx)
        params = poolgrid.make_params(T, r2, grid, *extra_params)
        return query(qpool, params, False)

    out = _grid_loop(grid_pass, est_type, n_src, mesh, src.shape[0], init_T,
                     relative_fitness, relative_rmse, max_iteration)
    return (*out, _psum(dropped, mesh))


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
    est = _est_code(est_type)
    n_src = _n_source(src_mask, mesh)
    sym = est_type == TransformationEstimationType.SymmetricMethod
    r2 = torch.tensor(max_dist, dtype=torch.float32) ** 2

    def rebin(T):
        pos = transform_points(T.to(src.device), src)
        return rungrid.bin_queries(
            src, pos, grid.origin, grid.cell_size, grid.dims, qcap,
            extra=src_normals if sym else None, n_extra=3 if sym else 0,
            mask=src_mask)

    binned = _binning(rebin, src, src_mask, rebin_margin, mesh)

    def grid_pass(T, corres):
        qsoa, qidx = binned(T)
        params = rungrid.make_params(T, r2, grid)
        if corres:   # at the returned pose: (d2, -index) a slot
            d2, nidx = rungrid_fused.fused_query(
                grid, qsoa, qidx, params, rungrid.EST_NONE, True)
            return d2, (-nidx).to(torch.int32), qidx
        return rungrid_fused.fused_query(grid, qsoa, qidx, params, est,
                                         False)

    return _grid_loop(grid_pass, est_type, n_src, mesh, src.shape[0],
                      init_T, relative_fitness, relative_rmse,
                      max_iteration)


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
