"""Registration over a mesh of ranks (the JAX package's
`parallel/sharded.py`), in `torch.distributed`.

Two ways to shard ICP:
* `sharded_registration_icp`: the source points are split over the
  ranks and the target's run grid is replicated. Every rank runs the
  run-grid loop (`fused_icp.icp_core_rungrid`, kernel 2) on its shard;
  the only traffic is a psum of the 32 normal-equation floats an
  iteration, plus pmin / pmax of the source box once.
* `ring_sharded_registration_icp`: the pooled grid's score table is
  split by supertile as well, and each pass sends the shards round the
  ring (`fused_icp.icp_core_pool_ring`, kernel 1), so the target map is
  bounded by the memory of all the ranks' cards.

Every rank passes the same numpy clouds and keeps its own slice of the
source (padded to a multiple of 8 * D); every rank returns the same
pose. The returned seconds cover the grid build and the loop, with the
kernels built beforehand: there is no compilation to warm up, so each
call runs once (the JAX functions run once to compile, then time a
second run).
"""
from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from ..knn import poolgrid, rungrid
from ..registration import fused_icp
from ..registration.estimation import TransformationEstimationType
from ..utility.transforms import transform_points
from .collectives import Mesh, shard_rows

POINTS_AXIS = "points"


def make_point_mesh(n_devices: Optional[int] = None, device=None,
                    group=None) -> Mesh:
    """1-D mesh over the point-sharding axis: the ranks of `group`
    (default the initialised world; none: one rank). `n_devices`, when
    given, must be the group's size."""
    mesh = Mesh(POINTS_AXIS, group=group, device=device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh of {n_devices} ranks needs a group of "
                         f"{n_devices}; this one has {mesh.size}")
    return mesh


def sharded_icp_fn(mesh: Mesh, qcap: int,
                   est_type: TransformationEstimationType,
                   max_iteration: int):
    """The sharded run-grid loop: fn(src shard, src_mask shard,
    src_normals shard, grid (replicated), init_T, max_dist, rebin_margin,
    rel_fitness, rel_rmse) -> (T, idx shard, fitness, rmse,
    iterations)."""
    return functools.partial(fused_icp.icp_core_rungrid, qcap=qcap,
                             est_type=est_type, max_iteration=max_iteration,
                             mesh=mesh)


def ring_sharded_pool_icp_fn(mesh: Mesh, qp: int,
                             est_type: TransformationEstimationType,
                             max_iteration: int):
    """The ring loop: fn(src shard, src_mask shard, src_aux shard, grid
    (its table this rank's supertiles, `shard_pool_table`), init_T,
    max_dist, rebin_margin, rel_fitness, rel_rmse) -> (T, idx shard,
    fitness, rmse, iterations, n_dropped_queries)."""
    return functools.partial(fused_icp.icp_core_pool_ring, qp=qp,
                             est_type=est_type, max_iteration=max_iteration,
                             mesh=mesh)


def sharded_transform(mesh: Mesh):
    """fn(T, points shard) -> the transformed shard, on the mesh's
    device."""

    def fn(T, points):
        return transform_points(torch.as_tensor(T, device=mesh.device),
                                torch.as_tensor(points, device=mesh.device))

    return fn


def shard_pool_table(grid: poolgrid.PoolGrid, mesh: Mesh
                     ) -> poolgrid.PoolGrid:
    """The grid with only this rank's block of supertiles left in its
    score table (the table's rows are a multiple of tile * D)."""
    rows = grid.table.shape[0] // mesh.size
    grid.table = grid.table[mesh.rank * rows:(mesh.rank + 1) * rows].clone()
    return grid


def _source_shard(src_np, mesh: Mesh):
    """(this rank's padded source rows, their mask) on the mesh's
    device."""
    n = src_np.shape[0]
    n_pad, n_local, lo = shard_rows(n, mesh)
    src_pad = np.zeros((n_pad, 3), np.float32)
    src_pad[:n] = src_np
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    dev = mesh.device
    return (torch.as_tensor(src_pad[lo:lo + n_local], device=dev),
            torch.as_tensor(mask[lo:lo + n_local], device=dev))


def _target(tgt_np, tgt_normals_np, est_type, init_T, src_np, mesh):
    tgt = torch.as_tensor(np.asarray(tgt_np, np.float32), device=mesh.device)
    tn = torch.as_tensor(np.asarray(tgt_normals_np, np.float32),
                         device=mesh.device)
    attrs, est_code = fused_icp.make_target_attrs(est_type, tgt, tn)
    init = np.eye(4, dtype=np.float32) if init_T is None else \
        np.asarray(init_T, np.float32)
    src_t = src_np @ init[:3, :3].T + init[:3, 3]
    return tgt, attrs, est_code, init, src_t


def sharded_registration_icp(
        src_np, tgt_np, tgt_normals_np, max_dist: float, mesh: Mesh,
        est_type=TransformationEstimationType.PointToPlane,
        max_iteration: int = 20, relative_fitness: float = 1e-6,
        relative_rmse: float = 1e-6, init_T=None, margin: float = 0.25):
    """Plan and build the replicated run grid of the target, take this
    rank's shard of the source, and run the run-grid loop over `mesh`.

    Returns (T [4, 4] np, fitness, rmse, iterations, seconds), seconds
    covering the grid build and the loop."""
    src_np = np.asarray(src_np, np.float32)
    src, mask = _source_shard(src_np, mesh)
    tgt, attrs, est_code, init, src_t = _target(
        tgt_np, tgt_normals_np, est_type, init_T, src_np, mesh)
    plan = rungrid.plan_rungrid(tgt, max_dist, margin=margin,
                                query_points=src_t,
                                nch=int(attrs.shape[1]))
    if plan is None:
        raise ValueError("cloud unsuitable for a dense run grid")
    fn = sharded_icp_fn(mesh, plan["qcap"], est_type, max_iteration)
    _sync(mesh)
    t0 = time.perf_counter()
    grid = rungrid.make_rungrid(
        tgt, attrs, plan["origin"], plan["cell_size"], plan["dims"],
        plan["cap"], est=est_code, kc=plan["kc"])
    T, _, fit, rmse, it = fn(src, mask, torch.zeros_like(src), grid, init,
                             max_dist, plan["rebin_margin"],
                             relative_fitness, relative_rmse)
    fit, rmse = float(fit), float(rmse)
    dt = time.perf_counter() - t0
    return T.numpy(), fit, rmse, int(it), dt


def ring_sharded_registration_icp(
        src_np, tgt_np, tgt_normals_np, max_dist: float, mesh: Mesh,
        est_type=TransformationEstimationType.PointToPlane,
        max_iteration: int = 20, relative_fitness: float = 1e-6,
        relative_rmse: float = 1e-6, init_T=None, margin: float = 0.375):
    """Cell-sharded counterpart of `sharded_registration_icp`: plan the
    pooled grid with its cells padded to a multiple of tile * D, keep
    this rank's block of the score table, and run the ring loop.

    Returns (T [4, 4] np, fitness, rmse, iterations, seconds)."""
    src_np = np.asarray(src_np, np.float32)
    src, mask = _source_shard(src_np, mesh)
    tgt, attrs, est_code, init, src_t = _target(
        tgt_np, tgt_normals_np, est_type, init_T, src_np, mesh)
    D = mesh.size
    plan = poolgrid.plan_poolgrid(tgt, max_dist, margin=margin,
                                  query_points=src_t, est=est_code,
                                  shards=D)
    if plan is None:
        raise ValueError("cloud unsuitable for a pooled grid")
    fn = ring_sharded_pool_icp_fn(mesh, plan["qp"], est_type, max_iteration)
    aux = torch.zeros((src.shape[0], 0), device=mesh.device)
    _sync(mesh)
    t0 = time.perf_counter()
    grid = shard_pool_table(poolgrid.make_poolgrid(
        tgt, attrs, plan["origin"], plan["cell_size"], plan["dims"],
        plan["cap"], plan["kc"], est=est_code, tile=plan["tile"],
        shards=D, active_cells=plan["active_cells"]), mesh)
    T, _, fit, rmse, it, _ = fn(src, mask, aux, grid, init, max_dist,
                                plan["rebin_margin"], relative_fitness,
                                relative_rmse)
    fit, rmse = float(fit), float(rmse)
    dt = time.perf_counter() - t0
    return T.numpy(), fit, rmse, int(it), dt


def _sync(mesh: Mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
