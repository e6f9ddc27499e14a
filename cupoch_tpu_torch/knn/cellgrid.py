"""Active-cell compacted grid nearest-neighbour search (counterpart of
the JAX package's `knn/cellgrid.py`): the sparse-cloud form of the roll
grid.

Surface scans occupy a small share of their bounding grid, so only the
active cells (occupied cells dilated by one ring, so every query with a
non-empty neighbourhood has a slot) get storage:
- an int32 LUT [C + 2] maps a linear cell id to its active slot (-1
  elsewhere; ids C and C + 1, for rows outside the grid or masked, map
  to -1 too);
- points are binned into [A, cap] by slot;
- each active slot's 27-neighbourhood is gathered once at build into
  [A, 3, KC] (SoA) with its indices [A, KC];
- queries map to slots through the LUT and go through the same reduce
  as the roll grid (`rollgrid_nn.nn_reduce`, kernel 4 on the card).

The JAX package fills the LUT with one scatter of `arange(A)` over the
active list, whose padding entries all equal C: `lut[C]` there becomes
one of the padding slots. Rows with key C (masked targets, out-of-grid
queries) land in that slot, and so does every out-of-grid neighbour of
a cell on the grid's boundary: the masked rows that pad a target to its
bucket size become candidates of those cells, and a query just outside
the cloud can match one. The port keeps `lut[C] = -1`, so masked rows
and out-of-grid neighbours hold nothing; elsewhere the two agree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utility import trace
from ..utility.device import resolve_device
from . import plan_stats
from .rollgrid import (CAND_FILL, INVALID_INDEX, LANE_BYTES, OFFSETS,
                       LaneRanked, _bin_by_key, _bin_query_soa, _cell_keys,
                       _round_up, reduce_and_scatter)


class CellGrid(LaneRanked):
    """The built grid: cand [A, 3, KC] f32 (3e18 empty), cand_idx
    [A, KC] int32 (-1 empty), cand_rank [A, KC] int16 (`LaneRanked`),
    lut [C + 2] int32 (cell -> slot, -1 none), origin [3] and cell_size
    [] f32 tensors, dims, cap and n_active ints."""

    def __init__(self, cand, cand_idx, lut, origin, cell_size,
                 dims: Tuple[int, int, int], cap: int, n_active: int):
        self.cand = cand
        self.cand_idx = cand_idx
        self._keep_rank(cand_idx)
        self.lut = lut
        self.origin = origin
        self.cell_size = cell_size
        self.dims = tuple(int(d) for d in dims)
        self.cap = int(cap)
        self.n_active = int(n_active)

    @classmethod
    def from_numpy(cls, cand, cand_idx, lut, origin, cell_size, dims, cap,
                   n_active, device=None) -> "CellGrid":
        """The port's grid from the JAX CellGrid's leaves given as numpy
        arrays. The LUT's entries for ids C and C + 1 are set to -1, as
        the port builds them (see the module note)."""
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.as_tensor(np.array(a, dtype), device=dev)

        lut = np.array(lut, np.int32)
        lut[-2:] = INVALID_INDEX
        return cls(t(cand, np.float32), t(cand_idx, np.int32), t(lut,
                   np.int32), t(origin, np.float32),
                   t(cell_size, np.float32), dims, cap, n_active)


@trace.planner("cell")
def plan_cellgrid(points, radius: float,
                  max_cells: int = 64_000_000, cap_limit: int = 128,
                  cap_percentile: float = 99.5,
                  mem_budget_bytes: int = 3 << 30) -> Optional[dict]:
    """Sizing on the device of `points` (a tensor; an array plans on the
    CPU; `plan_stats`), as the JAX package's: dims, origin, cap and the
    active list (occupied cells dilated by one ring, in linear-id
    order, padded to a multiple of 8 with the value C; int32 on that
    device). The budget counts LANE_BYTES a candidate lane where the
    JAX package counts 16 (see `rollgrid.plan_rollgrid`)."""
    pts = plan_stats.as_points(points)
    if radius <= 0:
        return None
    finite, lo_d, n_finite, lo, hi = plan_stats.bounds(pts)
    if n_finite == 0:
        return None
    cell = float(radius)
    dims_core = plan_stats.core_dims(lo, hi, cell)
    dims = tuple(int(d) + 2 for d in dims_core)
    n_cells = int(np.prod(dims))
    if n_cells > max_cells:
        return None
    origin = (lo - cell).astype(np.float32)
    # cell ids in the points' dtype from the float32 origin, as the
    # reference computes them
    origin_d = (lo_d - plan_stats.scalar(cell, lo_d)).float()
    counts = plan_stats.counts(plan_stats.cell_ids(
        plan_stats.floor_div(pts, origin_d, cell), finite, dims, clip=True),
        n_cells)
    # the occupied cells dilated by one ring within the grid, in
    # linear-id order: the reference's sorted unique of the 27
    # neighbours of every occupied cell
    act = plan_stats.dilate27((counts > 0).reshape(dims)).reshape(-1)
    n_occ, cap_a, cap_b, n_act = plan_stats.read([plan_stats.order_stats(
        plan_stats.ascending(counts), [cap_percentile]), act.sum()])
    cap = int(plan_stats.percentile(int(n_occ), cap_a, cap_b,
                                    cap_percentile)) if n_occ else 8
    if cap > cap_limit:
        return None
    cap = max(8, _round_up(cap, 8))
    n_active = _round_up(max(8, int(n_act)), 8)
    kc = _round_up(27 * cap, 128)
    if n_active * kc * LANE_BYTES + n_cells * 4 > mem_budget_bytes:
        return None
    return {"dims": dims, "origin": origin, "cap": cap,
            "cell_size": np.float32(cell),
            "active": plan_stats.set_ids(act, act.cumsum(0) - 1, n_active,
                                         n_cells),
            "n_active": n_active}


def build_cellgrid(points, origin, cell_size, active,
                   dims: Tuple[int, int, int], cap: int, n_active: int,
                   mask=None) -> CellGrid:
    """Bin the target by active slot and gather each slot's
    27-neighbourhood once, on `points.device`."""
    dev = points.device
    origin = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    cell_size = torch.as_tensor(np.float32(cell_size), device=dev)
    dims = tuple(int(d) for d in dims)
    C = dims[0] * dims[1] * dims[2]
    A = int(n_active)
    active = torch.as_tensor(active if torch.is_tensor(active)
                             else np.asarray(active), dtype=torch.int64,
                             device=dev)
    real = active < C
    lut = torch.full((C + 2,), INVALID_INDEX, dtype=torch.int32, device=dev)
    lut[active[real]] = torch.arange(A, dtype=torch.int32,
                                     device=dev)[real]
    slot = lut[_cell_keys(points, origin, cell_size, dims, mask).long()]
    slot = torch.where(slot < 0, A, slot)
    soa, index = _bin_by_key(slot, points, A, cap)
    soa = torch.where(torch.isfinite(soa), soa, CAND_FILL)
    # linear ids of each active cell's 27 neighbours (C outside the grid)
    az = active % dims[2]
    ay = (active // dims[2]) % dims[1]
    ax = active // (dims[1] * dims[2])
    offs = torch.tensor(OFFSETS, dtype=torch.int64, device=dev)
    nx = ax[:, None] + offs[None, :, 0]
    ny = ay[:, None] + offs[None, :, 1]
    nz = az[:, None] + offs[None, :, 2]
    inb = ((nx >= 0) & (nx < dims[0]) & (ny >= 0) & (ny < dims[1])
           & (nz >= 0) & (nz < dims[2]))
    nbr_slot = lut[torch.where(inb, (nx * dims[1] + ny) * dims[2] + nz, C)]
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    flat = torch.where(nbr_slot[..., None] >= 0,
                       nbr_slot[..., None].long() * cap + j, A * cap)
    flat = flat.reshape(A, 27 * cap)                 # [A, 27 cap]
    KC = _round_up(27 * cap, 128)
    cand = torch.full((A, 3, KC), CAND_FILL, dtype=torch.float32,
                      device=dev)
    for k in range(3):
        src = torch.cat([soa[k].reshape(-1),
                         soa.new_full((1,), CAND_FILL)])
        cand[:, k, :27 * cap] = src[flat]
    idx_src = torch.cat([index.reshape(-1),
                         index.new_full((1,), INVALID_INDEX)])
    cand_idx = torch.full((A, KC), INVALID_INDEX, dtype=torch.int32,
                          device=dev)
    cand_idx[:, :27 * cap] = idx_src[flat]
    return CellGrid(cand, cand_idx, lut, origin, cell_size, dims, cap, A)


def bin_queries(grid: CellGrid, queries, query_mask=None, qcap: int = 0):
    """Queries binned by active slot at qcap (default: the grid's cap),
    the reduce's input: (q_soa [A, 3, qcap], q_index [A, qcap])."""
    A = grid.n_active
    slot = grid.lut[_cell_keys(queries, grid.origin, grid.cell_size,
                               grid.dims, query_mask).long()]
    slot = torch.where(slot < 0, A, slot)
    return _bin_query_soa(queries, slot, A, qcap or grid.cap)


def query_nn_cellgrid(grid: CellGrid, queries, radius, query_mask=None,
                      qcap: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN within `radius`: (index [Q] int32 or -1, dist2 [Q], inf for
    none). Queries in inactive cells, outside the grid or past a slot's
    qcap (default: the grid's cap) get -1."""
    q_soa, q_index = bin_queries(grid, queries, query_mask, qcap)
    return reduce_and_scatter(q_soa, q_index, grid, radius,
                              queries.shape[0])
