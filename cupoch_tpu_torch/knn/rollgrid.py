"""Dense roll-grid nearest-neighbour search (counterpart of the JAX
package's `knn/rollgrid.py`), in PyTorch.

Build (once per target): points are binned into a dense [C, cap] cell
array (cell edge = search radius, one empty ghost shell on every face)
and the 27-cell neighbourhood of every cell is assembled from 27
`torch.roll`s into an SoA candidate tensor [C, 3, KC] with the
original indices [C, KC] beside it (KC = 27 cap rounded up to 128).
Query (each ICP iteration): queries are binned per cell at qcap = cap
and the reduce (`rollgrid_nn.nn_reduce`, kernel 4 on the card) takes
each query's nearest candidate within r; the result is scattered back
to query order.

Empty candidate slots hold 3e18 and empty query slots 1e18: their
squared distances stay finite in f32 and far above any r^2, so the
reduce needs no validity test. Cells hold at most cap points;
overflow rows are dropped (their queries see -1), as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utility import trace
from ..utility.device import resolve_device
from . import plan_stats, rollgrid_nn
from .rungrid import _bin_to_slots, _round_up, scatter_to_source

INVALID_INDEX = -1
CAND_FILL = 3.0e18    # empty candidate slot
QUERY_FILL = 1.0e18   # empty query slot

# the 27 neighbour offsets in build order: dx outer, dz inner
OFFSETS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1))


# bytes a candidate lane of a roll or cell grid holds on the device: 3
# f32 coordinates, the int32 index and the int16 lane rank
LANE_BYTES = 18


class LaneRanked:
    """The lane rank kernel 4 stages a row in, kept beside `cand_idx`."""

    def _keep_rank(self, cand_idx):
        # a grid on the card ranks its lanes at once, where kernel 4 will
        # need them; elsewhere only on first use (the plain version never
        # reads the rank)
        self._cand_rank = rollgrid_nn.lane_rank(cand_idx) \
            if cand_idx.is_cuda else None

    @property
    def cand_rank(self):
        """[C, KC] int16 `rollgrid_nn.lane_rank(cand_idx)`."""
        if self._cand_rank is None:
            self._cand_rank = rollgrid_nn.lane_rank(self.cand_idx)
        return self._cand_rank


class RollGrid(LaneRanked):
    """The built target grid: cand [C, 3, KC] f32 (SoA neighbourhood
    coordinates, 3e18 empty), cand_idx [C, KC] int32 (original indices,
    -1 empty), cand_rank [C, KC] int16 (`LaneRanked`), origin [3] and
    cell_size [] f32 tensors (ghost shell included), dims and cap
    ints."""

    def __init__(self, cand, cand_idx, origin, cell_size,
                 dims: Tuple[int, int, int], cap: int):
        self.cand = cand
        self.cand_idx = cand_idx
        self._keep_rank(cand_idx)
        self.origin = origin
        self.cell_size = cell_size
        self.dims = tuple(int(d) for d in dims)
        self.cap = int(cap)

    @classmethod
    def from_numpy(cls, cand, cand_idx, origin, cell_size, dims, cap,
                   device=None) -> "RollGrid":
        """The port's grid from the JAX RollGrid's leaves given as numpy
        arrays (the layouts are the same)."""
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.as_tensor(np.array(a, dtype), device=dev)

        return cls(t(cand, np.float32), t(cand_idx, np.int32),
                   t(origin, np.float32), t(cell_size, np.float32), dims,
                   cap)


@trace.planner("roll")
def plan_rollgrid(points, radius: float,
                  max_cells: int = 2_000_000, cap_limit: int = 128,
                  cap_percentile: float = 99.5,
                  mem_budget_bytes: int = 3 << 30) -> Optional[dict]:
    """Sizing on the device of `points` (a tensor; an array plans on the
    CPU; `plan_stats`), as the JAX package's: dims (ghost shell
    included, each rounded up to even), origin, cap (the
    `cap_percentile` of the occupied cells' counts, rounded up to 8).
    None when a dense grid does not suit the cloud (degenerate extent,
    too many cells, a cap above `cap_limit`, or a neighbourhood tensor
    above `mem_budget_bytes`). The budget counts LANE_BYTES a lane where
    the JAX package counts 16 (it keeps no lane rank), so a grid within
    a ninth of the budget is refused here and accepted there."""
    pts = plan_stats.as_points(points)
    cell = float(radius)
    if cell <= 0:
        return None
    finite, lo_d, n_finite, lo, hi = plan_stats.bounds(pts)
    if n_finite == 0:
        return None
    dims_core = plan_stats.core_dims(lo, hi, cell)
    dims = tuple(int(d) + 2 + (int(d) % 2) for d in dims_core)
    n_cells = int(np.prod(dims))
    if n_cells > max_cells:
        return None
    counts = plan_stats.core_counts(pts, finite, lo_d, cell, dims_core)
    n_occ, cap_a, cap_b = plan_stats.read([plan_stats.order_stats(
        plan_stats.ascending(counts), [cap_percentile])])
    cap = int(plan_stats.percentile(int(n_occ), cap_a, cap_b,
                                    cap_percentile)) if n_occ else 8
    if cap > cap_limit:
        return None
    cap = max(8, _round_up(cap, 8))
    kc = _round_up(27 * cap, 128)
    if n_cells * kc * LANE_BYTES > mem_budget_bytes:
        return None
    origin = (lo - cell).astype(np.float32)
    return {"dims": dims, "origin": origin, "cap": cap,
            "cell_size": np.float32(cell)}


def _bin_by_key(keys, points, n_bins: int, cap: int):
    """Points into [n_bins, cap] bins by `keys` (int, >= n_bins drops
    the row), in their order within a bin; rows past a bin's cap are
    dropped. Returns (soa [3, n_bins, cap] f32, inf empty; index
    [n_bins, cap] int32, -1 empty)."""
    inf = float("inf")
    # int32 keys sort in half the radix passes of int64 ones; both plans
    # keep n_bins * 64 below 2^31 (at most 2M cells, 0.8M active slots)
    coords, index, _ = _bin_to_slots(keys.to(torch.int32) * 64, n_bins,
                                     cap, points.unbind(1),
                                     (inf, inf, inf))
    return torch.stack(coords), index


def _cell_keys(points, origin, cell_size, dims, mask=None):
    """Linear cell id per point; rows outside the grid or masked get C."""
    C = dims[0] * dims[1] * dims[2]
    cell = torch.floor((points - origin) / cell_size).to(torch.int32)
    dims_t = torch.tensor(dims, dtype=torch.int32, device=points.device)
    inb = ((cell >= 0) & (cell < dims_t)).all(-1)
    if mask is not None:
        inb = inb & mask
    lin = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    return torch.where(inb, lin, C)


def _bin_points(points, origin, cell_size, dims, cap, mask=None):
    C = dims[0] * dims[1] * dims[2]
    return _bin_by_key(_cell_keys(points, origin, cell_size, dims, mask),
                       points, C, cap)


def build_rollgrid(points, origin, cell_size, dims: Tuple[int, int, int],
                   cap: int, mask=None) -> RollGrid:
    """Bin the target once and assemble every cell's 27-neighbourhood
    (reused by every query and ICP iteration), on `points.device`."""
    dev = points.device
    origin = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    cell_size = torch.as_tensor(np.float32(cell_size), device=dev)
    dims = tuple(int(d) for d in dims)
    Gx, Gy, Gz = dims
    C = Gx * Gy * Gz
    soa, index = _bin_points(points, origin, cell_size, dims, int(cap),
                             mask)
    soa = torch.where(torch.isfinite(soa), soa, CAND_FILL)
    cells5 = soa.reshape(3, Gx, Gy, Gz, cap)
    index4 = index.reshape(Gx, Gy, Gz, cap)
    KC = _round_up(27 * cap, 128)
    cand = torch.full((C, 3, KC), CAND_FILL, dtype=torch.float32,
                      device=dev)
    cidx = torch.full((C, KC), INVALID_INDEX, dtype=torch.int32,
                      device=dev)
    # both guard rings are empty, so wrapped neighbours are empty runs
    for r, off in enumerate(OFFSETS):
        lanes = slice(r * cap, (r + 1) * cap)
        cand[:, :, lanes] = torch.roll(cells5, off, (1, 2, 3)) \
            .reshape(3, C, cap).transpose(0, 1)
        cidx[:, lanes] = torch.roll(index4, off, (0, 1, 2)).reshape(C, cap)
    return RollGrid(cand, cidx, origin, cell_size, dims, cap)


def _bin_query_soa(queries, keys, n_bins: int, qcap: int):
    """Queries binned by `keys` at qcap: (q_soa [n_bins, 3, qcap] with
    the 1e18 fill, q_index [n_bins, qcap])."""
    soa, q_index = _bin_by_key(keys, queries, n_bins, qcap)
    soa = torch.where(torch.isfinite(soa), soa, QUERY_FILL)
    return soa.transpose(0, 1).contiguous(), q_index


def reduce_and_scatter(q_soa, q_index, grid, radius, Q: int):
    """Kernel 4 over the binned queries against `grid` (a RollGrid or a
    CellGrid), then the results back to query order: (index [Q] int32
    or -1, dist2 [Q], inf for none)."""
    r2 = torch.tensor(float(radius), dtype=torch.float32) ** 2
    bidx, bd2 = rollgrid_nn.nn_reduce(q_soa, grid.cand, grid.cand_idx, r2,
                                      grid.cand_rank)
    return (scatter_to_source(q_index, bidx, Q, INVALID_INDEX),
            scatter_to_source(q_index, bd2, Q, float("inf")))


def bin_queries(grid: RollGrid, queries, query_mask=None, qcap: int = 0):
    """Queries binned by cell at qcap (default: the grid's cap), the
    reduce's input: (q_soa [C, 3, qcap], q_index [C, qcap])."""
    keys = _cell_keys(queries, grid.origin, grid.cell_size, grid.dims,
                      query_mask)
    return _bin_query_soa(queries, keys, grid.cand.shape[0],
                          qcap or grid.cap)


def query_nn_rollgrid(grid: RollGrid, queries, radius, query_mask=None,
                      qcap: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN within `radius`: (index [Q] int32 or -1, dist2 [Q], inf for
    none). Queries past a cell's qcap (default: the grid's cap) get -1."""
    q_soa, q_index = bin_queries(grid, queries, query_mask, qcap)
    return reduce_and_scatter(q_soa, q_index, grid, radius,
                              queries.shape[0])
