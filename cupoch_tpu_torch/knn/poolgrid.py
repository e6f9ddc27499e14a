"""Pooled-query correspondence grid: the ICP hot path, in PyTorch.

Counterpart of the JAX package's `knn/poolgrid.py`; the grid, its plan
and its epilogue follow it step for step, so plans, drop counts and
binned tables compare one to one. What differs is the score table and
the kernel that reads it:

* The TPU kept a lanes-major bf16 table [G*KC, 4T] plus a bf16
  low-order residual for exact passes. Here the table is ONE f32
  tensor, cell-major [C_pad, KC, 4] with fields (-2cx, -2cy, -2cz,
  |c|^2) of the cell-centred candidate c (empty slots: c = 0,
  |c|^2 = BIG). One cell's candidates are one contiguous row, which is
  what a GPU block reads.
* The slot pass (`poolgrid_slot.slot_pass`) scores in f32 in every
  pass, so the Gauss-Newton passes and the exact correspondence pass
  run the same kernel, `csrc/poolgrid_slot.cu`.

Pipeline per ICP iteration: queries are pooled per supertile of T
consecutive (active) cells with a cell tag (`bin_queries_pool`, only
when the pose has moved past the margin); the slot pass picks each
query's winning slot; the epilogue turns slots into exact world-frame
residuals with one row gather from the bin-ordered field table and
reduces the Gauss-Newton sums. Capacity overflow on either side is
counted, never silent.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utility import trace
from ..utility.device import resolve_device
from . import plan_stats, poolgrid_slot
from .rungrid import (
    EST_NONE, EST_PT2PT, EST_PT2PL, EST_SYM, INVALID_INDEX, N_SUMS,
    RUN_OFFSETS, SENTINEL_BIN, WINDOW, _bin_to_slots, _lin_morton,
    cell_centers,
)

BIG = 3.0e18
NPARAMS = 32

# estimator codes beyond rungrid's (values match
# registration.estimation.TransformationEstimationType)
EST_COLORED = 4
EST_GICP = 5


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def n_fields(est: int) -> int:
    """World-frame per-point field-table width: x, y, z always, then
    estimator channels (PT2PL: n, d; SYM: n; COLORED: n, intensity,
    gradient; GICP: cov upper 6)."""
    return {EST_NONE: 3, EST_PT2PT: 3, EST_PT2PL: 7, EST_SYM: 6,
            EST_COLORED: 10, EST_GICP: 9}[est]


def n_query_extra(est: int) -> int:
    """Query-side extra channels pooled alongside x, y, z, tag, cc:
    SYM: source normal (3); COLORED: source intensity (1);
    GICP: source covariance upper-triangle (6)."""
    return {EST_NONE: 0, EST_PT2PT: 0, EST_PT2PL: 0, EST_SYM: 3,
            EST_COLORED: 1, EST_GICP: 6}[est]


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------

class PoolGrid:
    """The built target grid.

    table     [C_pad, KC, 4] f32  cell-major score table: row = (active)
                                  cell rank, slot k < 27*cap = candidate
                                  `rank` of neighbour run k // cap, fields
                                  (-2cx, -2cy, -2cz, |c|^2), cell-centred;
                                  empty and pad slots c = 0, |c|^2 = BIG
    binfields [C*cap, F+1] f32    world-frame per-point columns in BIN
                                  order (x, y, z, estimator channels,
                                  original index as f32; -1 empty)
    origin [3], cell_size [], off [] f32 tensors (off > max |e|^2)
    n_dropped []                  target points dropped by the cell cap
    cell_map [C] int32 or None    active rank per cell (-1 inactive) for
                                  compact (surface) grids
    """

    def __init__(self, table, binfields, origin, cell_size, off, dims,
                 cap, kc, est, tile, n_dropped=None, cell_map=None):
        self.table = table
        self.binfields = binfields
        self.origin = origin
        self.cell_size = cell_size
        self.off = off
        self.dims = tuple(int(d) for d in dims)
        self.cap = int(cap)
        self.kc = int(kc)
        self.est = int(est)
        self.tile = int(tile)
        self.n_dropped = n_dropped
        self.cell_map = cell_map

    @property
    def n_tiles(self) -> int:
        return self.table.shape[0] // self.tile

    @classmethod
    def from_numpy(cls, scan, scan_lo, binfields, origin, cell_size, off,
                   dims, cap, kc, est, tile, n_dropped=None,
                   cell_map=None, device=None) -> "PoolGrid":
        """Build the port's grid from the JAX PoolGrid's leaves given as
        numpy arrays: the f32 score table is scan + scan_lo (lanes-major
        [G*KC, 4T]) re-laid out cell-major; binfields passes through.
        A size-0 or None cell_map means a dense grid."""
        dev = resolve_device(device)
        kc, tile = int(kc), int(tile)
        s = np.asarray(scan).astype(np.float32) \
            + np.asarray(scan_lo).astype(np.float32)
        G = s.shape[0] // kc
        table = s.reshape(G, kc, tile, 4).transpose(0, 2, 1, 3) \
            .reshape(G * tile, kc, 4)

        def f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=dev)

        cmap = None
        if cell_map is not None and np.asarray(cell_map).size:
            cmap = torch.as_tensor(np.array(cell_map, np.int32),
                                   device=dev)
        nd = None if n_dropped is None else torch.as_tensor(
            int(np.asarray(n_dropped)), device=dev)
        return cls(f32(table), f32(binfields),
                   f32(origin), f32(cell_size), f32(off), dims, cap, kc,
                   est, tile, n_dropped=nd, cell_map=cmap)


# ---------------------------------------------------------------------------
# plan, on the cloud's device (identical to the JAX package's plan)
# ---------------------------------------------------------------------------

@trace.planner("pool")
def plan_poolgrid(points, radius: float,
                  margin: float = 0.375,
                  query_points=None,
                  cap_percentile: float = 99.5,
                  max_cells: int = 2_000_000,
                  cap_limit: int = 128,
                  mem_budget_bytes: int = 6 << 30,
                  tile: int = 32,
                  qp_limit: int = 8192,
                  est: int = EST_NONE,
                  shards: int = 1) -> Optional[dict]:
    """Sizing on the device of `points` (a tensor; an array plans on the
    CPU), read back in two small reads (`plan_stats`). Returns None
    when a dense grid is unreasonable. `active_cells`, the compact
    grid's active cell ids, stays on that device (int32).

    cell = radius*(1+margin): queries binned at transform T_bin stay
    valid for the 27-neighborhood while every point has moved less
    than radius*margin since binning."""
    pts = plan_stats.as_points(points)
    if radius <= 0:
        return None
    finite, lo_d, npts_f, lo, hi = plan_stats.bounds(pts)
    if npts_f == 0:
        return None
    dev = pts.device
    cell = float(radius) * (1.0 + float(margin))
    dims_core = plan_stats.core_dims(lo, hi, cell)
    dims = tuple(int(d) + 2 for d in dims_core)
    n_cells = int(np.prod(dims))
    if n_cells > max_cells:
        return None
    counts = plan_stats.core_counts(pts, finite, lo_d, cell, dims_core)
    s = plan_stats.ascending(counts)
    # predicted target drops sum((count - c)+) of each candidate cap c,
    # from prefix sums of the sorted counts
    caps = torch.arange(8, cap_limit + 1, 8, dtype=s.dtype, device=dev)
    pre = torch.cat([s.new_zeros(1, dtype=torch.int64), s.cumsum(0)])
    k = torch.searchsorted(s, caps, right=True)
    drops = pre[-1] - pre[k] - caps * (s.numel() - k)

    # active-cell compaction (surface clouds): a cell whose 27-
    # neighborhood holds no target point can never yield a
    # correspondence, so its table rows need not exist and queries
    # binned there are dropped as provably matchless
    occ3 = torch.zeros(dims, dtype=torch.bool, device=dev)
    occ3[1:-1, 1:-1, 1:-1] = (counts > 0).reshape(tuple(dims_core))
    act = plan_stats.dilate27(occ3).reshape(-1)
    rank = act.cumsum(0) - 1
    n_act = act.sum()
    parts = [plan_stats.order_stats(s, [cap_percentile]), s[-1], n_act,
             drops]

    # per-supertile query counts (for pool sizing): z-major supertiles
    # of `tile` consecutive (active) cells
    if query_points is not None:
        q = plan_stats.as_points(query_points).to(dev)
        qlin = plan_stats.cell_ids(
            plan_stats.floor_div(q.double(), lo_d, cell) + 1,
            torch.isfinite(q).all(-1), dims, clip=False)
        qrank = torch.where(n_act <= int(0.55 * n_cells),
                            torch.where(act, rank, -1),
                            torch.arange(n_cells, device=dev))
        qrank = torch.cat([qrank, qrank.new_full((1,), -1)])[qlin]
        n_tiles = -(-n_cells // tile)
        tcnt = torch.zeros(n_tiles + 1, dtype=torch.float64, device=dev)
        tcnt.index_add_(0, torch.where(qrank >= 0, qrank // tile, n_tiles),
                        torch.ones_like(qrank, dtype=torch.float64))
        parts += [(qlin < n_cells).sum(),
                  plan_stats.order_stats(plan_stats.ascending(tcnt[:-1]),
                                         [cap_percentile])]
    host = plan_stats.read(parts)
    n_occ, cap_a, cap_b, count_max, n_active = host[:5]
    drops = host[5:5 + caps.numel()]
    if n_occ == 0:
        cap = 8
    elif cap_percentile >= 100.0:
        cap = int(count_max)
    else:
        # drop-bounded capacity: the smallest cap whose predicted target
        # drops stay under 0.15% of the cloud (below the caller's 0.2%
        # regrow threshold)
        budget = max(32, int(0.0015 * npts_f))
        cap = next((c for c, d in zip(range(8, cap_limit + 1, 8), drops)
                    if d <= budget), None)
        if cap is None:
            pct = int(plan_stats.percentile(int(n_occ), cap_a, cap_b,
                                            cap_percentile))
            if pct > cap_limit:
                return None
            cap = pct
    if cap > cap_limit:
        return None
    cap = max(8, _round_up(cap, 8))
    kc = _round_up(27 * cap, WINDOW)
    assert 27 * cap <= poolgrid_slot.SLOT_MASK + 1

    n_active = int(n_active)
    compact = n_active <= int(0.55 * n_cells)
    active_cells = plan_stats.set_ids(act, rank, n_active, 0) \
        if compact else None
    c_pad = _round_up(n_active if compact else n_cells, tile * shards)
    qp = 16 * tile
    if query_points is not None:
        n_q_in, n_tocc, qp_a, qp_b = host[5 + caps.numel():]
        if n_q_in:
            if n_tocc:
                qp = int(plan_stats.percentile(int(n_tocc), qp_a, qp_b,
                                               cap_percentile))
            qp = int(qp * 1.2) + 8
    qp = _round_up(max(qp, 8), 128 if qp > 128 else 8)
    if qp > qp_limit:
        return None
    F = n_fields(est)
    # the same byte budget as the JAX package's plan (which counts its
    # two bf16 tables as 4*C_pad*kc*4 bytes: the port's one f32 table
    # has exactly that size)
    grid_bytes = (c_pad * 4 * kc * 4) // shards \
        + n_cells * cap * (F + 1) * 4
    if grid_bytes > mem_budget_bytes:
        return None
    origin = (lo - cell).astype(np.float32)
    return {
        "dims": dims, "origin": origin, "cap": cap, "kc": int(kc),
        "qp": int(qp), "tile": int(tile), "shards": int(shards),
        "cell_size": np.float32(cell),
        "rebin_margin": np.float32(float(radius) * float(margin)),
        "active_cells": active_cells, "n_active": n_active,
    }


# ---------------------------------------------------------------------------
# binning: sort by (bin | morton) key, rank within bin, scatter to slots
# ---------------------------------------------------------------------------

def _cell_key(points, origin, cell_size, dims, n_bins_div, mask=None,
              cell_map=None):
    """(bin | 6-bit Morton) int32 key; bin = cell_rank // n_bins_div
    where cell_rank is the linear cell (dense) or its active rank
    (`cell_map` set; queries in inactive cells are provably matchless
    and go to the sentinel, as do out-of-bounds and masked points).
    Returns (key, linear cell id, in-bounds mask)."""
    C = dims[0] * dims[1] * dims[2]
    lin, m, inb = _lin_morton(points, origin, cell_size, dims, mask)
    if cell_map is not None:
        rank = cell_map[lin.clamp(0, C - 1).long()]
        inb = inb & (rank >= 0)
    else:
        rank = lin
    key = torch.where(inb, torch.div(rank, n_bins_div, rounding_mode="floor")
                      * 64 + m, SENTINEL_BIN * 64)
    return key, lin, inb


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def build_poolgrid_arrays(points, attrs, origin, cell_size,
                          dims: Tuple[int, int, int], cap: int, kc: int,
                          tile: int, mask=None, active_cells=None,
                          shards: int = 1):
    """Bin the target once; assemble each (active) cell's 27-run
    neighbourhood into the f32 score table, and keep a compact
    world-frame field table for the epilogue.

    Dense grids take the 27 runs as rolls of the [Gx, Gy, Gz, cap]
    binned channels; with `active_cells` ([C_pad] int32, -1 pad) only
    active cells get table rows, gathered from their 27 neighbours.
    C_pad is a multiple of tile * shards, so the table splits into
    `shards` equal blocks of whole supertiles (the ring's shards).
    Returns (table [C_pad, kc, 4], binfields [C*cap, F+1], off,
    n_dropped)."""
    Gx, Gy, Gz = dims
    C = Gx * Gy * Gz
    dev = points.device
    key, lin, _ = _cell_key(points, origin, cell_size, dims, 1, mask)
    linc = lin.clamp(0, C - 1).long()
    cen = cell_centers(dims, origin, cell_size, C)[linc]
    pc = points - cen
    inf = float("inf")
    binned, index, n_dropped = _bin_to_slots(
        key, C, cap, [pc[:, 0], pc[:, 1], pc[:, 2]], [inf] * 3)

    if active_cells is None:
        # DENSE: 27-run neighbourhood as rolls (both guard rings are
        # empty, so wrapped neighbours are empty runs)
        C_pad = _round_up(C, tile * shards)

        def runs(arr2d):
            arr = arr2d.reshape(Gx, Gy, Gz, cap)
            return torch.cat([
                torch.roll(arr, (-dx, -dy, -dz), (0, 1, 2)).reshape(C, cap)
                for (dx, dy, dz) in RUN_OFFSETS], -1)
        avalid = None
    else:
        # COMPACT: row gathers of each active cell's 27 neighbour rows
        C_pad = active_cells.shape[0]          # multiple of tile*shards
        avalid = active_cells >= 0
        a = active_cells.clamp(min=0).long()
        az = a % Gz
        ay = (a // Gz) % Gy
        ax = a // (Gz * Gy)
        ioffs = torch.tensor(RUN_OFFSETS, dtype=torch.long, device=dev)
        nbr = (((ax[:, None] + ioffs[None, :, 0]) % Gx) * Gy
               + ((ay[:, None] + ioffs[None, :, 1]) % Gy)) * Gz \
            + ((az[:, None] + ioffs[None, :, 2]) % Gz)    # [C_pad, 27]
        nbr_flat = nbr.reshape(-1)

        def runs(arr2d):
            return arr2d[nbr_flat].reshape(C_pad, 27 * cap)

    lane_off = torch.tensor(RUN_OFFSETS, dtype=torch.float32,
                            device=dev).repeat_interleave(cap, 0)
    cx, cy, cz = (runs(binned[i]) + lane_off[None, :, i] * cell_size
                  for i in range(3))
    if avalid is not None:
        # pad rows (active_cells == -1) must never win
        cx = torch.where(avalid[:, None], cx, inf)
    empty = ~torch.isfinite(cx)
    cx, cy, cz = (torch.where(empty, 0.0, v) for v in (cx, cy, cz))
    cn = torch.where(empty, BIG, cx * cx + cy * cy + cz * cz)

    # rows past the real cells (dense C_pad > C) stay zero: they own no
    # queries. Slots past 27*cap are empty: c = 0, |c|^2 = BIG.
    rows, n_lanes = cx.shape
    table = torch.zeros((C_pad, kc, 4), dtype=torch.float32, device=dev)
    for f, v in enumerate((-2.0 * cx, -2.0 * cy, -2.0 * cz, cn)):
        table[:rows, :n_lanes, f] = v
    table[:rows, n_lanes:, 3] = BIG

    # world-frame per-point fields + original index in BIN order over
    # the full grid: one row gather resolves a winner
    fields = torch.cat([points, attrs], -1).float() if attrs.shape[1] \
        else points.float()
    idx_flat = index.reshape(-1)
    safe_idx = idx_flat.clamp(0, points.shape[0] - 1).long()
    binfields = torch.cat([fields[safe_idx], idx_flat[:, None].float()], -1)
    empty_row = torch.zeros(fields.shape[1] + 1, device=dev)
    empty_row[-1] = INVALID_INDEX
    binfields = torch.where(idx_flat[:, None] >= 0, binfields, empty_row)

    off = 8.0 * cell_size * cell_size
    return table, binfields, off, n_dropped


def _cell_map_from_active(active_cells, n_cells: int):
    """[C] int32 active rank per cell (-1 inactive) from the padded
    active id list."""
    ca = active_cells.shape[0]
    slot = torch.where(active_cells >= 0, active_cells, n_cells).long()
    out = torch.full((n_cells + 1,), -1, dtype=torch.int32,
                     device=active_cells.device)
    out[slot] = torch.arange(ca, dtype=torch.int32,
                             device=active_cells.device)
    return out[:n_cells]


def make_poolgrid(points, attrs, origin, cell_size, dims, cap, kc,
                  est: int = EST_NONE, tile: int = 32, mask=None,
                  active_cells=None, shards: int = 1) -> PoolGrid:
    """Build the grid on `points.device`. `active_cells`: optional int
    tensor or array of active cell ids from plan_poolgrid (compact
    surface-cloud grid); padded here, on the device, to a multiple of
    `tile * shards` with -1."""
    dev = points.device
    origin = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    cell_size = torch.as_tensor(np.float32(cell_size), device=dev)
    cell_map = None
    act = None
    if active_cells is not None:
        act = torch.as_tensor(active_cells if torch.is_tensor(active_cells)
                              else np.asarray(active_cells),
                              dtype=torch.int32, device=dev)
        ca_pad = _round_up(max(act.shape[0], 1), int(tile) * int(shards))
        act = torch.cat([act, act.new_full((ca_pad - act.shape[0],), -1)])
        cell_map = _cell_map_from_active(
            act, int(dims[0]) * int(dims[1]) * int(dims[2]))
    table, binfields, off, n_dropped = build_poolgrid_arrays(
        points, attrs, origin, cell_size, tuple(int(d) for d in dims),
        int(cap), int(kc), int(tile), mask=mask,
        active_cells=act, shards=int(shards))
    return PoolGrid(table, binfields, origin, cell_size, off, dims, cap,
                    kc, est, tile, n_dropped=n_dropped, cell_map=cell_map)


# ---------------------------------------------------------------------------
# query-side pooling
# ---------------------------------------------------------------------------

def bin_queries_pool(points, bin_T, origin, cell_size,
                     dims: Tuple[int, int, int], qp: int, tile: int,
                     extra=None, n_extra: int = 0, mask=None,
                     cell_map=None, n_rank_pad: Optional[int] = None,
                     shards: int = 1):
    """Pool queries per supertile of `tile` consecutive z-major cells
    (consecutive ACTIVE cells when `cell_map` is given).
    `n_rank_pad`: padded rank-domain size (the grid's supertile count x
    tile); defaults to round_up(C, tile * shards) for dense grids.

    Returns (qpool [G, CH, QP] f32 rows (x, y, z, tagf, ccx, ccy, ccz,
    extra..., 0), qidx [G, QP] int32 (-1 empty), n_dropped). Queries
    keep their ORIGINAL coordinates and are binned at bin_T @ q; tagf
    is the cell within the supertile (-1 empty)."""
    C = dims[0] * dims[1] * dims[2]
    if n_rank_pad is not None:
        C_pad = int(n_rank_pad)
    else:
        if cell_map is not None:
            raise ValueError("compact binning needs n_rank_pad")
        C_pad = _round_up(C, tile * shards)
    G = C_pad // tile
    bin_T = bin_T.to(points.device, torch.float32)
    Rb = bin_T[:3, :3]
    tb = bin_T[:3, 3]
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    # explicit per-axis multiplies in a fixed order, not a matmul: the
    # tag and cell centre below are decoded from the linear id binned
    # here, and stay consistent with these positions
    bin_positions = torch.stack(
        [Rb[0, 0] * px + Rb[0, 1] * py + Rb[0, 2] * pz + tb[0],
         Rb[1, 0] * px + Rb[1, 1] * py + Rb[1, 2] * pz + tb[1],
         Rb[2, 0] * px + Rb[2, 1] * py + Rb[2, 2] * pz + tb[2]], -1)
    key, lin, inb = _cell_key(bin_positions, origin, cell_size, dims,
                              tile, mask, cell_map=cell_map)
    # the exact linear cell id rides the sort as an f32 channel (exact
    # below 2^24); tag and cell centre are decoded from IT after
    # pooling, so they agree with the key binning bit for bit
    linf = torch.where(inb, lin, -1).float()
    channels = [px, py, pz, linf]
    channels += [extra[:, i] for i in range(n_extra)]
    fill = [0.0, 0.0, 0.0, -1.0] + [0.0] * n_extra
    binned, index, n_dropped = _bin_to_slots(key, G, qp, channels, fill)
    x, y, z = binned[0], binned[1], binned[2]
    linq = binned[3].to(torch.int32)
    occ = (index >= 0) & (linq >= 0)
    lc = linq.clamp(0, C - 1)
    rank_q = cell_map[lc.long()] if cell_map is not None else linq
    occ = occ & (rank_q >= 0)
    tagf = torch.where(occ, (rank_q % tile).float(), -1.0)
    cellz = (lc % dims[2]).float()
    celly = ((lc // dims[2]) % dims[1]).float()
    cellx = (lc // (dims[2] * dims[1])).float()
    ccx = origin[0] + (cellx + 0.5) * cell_size
    ccy = origin[1] + (celly + 0.5) * cell_size
    ccz = origin[2] + (cellz + 0.5) * cell_size
    # x, y, z, tag, ccx, ccy, ccz, extras, padded to a multiple of 4
    # with a floor of 8 (the slot kernel reads the first 7)
    CH = max(8, _round_up(7 + n_extra, 4))
    rows = [x, y, z, tagf, ccx, ccy, ccz] + binned[4:]
    rows += [torch.zeros_like(x)] * (CH - len(rows))
    qpool = torch.stack(rows[:CH], 1)
    return qpool, index, n_dropped


# ---------------------------------------------------------------------------
# per pass
# ---------------------------------------------------------------------------

def make_params(T, r2, grid: PoolGrid, extra0=0.0, extra1=0.0):
    """[NPARAMS] f32 on the grid's device: R row-major (0-8), t (9-11),
    r^2 (12), key offset OFF (13), the estimator's extras (17-18: Colored
    ICP's sqrt(lambda_geometric) and sqrt(lambda_photometric)), zero
    elsewhere."""
    dev = grid.table.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev).reshape(1)

    T = torch.as_tensor(T, dtype=torch.float32).to(dev)
    head = torch.cat([T[:3, :3].reshape(-1), T[:3, 3], f32(r2),
                      grid.off.reshape(1),
                      torch.zeros(3, dtype=torch.float32, device=dev),
                      f32(extra0), f32(extra1)])
    return torch.cat([head, torch.zeros(NPARAMS - head.shape[0],
                                        dtype=torch.float32, device=dev)])


def _gn_terms_world(est: int, f, tx, ty, tz, px, py, pz, q_extra,
                    R9, slg, slp, ok, d2c):
    """GN sum terms from world-frame quantities. f: gathered field
    columns beyond coordinates; q_extra: pooled query extra channels;
    slg, slp: Colored ICP's square-rooted weights. Slot layout as
    `rungrid.N_SUMS`."""
    w = ok.float()
    if est in (EST_NONE, EST_PT2PT):
        terms = [w, w * tx, w * ty, w * tz, w * px, w * py, w * pz]
        for s in (tx, ty, tz):
            for d in (px, py, pz):
                terms.append(w * s * d)
        terms.append(d2c)
        return terms
    if est in (EST_COLORED, EST_GICP):
        return _gn_terms_ext(est, f, tx, ty, tz, tx - px, ty - py, tz - pz,
                             q_extra, R9, slg, slp, ok, d2c)
    if est == EST_PT2PL:
        nx, ny, nz, dd = f[0], f[1], f[2], f[3]
        r = nx * tx + ny * ty + nz * tz - dd
        j = (ty * nz - tz * ny, tz * nx - tx * nz, tx * ny - ty * nx,
             nx, ny, nz)
    elif est == EST_SYM:
        nx, ny, nz = f[0], f[1], f[2]
        s0, s1, s2 = q_extra[0], q_extra[1], q_extra[2]
        R00, R01, R02, R10, R11, R12, R20, R21, R22 = R9
        mx = nx + R00 * s0 + R01 * s1 + R02 * s2
        my = ny + R10 * s0 + R11 * s1 + R12 * s2
        mz = nz + R20 * s0 + R21 * s1 + R22 * s2
        r = (tx - px) * mx + (ty - py) * my + (tz - pz) * mz
        ux, uy, uz = tx + px, ty + py, tz + pz
        j = (uy * mz - uz * my, uz * mx - ux * mz, ux * my - uy * mx,
             mx, my, mz)
    else:
        raise ValueError(f"unknown estimator code {est}")
    terms = []
    for i in range(6):
        for k in range(i, 6):
            terms.append(w * j[i] * j[k])          # 21 JTJ upper-tri
    for i in range(6):
        terms.append(w * j[i] * r)                 # 6 JTr
    terms.append(w)                                # 27: count
    terms.append(d2c)                              # 28: err
    return terms


def _gn_terms_ext(est: int, f, tx, ty, tz, dx, dy, dz, q_extra, R9, slg,
                  slp, ok, d2c):
    """GN sum terms of Colored ICP and GICP, term for term as the JAX
    package's epilogue computes them. d* = q - p is the world residual;
    q_extra holds the source intensity (Colored) or the upper triangle
    of the source covariance (GICP), which R9 turns by the pose. GICP's
    sqrtm whitening is folded in: (WJ)^T (WJ) = J^T M^-1 J."""
    w = ok.float()
    if est == EST_COLORED:
        nx, ny, nz = f[0], f[1], f[2]
        it = f[3]
        gx, gy, gz = f[4], f[5], f[6]
        i_s = q_extra[0]
        dn = nx * dx + ny * dy + nz * dz
        r_g = slg * dn
        jg = (slg * (ty * nz - tz * ny), slg * (tz * nx - tx * nz),
              slg * (tx * ny - ty * nx), slg * nx, slg * ny, slg * nz)
        gn = gx * nx + gy * ny + gz * nz
        ex_, ey_, ez_ = (-(gx - gn * nx), -(gy - gn * ny),
                         -(gz - gn * nz))          # ditM
        vpx = dx - dn * nx
        vpy = dy - dn * ny
        vpz = dz - dn * nz
        is0 = gx * vpx + gy * vpy + gz * vpz + it
        r_p = slp * (i_s - is0)
        jp = (slp * (ty * ez_ - tz * ey_), slp * (tz * ex_ - tx * ez_),
              slp * (tx * ey_ - ty * ex_), slp * ex_, slp * ey_,
              slp * ez_)
        terms = []
        for i in range(6):
            for k in range(i, 6):
                terms.append(w * (jg[i] * jg[k] + jp[i] * jp[k]))
        for i in range(6):
            terms.append(w * (jg[i] * r_g + jp[i] * r_p))
        terms.append(w)
        terms.append(d2c)
        return terms
    ct = f[:6]                # target covariance, upper triangle
    a, b, c, d, e, g = q_extra[:6]
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = R9
    # B = R Cs (rows of R times the symmetric Cs)
    B00 = R00 * a + R01 * b + R02 * c
    B01 = R00 * b + R01 * d + R02 * e
    B02 = R00 * c + R01 * e + R02 * g
    B10 = R10 * a + R11 * b + R12 * c
    B11 = R10 * b + R11 * d + R12 * e
    B12 = R10 * c + R11 * e + R12 * g
    B20 = R20 * a + R21 * b + R22 * c
    B21 = R20 * b + R21 * d + R22 * e
    B22 = R20 * c + R21 * e + R22 * g
    # M = Ct + B R^T (symmetric)
    m00 = ct[0] + B00 * R00 + B01 * R01 + B02 * R02
    m01 = ct[1] + B00 * R10 + B01 * R11 + B02 * R12
    m02 = ct[2] + B00 * R20 + B01 * R21 + B02 * R22
    m11 = ct[3] + B10 * R10 + B11 * R11 + B12 * R12
    m12 = ct[4] + B10 * R20 + B11 * R21 + B12 * R22
    m22 = ct[5] + B20 * R20 + B21 * R21 + B22 * R22
    # A = M^-1 by the adjugate (M is PSD and epsilon-regularised)
    a00 = m11 * m22 - m12 * m12
    a01 = m02 * m12 - m01 * m22
    a02 = m01 * m12 - m02 * m11
    a11 = m00 * m22 - m02 * m02
    a12 = m01 * m02 - m00 * m12
    a22 = m00 * m11 - m01 * m01
    det = m00 * a00 + m01 * a01 + m02 * a02
    inv = 1.0 / det.clamp(min=1e-30)
    a00, a01, a02 = a00 * inv, a01 * inv, a02 * inv
    a11, a12, a22 = a11 * inv, a12 * inv, a22 * inv
    # J0 columns: u0 = (0, -z, y), u1 = (z, 0, -x), u2 = (-y, x, 0),
    # u3..u5 = the unit axes
    zero = torch.zeros_like(tx)
    ucols = ((zero, -tz, ty), (tz, zero, -tx), (-ty, tx, zero),
             (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))

    def Au(u):
        ux, uy, uz = u
        return (a00 * ux + a01 * uy + a02 * uz,
                a01 * ux + a11 * uy + a12 * uz,
                a02 * ux + a12 * uy + a22 * uz)

    Aus = [Au(u) for u in ucols]
    terms = []
    for i in range(6):
        for k in range(i, 6):
            ux, uy, uz = ucols[i]
            vx, vy, vz = Aus[k]
            terms.append(w * (ux * vx + uy * vy + uz * vz))
    for i in range(6):
        vx, vy, vz = Aus[i]
        terms.append(w * (dx * vx + dy * vy + dz * vz))
    terms.append(w)
    terms.append(d2c)
    return terms


def _epilogue(grid: PoolGrid, qpool, slot, params, est: int,
              corres: bool):
    """slot -> original target index -> exact residuals; then either
    the per-query correspondence pair (d2 [G, QP] with inf for none,
    idx [G, QP] int32 with -1) or the reduced GN sums [N_SUMS]. The one
    gather is against the bin-ordered [C*cap, F+1] field table.

    `binfields` stays global when `grid.table` is a ring shard
    (`fused_icp.icp_core_pool_ring`), and a winner's cell is decoded
    from its query's bin-time cell centre, so the gather does not
    depend on which shard scored the queries (the JAX package's `tile0`
    argument, which its epilogue does not read, has no counterpart)."""
    G, CH, QP = qpool.shape
    Gx, Gy, Gz = grid.dims
    cap = grid.cap
    dev = qpool.device
    R = params[:9]
    t = params[9:12]
    r2 = params[12]

    valid = qpool[:, 3] >= 0.0
    slot = slot.long()
    in_lanes = slot < 27 * cap
    sl = slot.clamp(0, 27 * cap - 1)
    run = sl // cap
    rank = sl % cap
    offs = torch.tensor(RUN_OFFSETS, dtype=torch.long, device=dev)[run]
    # the query's original cell decodes from its bin-time cell centre
    # (cc = origin + (cell+0.5)*h: the floor sits mid-cell)
    inv_h = 1.0 / grid.cell_size
    cx = torch.floor((qpool[:, 4] - grid.origin[0]) * inv_h).long() \
        .clamp(0, Gx - 1)
    cy = torch.floor((qpool[:, 5] - grid.origin[1]) * inv_h).long() \
        .clamp(0, Gy - 1)
    cz = torch.floor((qpool[:, 6] - grid.origin[2]) * inv_h).long() \
        .clamp(0, Gz - 1)
    # wraparound neighbour arithmetic matches the build's rolls
    nbr = ((cx + offs[..., 0]) % Gx * Gy + (cy + offs[..., 1]) % Gy) * Gz \
        + (cz + offs[..., 2]) % Gz
    g = grid.binfields[(nbr * cap + rank).reshape(-1)].reshape(G, QP, -1)
    f = g[..., :-1]
    pidx = g[..., -1].to(torch.int32)
    ok0 = valid & in_lanes & (pidx >= 0)
    qx, qy, qz = qpool[:, 0], qpool[:, 1], qpool[:, 2]
    tx = R[0] * qx + R[1] * qy + R[2] * qz + t[0]
    ty = R[3] * qx + R[4] * qy + R[5] * qz + t[1]
    tz = R[6] * qx + R[7] * qy + R[8] * qz + t[2]
    px, py, pz = f[..., 0], f[..., 1], f[..., 2]
    dx, dy, dz = tx - px, ty - py, tz - pz
    d2 = dx * dx + dy * dy + dz * dz
    ok = ok0 & (d2 <= r2)
    if corres:
        return (torch.where(ok, d2, float("inf")),
                torch.where(ok, pidx, INVALID_INDEX))
    d2c = torch.where(ok, d2, 0.0)
    fcols = [f[..., 3 + k] for k in range(f.shape[-1] - 3)]
    q_extra = [qpool[:, 7 + k] for k in range(n_query_extra(est))]
    terms = _gn_terms_world(est, fcols, tx, ty, tz, px, py, pz, q_extra,
                            tuple(R), params[17], params[18], ok, d2c)
    sums = torch.stack(terms).sum((1, 2))
    return torch.cat([sums, sums.new_zeros(N_SUMS - sums.shape[0])])


def fused_pool_query(grid: PoolGrid, qpool, params, est: int,
                     corres: bool):
    """One correspondence (+GN reduction) pass over the pooled grid:
    the slot pass, then the epilogue. Returns (d2, idx) [G, QP] when
    `corres`, else the [N_SUMS] GN sums. `grid` may hold a ring shard
    of the table with the queries of its supertiles; its `binfields`
    are global."""
    slot = poolgrid_slot.slot_pass(grid, qpool, params)
    return _epilogue(grid, qpool, slot, params, est, corres)
