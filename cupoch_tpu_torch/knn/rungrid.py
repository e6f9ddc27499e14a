"""Run-structured candidate grid (counterpart of the JAX package's
`knn/rungrid.py`), in PyTorch.

The target is binned once into cells of `radius * (1 + margin)`. Every
cell gets one row of 27*cap candidate lanes: the contents of its 27
neighbour cells, stored relative to the row's cell centre as
(-2cx, -2cy, -2cz, |c|^2) and sorted by |c|, so each 128-lane window
has a rising lower bound `bounds` that lets a search stop early. The
row is truncated to the planned `kc` lanes. The estimator's winner
attributes ride along as two 16-bit quantised fields per int32 word
(`attrp`, unpacked with the (lo, scale) pairs in `pack_lohi`), exactly
as in the JAX package, so both grids hold the same bytes.

Queries are binned per cell (`bin_queries`) and searched by the fused
pass in `rungrid_fused.py` (kernel 2) or the Gaussian-moment pass in
`rungrid_gmm.py` (kernel 3). The helpers shared with the pooled grid
(`_lin_morton`, `_bin_to_slots`, `cell_centers`) live here.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..utility import trace
from ..utility.device import resolve_device
from . import plan_stats

INVALID_INDEX = -1
BIG = 3.0e18
WINDOW = 128  # pruning-window width in lanes
NPARAMS = 32

# 27 neighbor offsets in ascending center-to-center distance:
# own cell, 6 faces, 12 edges, 8 corners.
RUN_OFFSETS = tuple(sorted(
    ((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)),
    key=lambda o: (o[0] * o[0] + o[1] * o[1] + o[2] * o[2],) + o))

# estimator codes; values match
# registration.estimation.TransformationEstimationType where relevant
EST_NONE = 0    # correspondence only: outputs (d2, -index)
EST_PT2PT = 1   # packed attrs: centered target point
EST_PT2PL = 2   # packed attrs: normal + centered plane offset
EST_SYM = 3     # packed attrs: centered point + target normal

N_SUMS = 32
# GN slot layout: 0-20 JTJ upper-tri, 21-26 JTr, 27 count, 28 err
# PT2PT layout:   0 count, 1-3 sum(t), 4-6 sum(p), 7-15 sum(t p^T),
#                 16 err

SENTINEL_BIN = 1 << 24  # > any bin count (max_cells <= 2M)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _n_packed(est: int) -> int:
    return {EST_NONE: 0, EST_PT2PT: 2, EST_PT2PL: 2, EST_SYM: 3}[est]


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------

class RunGrid:
    """The built target grid; `dims`, `cap`, `kc`, `est` are ints.

    cand      [Cp, 4, KC] f32  rows (-2cx, -2cy, -2cz, |c|^2), c relative
                               to the row's cell center; empty: |c|^2 = BIG
    attrp     [Cp, P, KC] i32  two 16-bit quantized attribute fields per
                               lane (estimator-specific; P may be 0)
    negidx    [Cp, KC] f32     -original_index (+1 = empty)
    bounds    [Cp, NW] f32     min |c| per 128-lane window (+inf if empty)
    pack_lohi [2P, 2] f32      (lo, scale) per 16-bit field
    origin [3], cell_size [] f32 tensors
    """

    def __init__(self, cand, attrp, negidx, bounds, pack_lohi, origin,
                 cell_size, dims, cap, kc, est):
        self.cand = cand
        self.attrp = attrp
        self.negidx = negidx
        self.bounds = bounds
        self.pack_lohi = pack_lohi
        self.origin = origin
        self.cell_size = cell_size
        self.dims = tuple(int(d) for d in dims)
        self.cap = int(cap)
        self.kc = int(kc)
        self.est = int(est)

    @property
    def n_windows(self) -> int:
        return self.kc // WINDOW

    @property
    def nbytes(self) -> int:
        """Bytes the grid's tensors hold."""
        return sum(t.numel() * t.element_size() for t in vars(self).values()
                   if isinstance(t, torch.Tensor))

    @classmethod
    def from_numpy(cls, cand, attrp, negidx, bounds, pack_lohi, origin,
                   cell_size, dims, cap, kc, est, device=None) -> "RunGrid":
        """The port's grid from the JAX RunGrid's leaves given as numpy
        arrays (the layouts are the same)."""
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.as_tensor(np.array(a, dtype), device=dev)

        return cls(t(cand, np.float32), t(attrp, np.int32),
                   t(negidx, np.float32), t(bounds, np.float32),
                   t(pack_lohi, np.float32), t(origin, np.float32),
                   t(cell_size, np.float32), dims, cap, kc, est)


def padded_cells(dims) -> int:
    return _round_up(dims[0] * dims[1] * dims[2], 64)


# ---------------------------------------------------------------------------
# plan, on the cloud's device (identical to the JAX package's plan)
# ---------------------------------------------------------------------------

@trace.planner("run")
def plan_rungrid(points, radius: float,
                 margin: float = 0.25,
                 query_points=None,
                 cap_percentile: float = 99.5,
                 max_cells: int = 2_000_000,
                 cap_limit: int = 128,
                 mem_budget_bytes: int = 5 << 30,
                 nch: int = 4) -> Optional[dict]:
    """Sizing on the device of `points` (a tensor; an array plans on the
    CPU), read back in two small reads (`plan_stats`). Returns None
    when a dense grid is unreasonable.

    cell = radius*(1+margin): queries binned at transform T_bin stay
    valid for the 27-neighborhood as long as every point has moved
    less than radius*margin since binning."""
    pts = plan_stats.as_points(points)
    if radius <= 0:
        return None
    finite, lo_d, n_finite, lo, hi = plan_stats.bounds(pts)
    if n_finite == 0:
        return None
    cell = float(radius) * (1.0 + float(margin))
    dims_core = plan_stats.core_dims(lo, hi, cell)
    dims = tuple(int(d) + 2 for d in dims_core)
    n_cells = int(np.prod(dims))
    if n_cells > max_cells:
        return None
    counts = plan_stats.core_counts(pts, finite, lo_d, cell, dims_core)
    # lanes are sorted by distance at build, so KC can truncate to the
    # 99.9th percentile of 27-block occupancy instead of 27*cap
    blk = plan_stats.box27(counts.reshape(tuple(dims_core)))
    parts = [plan_stats.order_stats(plan_stats.ascending(counts),
                                    [cap_percentile]),
             plan_stats.order_stats(plan_stats.ascending(blk), [99.9])]
    if query_points is not None:
        # query-side cell capacity
        q = plan_stats.as_points(query_points).to(pts.device)
        qlin = plan_stats.cell_ids(
            plan_stats.floor_div(q.double(), lo_d, cell),
            torch.isfinite(q).all(-1), dims_core, clip=False)
        qcnt = plan_stats.counts(qlin, int(np.prod(dims_core)))
        parts.append(plan_stats.order_stats(plan_stats.ascending(qcnt),
                                            [cap_percentile]))
    host = plan_stats.read(parts)
    n_occ, cap_a, cap_b, n_blk, blk_a, blk_b = host[:6]
    cap = int(plan_stats.percentile(int(n_occ), cap_a, cap_b,
                                    cap_percentile)) if n_occ else 8
    if cap > cap_limit:
        return None
    cap = max(8, _round_up(cap, 8))
    kc_full = _round_up(27 * cap, WINDOW)
    if n_blk:
        kc = min(kc_full, max(WINDOW, _round_up(
            int(plan_stats.percentile(int(n_blk), blk_a, blk_b, 99.9)),
            WINDOW)))
    else:
        kc = kc_full
    qcap = cap
    if query_points is not None:
        n_qocc, q_a, q_b = host[6:]
        if n_qocc:
            qcap = int(plan_stats.percentile(int(n_qocc), q_a, q_b,
                                             cap_percentile))
        # rebinning shifts occupancy a little; leave headroom
        qcap = max(8, _round_up(int(qcap * 1.25) + 2, 8))
    cp = padded_cells(dims)
    grid_bytes = cp * kc * 4 * (4 + nch + 1)
    if grid_bytes > mem_budget_bytes:
        return None
    origin = (lo - cell).astype(np.float32)
    return {
        "dims": dims, "origin": origin, "cap": cap, "kc": int(kc),
        "qcap": int(qcap),
        "cell_size": np.float32(cell),
        "rebin_margin": np.float32(float(radius) * float(margin)),
    }


# ---------------------------------------------------------------------------
# binning (shared with the pooled grid)
# ---------------------------------------------------------------------------

def _lin_morton(points, origin, cell_size, dims, mask=None):
    """(linear cell id, 6-bit sub-cell Morton code, in-bounds & mask)
    per point. The Morton code makes lanes within a cell spatially
    coherent, so the 128-lane pruning windows stay tight."""
    rel = (points - origin) / cell_size
    cell = torch.floor(rel).to(torch.int32)
    dims_t = torch.tensor(dims, dtype=torch.int32, device=points.device)
    inb = ((cell >= 0) & (cell < dims_t)).all(-1)
    if mask is not None:
        inb = inb & mask
    lin = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    sub = ((rel - cell) * 4.0).clamp(0.0, 3.9999).to(torch.int32)
    m = ((sub[:, 0] & 2) << 4) | ((sub[:, 1] & 2) << 3) \
        | ((sub[:, 2] & 2) << 2) \
        | ((sub[:, 0] & 1) << 2) | ((sub[:, 1] & 1) << 1) \
        | (sub[:, 2] & 1)
    return lin, m, inb


def _cell_and_morton(points, origin, cell_size, dims, mask=None):
    """(linear cell | 6-bit Morton) key per point, out-of-bounds and
    masked-out points to the sentinel bin (dropped); and the linear
    cell id."""
    lin, m, inb = _lin_morton(points, origin, cell_size, dims, mask)
    return torch.where(inb, lin * 64 + m, SENTINEL_BIN * 64), lin


def _bin_to_slots(key, n_bins: int, cap: int, channels, fill):
    """Stable sort by key, rank within bin (key // 64), scatter the
    channels to [n_bins, cap] slots. Returns (outs, index [n_bins, cap]
    int32 of original positions (-1 empty), n_dropped)."""
    N = key.shape[0]
    dev = key.device
    keys_s, order = torch.sort(key, stable=True)
    pos = torch.arange(N, device=dev)
    bin_s = torch.div(keys_s, 64, rounding_mode="floor").long()
    boundary = torch.ones(N, dtype=torch.bool, device=dev)
    boundary[1:] = bin_s[1:] != bin_s[:-1]
    seg_start = torch.cummax(torch.where(boundary, pos, 0), 0).values
    rank = pos - seg_start
    valid = bin_s < n_bins
    ok = valid & (rank < cap)
    n_dropped = (valid & (rank >= cap)).sum()
    # slot n_bins*cap is the dump for dropped entries, sliced off below
    slot = torch.where(ok, bin_s * cap + rank, n_bins * cap)
    outs = []
    for ch, f in zip(channels, fill):
        buf = torch.full((n_bins * cap + 1,), f, dtype=ch.dtype, device=dev)
        buf[slot] = ch[order]
        outs.append(buf[:-1].reshape(n_bins, cap))
    index = torch.full((n_bins * cap + 1,), INVALID_INDEX,
                       dtype=torch.int32, device=dev)
    index[slot] = order.to(torch.int32)
    return outs, index[:-1].reshape(n_bins, cap), n_dropped


def cell_centers(dims, origin, cell_size, cp: int):
    """[cp, 3] cell centres origin + (cell + 0.5) * h; rows past the
    C real cells repeat the last cell's centre."""
    Gx, Gy, Gz = dims
    C = Gx * Gy * Gz
    lin = torch.arange(cp, dtype=torch.int32, device=origin.device)
    linc = torch.clamp(lin, max=C - 1)
    ccz = (linc % Gz).float()
    ccy = ((linc // Gz) % Gy).float()
    ccx = (linc // (Gz * Gy)).float()
    c = torch.stack([ccx, ccy, ccz], -1) + 0.5
    return origin + c * cell_size


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _pack_channel_list(est: int, coords, attrs_rolled, cell_size):
    """Estimator-specific 16-bit fields: list of (values [C, L], lo,
    hi), lo/hi python floats or 0-d f32 tensors (cell-relative)."""
    cx, cy, cz = coords
    pr = 1.6 * cell_size   # |centered coord| bound (cell + half-diag)
    dr = 3.0 * cell_size   # |re-centered plane offset| bound
    if est == EST_PT2PT:
        return [(cx, -pr, pr), (cy, -pr, pr), (cz, -pr, pr),
                (torch.zeros_like(cx), -1.0, 1.0)]
    if est == EST_PT2PL:
        n0, n1, n2, d = attrs_rolled[:4]
        return [(n0, -1.0, 1.0), (n1, -1.0, 1.0), (n2, -1.0, 1.0),
                (d, -dr, dr)]
    if est == EST_SYM:
        n0, n1, n2 = attrs_rolled[:3]
        return [(cx, -pr, pr), (cy, -pr, pr), (cz, -pr, pr),
                (n0, -1.0, 1.0), (n1, -1.0, 1.0), (n2, -1.0, 1.0)]
    return []


def _q16(v, lo, hi):
    s = 65535.0 / (hi - lo)
    return torch.clamp(torch.round((v - lo) * s), 0.0,
                       65535.0).to(torch.int32)


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())


def build_rungrid_arrays(points, attrs, origin, cell_size,
                         dims: Tuple[int, int, int], cap: int, nch: int,
                         est: int = EST_NONE, mask=None,
                         kc: Optional[int] = None):
    """Bin targets once, assemble each cell's 27-run neighbourhood as
    rolls, fold per-run centre offsets into the coordinates, quantize
    the estimator's fetch channels to 16-bit pairs, sort each row's
    lanes by distance to the cell centre, and record per-window
    pruning bounds. Returns (cand, attrp, negidx, bounds, pack_lohi).

    For EST_PT2PL, attrs is [N, 4] = (normal, d = n.p); d is
    re-centered per row (d_rel = d - n.row_center) so the centered
    residual n.q_centered - d_rel equals the world-frame n.q - d."""
    Gx, Gy, Gz = dims
    C = Gx * Gy * Gz
    dev = points.device
    key, lin = _cell_and_morton(points, origin, cell_size, dims, mask)
    linc = lin.clamp(0, C - 1).long()
    pc = points - cell_centers(dims, origin, cell_size, C)[linc]
    inf = float("inf")
    channels = [pc[:, 0], pc[:, 1], pc[:, 2]] + \
        [attrs[:, i] for i in range(nch)]
    binned, index, _ = _bin_to_slots(key, C, cap, channels,
                                     [inf] * 3 + [0.0] * nch)
    negidx0 = -index.float()  # exact for N < 2^24

    def rolled(arr2d):
        """27 runs in RUN_OFFSETS order: run r of cell c holds the
        contents of cell c+off_r (the +1 guard ring absorbs wraps)."""
        a = arr2d.reshape(Gx, Gy, Gz, cap)
        return torch.cat([torch.roll(a, (-dx, -dy, -dz), (0, 1, 2))
                          .reshape(C, cap) for (dx, dy, dz) in RUN_OFFSETS],
                         -1)

    lane_off = torch.tensor(RUN_OFFSETS, dtype=torch.float32,
                            device=dev).repeat_interleave(cap, 0)
    cx, cy, cz = (rolled(binned[i]) + lane_off[None, :, i] * cell_size
                  for i in range(3))
    ach = [rolled(binned[3 + i]) for i in range(nch)]
    negidx = rolled(negidx0)

    if est == EST_PT2PL:
        rcen = cell_centers(dims, origin, cell_size, C)
        ach[3] = ach[3] - (ach[0] * rcen[:, 0:1] + ach[1] * rcen[:, 1:2]
                           + ach[2] * rcen[:, 2:3])

    empty = ~torch.isfinite(cx)
    dist = torch.where(empty, inf, torch.sqrt(cx * cx + cy * cy + cz * cz))
    cx, cy, cz = (torch.where(empty, 0.0, v) for v in (cx, cy, cz))

    # 16-bit-pair attribute packing (winner-fetch operands)
    fields = _pack_channel_list(est, (cx, cy, cz), ach, cell_size)
    packed, lohi = [], []
    for i in range(0, len(fields), 2):
        (v0, lo0, hi0), (v1, lo1, hi1) = fields[i], fields[i + 1]
        packed.append(_q16(v0, lo0, hi0) | (_q16(v1, lo1, hi1) << 16))
        for lo, hi in ((lo0, hi0), (lo1, hi1)):
            lohi.append(torch.stack([_f32(lo, dev),
                                     _f32((hi - lo) / 65535.0, dev)]))
    P = len(packed)
    negidx = torch.where(empty, -float(INVALID_INDEX), negidx)

    # lane sort by distance to the row's cell centre: windows get rising
    # bounds and far / empty lanes can be truncated to the planned kc.
    # Stable, where the JAX package's sort is not: only equal distances
    # of real points may come out in another order.
    dist, order = torch.sort(dist, dim=1, stable=True)
    cx, cy, cz, negidx = (torch.gather(v, 1, order)
                          for v in (cx, cy, cz, negidx))
    packed = [torch.gather(v, 1, order) for v in packed]
    del order

    kc_full = _round_up(27 * cap, WINDOW)
    kc = kc_full if kc is None else min(int(kc), kc_full)
    L = dist.shape[1]
    if kc < L:
        dist, cx, cy, cz, negidx = (v[:, :kc] for v in
                                    (dist, cx, cy, cz, negidx))
        packed = [v[:, :kc] for v in packed]
    elif kc > L:
        padn = kc - L

        def pad(v, value):
            return torch.nn.functional.pad(v, (0, padn), value=value)
        dist = pad(dist, inf)
        cx, cy, cz = (pad(v, 0.0) for v in (cx, cy, cz))
        negidx = pad(negidx, -float(INVALID_INDEX))
        packed = [pad(v, 0) for v in packed]

    cn = torch.where(torch.isfinite(dist), dist * dist, BIG)
    bounds = dist.reshape(C, kc // WINDOW, WINDOW).min(-1).values
    cand = torch.stack([-2.0 * cx, -2.0 * cy, -2.0 * cz, cn], 1)
    attrp = torch.stack(packed, 1) if P else \
        torch.zeros((C, 0, kc), dtype=torch.int32, device=dev)
    pack_lohi = torch.stack(lohi, 0) if P else \
        torch.zeros((0, 2), dtype=torch.float32, device=dev)

    cp = padded_cells(dims)
    if cp > C:
        padc = cp - C
        cpad = torch.zeros((padc, 4, kc), dtype=torch.float32, device=dev)
        cpad[:, 3] = BIG
        cand = torch.cat([cand, cpad], 0)
        attrp = torch.cat([attrp, attrp.new_zeros((padc, P, kc))], 0)
        negidx = torch.cat([negidx, negidx.new_full(
            (padc, kc), -float(INVALID_INDEX))], 0)
        bounds = torch.cat([bounds, bounds.new_full(
            (padc, kc // WINDOW), inf)], 0)
    return (cand.contiguous(), attrp.contiguous(), negidx.contiguous(),
            bounds.contiguous(), pack_lohi)


def make_rungrid(points, attrs, origin, cell_size, dims, cap,
                 mask=None, est: int = EST_NONE,
                 kc: Optional[int] = None) -> RunGrid:
    """Build the grid on `points.device`."""
    dev = points.device
    origin = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    cell_size = torch.as_tensor(np.float32(cell_size), device=dev)
    dims = tuple(int(d) for d in dims)
    cand, attrp, negidx, bounds, pack_lohi = build_rungrid_arrays(
        points, attrs, origin, cell_size, dims, int(cap),
        int(attrs.shape[1]), est=int(est), mask=mask, kc=kc)
    return RunGrid(cand, attrp, negidx, bounds, pack_lohi, origin,
                   cell_size, dims, cap, cand.shape[2], est)


# ---------------------------------------------------------------------------
# query-side binning (queries keep ORIGINAL coords; binned by position
# under the binning transform)
# ---------------------------------------------------------------------------

def bin_queries(points, bin_positions, origin, cell_size,
                dims: Tuple[int, int, int], qcap: int,
                extra=None, n_extra: int = 0, mask=None):
    """Returns (qsoa [Cp, 3+n_extra, qcap] f32, qidx [Cp, qcap] int32).
    Empty slots: coords are the cell center (centered math sees ~0),
    qidx = -1."""
    C = dims[0] * dims[1] * dims[2]
    key, _ = _cell_and_morton(bin_positions, origin, cell_size, dims,
                              mask)
    channels = [points[:, 0], points[:, 1], points[:, 2]]
    channels += [extra[:, i] for i in range(n_extra)]
    inf = float("inf")
    binned, index, _ = _bin_to_slots(key, C, qcap, channels,
                                     [inf] * 3 + [0.0] * n_extra)
    centers = cell_centers(dims, origin, cell_size, C)
    empty = ~torch.isfinite(binned[0])
    qs = [torch.where(empty, centers[:, i:i + 1], binned[i])
          for i in range(3)]
    qsoa = torch.stack(qs + list(binned[3:]), 1)
    cp = padded_cells(dims)
    if cp > C:
        padc = torch.zeros((cp - C, 3 + n_extra, qcap), dtype=torch.float32,
                           device=qsoa.device)
        padc[:, :3] = origin.reshape(1, 3, 1)
        qsoa = torch.cat([qsoa, padc], 0)
        index = torch.cat([index, index.new_full((cp - C, qcap),
                                                 INVALID_INDEX)], 0)
    return qsoa.contiguous(), index.contiguous()


def scatter_to_source(qidx, values, n: int, fill):
    """[n, ...] per-source values from the binned `values` (qidx's
    [rows, qcap] slots, flat or not, then any trailing dims), with
    `qidx` the source index of each binned slot (-1 empty); sources no
    slot holds get `fill`."""
    flat_q = qidx.reshape(-1)
    trail = tuple(values.shape[qidx.dim():])
    okq = (flat_q >= 0).reshape((-1,) + (1,) * len(trail))
    slot = torch.where(flat_q >= 0, flat_q, n).long()  # n: dump, sliced off
    out = torch.full((n + 1,) + trail, fill, dtype=values.dtype,
                     device=values.device)
    out[slot] = torch.where(okq, values.reshape((-1,) + trail), fill)
    return out[:n]


def make_params(T, r2, grid: RunGrid, inv_2s2=0.0):
    """[NPARAMS] f32 on the grid's device: R row-major (0-8), t (9-11),
    r^2 (12), origin (13-15), cell_size (16), inv_2s2 (17), per-16-bit-
    field (lo, scale) unpack pairs (18..)."""
    dev = grid.cand.device
    T = torch.as_tensor(T, dtype=torch.float32).to(dev)
    head = torch.cat([
        T[:3, :3].reshape(-1), T[:3, 3],
        torch.as_tensor(r2, dtype=torch.float32).to(dev).reshape(1),
        grid.origin.reshape(3), grid.cell_size.reshape(1),
        torch.as_tensor(inv_2s2, dtype=torch.float32).to(dev).reshape(1),
        grid.pack_lohi.reshape(-1)])
    return torch.cat([head, head.new_zeros(NPARAMS - head.shape[0])])


# ---------------------------------------------------------------------------
# Gauss-Newton terms and the 16-bit unpack (shared by the plain version
# of the fused pass; the CUDA kernel computes the same terms)
# ---------------------------------------------------------------------------

def _gn_terms(est: int, fetched, tx, ty, tz, ex, ey, ez,
              ccx, ccy, ccz, src_n, ok, d2c):
    """Sum terms (length <= N_SUMS) given unpacked winner channels.

    tx.. = world-frame transformed source; ex.. = cell-centered same;
    ccx.. = cell centers; src_n = rotated source normals (sym only).
    Fetched channels: PT2PT/SYM lead with the CENTERED target point.
    """
    w = ok.float()
    if est == EST_PT2PT:
        px = fetched[0] + ccx
        py = fetched[1] + ccy
        pz = fetched[2] + ccz
        terms = [w, w * tx, w * ty, w * tz, w * px, w * py, w * pz]
        for s in (tx, ty, tz):
            for d in (px, py, pz):
                terms.append(w * s * d)
        terms.append(d2c)
        return terms
    if est == EST_PT2PL:
        nx, ny, nz, dd = fetched[:4]
        r = nx * ex + ny * ey + nz * ez - dd
        j = (ty * nz - tz * ny, tz * nx - tx * nz, tx * ny - ty * nx,
             nx, ny, nz)
    elif est == EST_SYM:
        pxc, pyc, pzc = fetched[0], fetched[1], fetched[2]
        px, py, pz = pxc + ccx, pyc + ccy, pzc + ccz
        sx, sy, sz = src_n
        mx = fetched[3] + sx
        my = fetched[4] + sy
        mz = fetched[5] + sz
        r = (ex - pxc) * mx + (ey - pyc) * my + (ez - pzc) * mz
        ux, uy, uz = tx + px, ty + py, tz + pz
        j = (uy * mz - uz * my, uz * mx - ux * mz, ux * my - uy * mx,
             mx, my, mz)
    else:
        raise ValueError(est)
    terms = []
    for i in range(6):
        for k in range(i, 6):
            terms.append(w * j[i] * j[k])          # 21 JTJ upper-tri
    for i in range(6):
        terms.append(w * j[i] * r)                 # 6 JTr
    terms.append(w)                                # 27: count
    terms.append(d2c)                              # 28: err
    return terms


def _unpack16(word, lo, scale, high: bool):
    u = (word >> 16) & 0xFFFF if high else word & 0xFFFF
    return u.float() * scale + lo


# ---------------------------------------------------------------------------
# k-NN over the run grid (cupoch's [Q, max_nn] contract: -1 / inf fill).
# None of this is a TPU kernel in the JAX package: it stays plain torch.
# ---------------------------------------------------------------------------

# bytes of one [cells, qcap, KC] f32 distance block `knn_rungrid` holds
_KNN_CHUNK_BYTES = 1 << 28


def knn_rungrid(grid: RunGrid, queries, k: int, qcap: int, radius,
                query_mask=None):
    """k nearest neighbours within `radius` (+inf: bounded only by the
    grid's coverage): (idx [Q, k] int32 sorted by distance, -1 fill;
    d2 [Q, k], +inf fill). k = 1 is a masked argmin that keeps the
    first lane of a tie; k > 1 takes `torch.topk` over the lanes, whose
    order among equal distances may differ from the JAX package's.

    Exact when the k-th neighbour lies in the 27-cell neighbourhood and
    no cell overflowed its cap; `knn_search_grid` sizes the grid so."""
    Q = queries.shape[0]
    KC = grid.kc
    if k > KC:
        idx, d2 = knn_rungrid(grid, queries, KC, qcap, radius,
                              query_mask=query_mask)
        return (torch.nn.functional.pad(idx, (0, k - KC),
                                        value=INVALID_INDEX),
                torch.nn.functional.pad(d2, (0, k - KC),
                                        value=float("inf")))
    dev = queries.device
    qsoa, qidx = bin_queries(queries, queries, grid.origin, grid.cell_size,
                             grid.dims, qcap, mask=query_mask)
    cp = qsoa.shape[0]
    r2 = torch.as_tensor(radius, dtype=torch.float32).to(dev) ** 2
    centers = cell_centers(grid.dims, grid.origin, grid.cell_size, cp)
    # only the cells that hold a query (a surface leaves most empty)
    busy = torch.nonzero((qidx >= 0).any(-1))[:, 0]
    nb = busy.shape[0]
    d2_out = torch.empty((nb, qcap, k), dtype=torch.float32, device=dev)
    idx_out = torch.empty((nb, qcap, k), dtype=torch.int32, device=dev)
    step = max(1, _KNN_CHUNK_BYTES // (qcap * KC * 4))
    for c0 in range(0, nb, step):
        sl = slice(c0, c0 + step)
        rows = busy[sl]
        c, ni, qi = grid.cand[rows], grid.negidx[rows], qidx[rows]
        e = qsoa[rows, 0:3] - centers[rows, :, None]
        qn = (e * e).sum(1)
        d2a = c[:, 3, None, :] + e[:, 0, :, None] * c[:, 0, None, :]
        d2a = d2a + e[:, 1, :, None] * c[:, 1, None, :]
        d2a = d2a + e[:, 2, :, None] * c[:, 2, None, :]
        d2a = d2a + qn[:, :, None]                       # [n, qcap, KC]
        valid = (qi[:, :, None] >= 0) & (d2a <= r2) \
            & (ni[:, None, :] <= 0.0)
        dm = torch.where(valid, d2a, float("inf"))
        del d2a, valid
        if k == 1:
            dk, lanes = dm.min(-1, keepdim=True)
        else:
            dk, lanes = torch.topk(dm, k, dim=-1, largest=False,
                                   sorted=True)
        del dm
        fik = torch.gather(ni[:, None, :].expand(-1, qcap, -1), -1, lanes)
        ok = torch.isfinite(dk)
        d2_out[sl] = torch.where(ok, dk.clamp(min=0.0), float("inf"))
        idx_out[sl] = torch.where(ok, -fik, float(INVALID_INDEX)) \
            .to(torch.int32)
    qb = qidx[busy]
    return (scatter_to_source(qb, idx_out, Q, INVALID_INDEX),
            scatter_to_source(qb, d2_out, Q, float("inf")))


# the bytes the cached grids may hold together; past it the oldest go
# first (a grid larger than it alone is not kept)
_GRID_CACHE_BYTES = 1 << 30
_grid_cache: dict = {}  # content key -> (grid, qcap, cell size)
# what the cache did since `reset_grid_cache_stats`: reused grids, the
# most grids stored after a grid that was then reused (a cap of N grids
# would have kept it if fewer than N), grids stored, evicted and refused
# (each over the budget alone), the most grids and bytes held at once
# and the largest grid offered
grid_cache_stats: dict = {}


def _data_key(data_np, data_mask, device) -> tuple:
    """Content key of a cloud for grid reuse: a hash of the WHOLE point
    buffer and mask (the JAX package samples 64 rows, so a cloud edited
    elsewhere reuses a stale grid there), with the shape and device."""
    h = hashlib.blake2b(np.ascontiguousarray(data_np, np.float32).tobytes(),
                        digest_size=16)
    if data_mask is not None:
        h.update(np.ascontiguousarray(data_mask, bool).tobytes())
    return (data_np.shape, str(device), h.hexdigest())


def clear_grid_cache():
    _grid_cache.clear()


def reset_grid_cache_stats():
    grid_cache_stats.update(hits=0, oldest_hit=0, stored=0, evicted=0,
                            refused=0, max_grids=0, max_bytes=0,
                            max_grid_bytes=0)


reset_grid_cache_stats()


def _cache_grid(key, entry) -> None:
    """Keep `entry` under `key` as the newest grid, evicting the oldest
    while the grids' bytes exceed `_GRID_CACHE_BYTES`; a grid over the
    budget alone is not kept and evicts nothing."""
    s = grid_cache_stats
    nbytes = entry[0].nbytes
    s["max_grid_bytes"] = max(s["max_grid_bytes"], nbytes)
    _grid_cache.pop(key, None)
    if nbytes > _GRID_CACHE_BYTES:
        s["refused"] += 1
        return
    _grid_cache[key] = entry
    held = sum(e[0].nbytes for e in _grid_cache.values())
    while held > _GRID_CACHE_BYTES:
        held -= _grid_cache.pop(next(iter(_grid_cache)))[0].nbytes
        s["evicted"] += 1
    s["stored"] += 1
    s["max_grids"] = max(s["max_grids"], len(_grid_cache))
    s["max_bytes"] = max(s["max_bytes"], held)


def knn_search_grid(queries_np, data_np, k: int,
                    radius: Optional[float] = None, data_mask=None,
                    max_retries: int = 3, queries_dev=None, data_dev=None):
    """Exact grid k-NN with density-based cell sizing and a growth
    retry: the cell is sized so about 2k points fall in a ball of its
    radius, every query must find k in-coverage neighbours (or, with a
    `radius`, the cell must cover it), and the grid regrows 1.7x when
    not. A content-keyed cache (grids of at most `_GRID_CACHE_BYTES`
    together) reuses a built grid on the same cloud; its result is accepted only under the same test. Returns
    (idx [Q, k] int32, d2 [Q, k]) on the device of `data_dev` (the CPU
    when not given), or None when no dense grid suits the cloud (the
    caller falls back). `queries_np` is read only without `queries_dev`;
    the plan runs where `data_dev` lives, and the host copy `data_np`
    keys the cache and gives the density.

    The plan and the density see only the rows `data_mask` keeps. The
    JAX package plans over every row, so the zero rows that pad a cloud
    to its bucket size pile into one cell at the origin, push the cap
    past its limit and send every padded search above 20k points (all
    of `estimate_normals`) to brute force."""
    data_np = np.asarray(data_np)
    n = data_np.shape[0]
    keep = np.isfinite(data_np).all(-1)
    if data_mask is not None:
        keep &= torch.as_tensor(data_mask).cpu().numpy().astype(bool)
    if not keep.any():
        return None
    kept = data_np[keep]
    r_cap = float(radius) if radius is not None else np.inf
    kneed = min(k, kept.shape[0])
    data_j = data_dev if data_dev is not None \
        else torch.as_tensor(data_np, dtype=torch.float32)
    dev = data_j.device
    q_j = queries_dev if queries_dev is not None else torch.as_tensor(
        np.asarray(queries_np), dtype=torch.float32, device=dev)
    mask_j = None
    keep_j = torch.isfinite(data_j).all(-1)
    if data_mask is not None:
        mask_j = torch.as_tensor(data_mask).to(dev)
        data_mask = mask_j.cpu().numpy()
        keep_j = keep_j & mask_j.bool()
    # the plan sees the kept rows: the others are made non-finite
    plan_pts = torch.where(keep_j[:, None], data_j, float("nan"))

    def found(idx):
        return (idx >= 0).sum(-1)

    def accept(idx, r_eff):
        if radius is not None and r_eff >= r_cap:
            # hybrid semantics: short lists are legal once the cell
            # covers the whole search radius
            return True
        return bool((found(idx) >= kneed).all())

    key = _data_key(data_np, data_mask, dev)
    cached = _grid_cache.get(key)
    if cached is not None:
        grid, qcap, cell = cached
        idx, d2 = knn_rungrid(grid, q_j, k, qcap, np.float32(min(cell, r_cap)))
        # the cached qcap was sized for another query set: a query its
        # pools dropped (an all-empty row) forces a fresh build
        if bool((found(idx) >= min(kneed, 1)).all()) and accept(idx, cell):
            s = grid_cache_stats
            s["hits"] += 1
            s["oldest_hit"] = max(s["oldest_hit"], len(_grid_cache) - 1
                                  - list(_grid_cache).index(key))
            return idx, d2

    lo, hi = kept.min(0), kept.max(0)
    vol = float(np.prod(np.maximum(hi - lo, 1e-9)))
    density = max(kept.shape[0] / max(vol, 1e-12), 1e-12)
    # radius of a ball expected to hold about 2k points
    r_est = (2.0 * max(k, 1) / (density * 4.19)) ** (1.0 / 3.0)
    if radius is not None:
        r_est = min(r_est, float(radius))
    attrs0 = data_j.new_zeros((n, 0))
    for _ in range(max_retries):
        plan = plan_rungrid(plan_pts, r_est, margin=0.0,
                            query_points=q_j, cap_percentile=100.0,
                            cap_limit=256)
        if plan is None:
            return None
        grid = make_rungrid(data_j, attrs0, plan["origin"],
                            plan["cell_size"], plan["dims"], plan["cap"],
                            mask=mask_j)
        idx, d2 = knn_rungrid(grid, q_j, k, plan["qcap"],
                              np.float32(min(r_est, r_cap)))
        if accept(idx, r_est):
            _cache_grid(key, (grid, plan["qcap"], float(plan["cell_size"])))
            return idx, d2
        r_est *= 1.7
    return None
