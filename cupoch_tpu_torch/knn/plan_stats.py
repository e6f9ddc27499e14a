"""Occupancy statistics of a cloud for the k-NN grids' plans, computed
on the cloud's device.

The four planners (`poolgrid.plan_poolgrid`, `rungrid.plan_rungrid`,
`rollgrid.plan_rollgrid`, `cellgrid.plan_cellgrid`) size a grid from a
few numbers of the cloud: its finite bounds, then per-cell counts and
order statistics of the occupied ones. They compute them with torch
where the points live and read back only those numbers, through
`trace.to_host`: the bounds in one read (`bounds`), everything else the
plan needs in one more (`read`), each a few hundred bytes. No shape
depends on the data before a read, and nothing else waits on the
device: no boolean-mask indexing, no `.item()`, no host-to-device copy.

The arithmetic is numpy's, so the plans equal the reference's field by
field: float64 cell ids (`floor_div`), integer counts (exact in any
order), and `np.percentile`'s linear interpolation applied on the host
(`percentile`) to the two order statistics around its index
(`order_stats`). On the CPU the order statistics sort only the occupied
cells (`ascending`), as numpy's percentile over them does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utility import trace


def as_points(points) -> torch.Tensor:
    """`points` as a tensor: a tensor as it is, an array as a CPU tensor
    of its dtype (sharing its memory)."""
    return points if torch.is_tensor(points) else torch.as_tensor(
        np.asarray(points))


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of `like`'s dtype and device holding `x` (a fill, not
    a host-to-device copy)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def bounds(points: torch.Tensor):
    """The first read of a plan: (finite [N] bool on the device, lo [3]
    float64 on the device, number of finite rows, lo and hi as float64
    numpy [3]). lo and hi are the finite rows' min and max in the
    points' dtype, cast to float64."""
    finite = torch.isfinite(points).all(-1)
    if points.shape[0] == 0:
        return finite, None, 0, None, None
    f = finite[:, None]
    lo = torch.where(f, points, float("inf")).amin(0).double()
    hi = torch.where(f, points, float("-inf")).amax(0).double()
    host = read([finite.sum(), lo, hi])
    return finite, lo, int(host[0]), np.array(host[1:4]), np.array(host[4:7])


def core_dims(lo, hi, cell: float) -> np.ndarray:
    """Cells a side covering [lo, hi] (at least one), as the reference
    sizes them."""
    return np.maximum(1, np.ceil((hi - lo) / cell + 1e-6).astype(int))


def core_counts(points, finite, lo, cell: float, dims) -> torch.Tensor:
    """[prod(dims)] int32 finite points a cell of the grid `dims` from
    `lo` (float64, on the device) with edge `cell`; cell ids in float64,
    clipped into the grid."""
    cells = floor_div(points.double(), lo, cell)
    return counts(cell_ids(cells, finite, dims, clip=True),
                  int(np.prod(dims)))


def floor_div(points, origin, cell: float) -> torch.Tensor:
    """floor((points - origin) / cell) in the dtype numpy computes it in:
    the promoted dtype of `points` and `origin` (tensors), `cell` rounded
    to it. The divisor is a device scalar: the card divides by a host
    scalar through its reciprocal."""
    d = points - origin
    return torch.floor(d / scalar(cell, d))


def cell_ids(cells, ok, dims, clip: bool) -> torch.Tensor:
    """Linear ids in the grid `dims` of integer-valued float cell
    coordinates `cells` [N, 3]. With `clip` each coordinate is clipped
    into the grid; without, rows outside it are left out. Rows left out
    or not `ok` get the id prod(dims), one past the grid."""
    dims = [int(d) for d in dims]
    c = torch.where(ok[:, None], cells, 0.0)
    if clip:
        cols = [c[:, a].clamp(0, d - 1) for a, d in enumerate(dims)]
    else:
        for a, d in enumerate(dims):
            ok = ok & (c[:, a] >= 0) & (c[:, a] < d)
        cols = [c[:, a] for a in range(3)]
    x, y, z = (v.long() for v in cols)
    lin = (x * dims[1] + y) * dims[2] + z
    return torch.where(ok, lin, dims[0] * dims[1] * dims[2])


def counts(ids, n: int) -> torch.Tensor:
    """[n] int32 number of `ids` equal to each of 0..n-1 (ids == n are
    left out)."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=ids.device)
    out.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    return out[:n]


def dilate27(occ) -> torch.Tensor:
    """The union of a 3-D bool grid's 27 shifts within its bounds: each
    cell set when a cell of its 3x3x3 block is (three 1-D dilations; the
    cube is separable)."""
    for ax in range(3):
        n = occ.shape[ax]
        grown = occ.clone()
        grown.narrow(ax, 0, n - 1).logical_or_(occ.narrow(ax, 1, n - 1))
        grown.narrow(ax, 1, n - 1).logical_or_(occ.narrow(ax, 0, n - 1))
        occ = grown
    return occ


def set_ids(act, rank, n: int, fill: int) -> torch.Tensor:
    """[n] int32: the ids of the set entries of the flat bool `act` in
    order (`rank`, their running count less one, places them), `fill`
    past them; n is at least their number, read beforehand."""
    out = torch.full((n + 1,), fill, dtype=torch.int32, device=act.device)
    return out.scatter_(0, torch.where(act, rank, n), torch.arange(
        act.numel(), dtype=torch.int32, device=act.device))[:-1]


def box27(grid) -> torch.Tensor:
    """27-block sums of a 3-D count grid, two larger on each axis:
    out[i] = sum of grid[i - d] over d in {0, 1, 2}^3 (separable)."""
    for ax in range(3):
        n = grid.shape[ax]
        shape = list(grid.shape)
        shape[ax] += 2
        acc = grid.new_zeros(shape)
        for d in range(3):
            acc.narrow(ax, d, n).add_(grid)
        grid = acc
    return grid


def ascending(values) -> torch.Tensor:
    """`values` (non-negative) flattened and sorted: on the card zeros
    and all, so that no shape waits on the data; on the CPU, which has
    nothing to wait for, the positive ones behind a single zero, which
    spares sorting the empty cells."""
    v = values.reshape(-1)
    if v.device.type == "cpu":
        v = torch.cat([v.new_zeros(1), v[v > 0]])
    return v.sort().values


def order_stats(s, qs) -> torch.Tensor:
    """Of the positive entries of `s` (non-negative, `ascending`): their
    count, then for each percentile of `qs` the two order statistics
    around the index `np.percentile` interpolates at; [1 + 2 len(qs)]
    float64 on the device. Indexed past the zeros, so no shape depends
    on the data."""
    n_pos = (s > 0).sum()
    last = (n_pos - 1).clamp(min=0)
    idx = []
    for q in qs:
        v = (n_pos - 1).double() * (q / 100.0)
        above = v >= (n_pos - 1).double()
        prev = torch.where(above, last, v.floor().long().clamp(min=0))
        idx += [prev, torch.where(above, last, prev + 1)]
    i = (s.numel() - n_pos + torch.stack(idx)).clamp(0, s.numel() - 1)
    return torch.cat([n_pos.double()[None], s.index_select(0, i).double()])


def percentile(n: int, a: float, b: float, q: float) -> float:
    """`np.percentile(x, q)` of the n positive values x from the two
    order statistics a <= b that `order_stats` took: numpy's index and
    its linear interpolation, in float64."""
    v = (n - 1) * (q / 100.0)
    t = v - math.floor(v)
    d = b - a
    return b - d * (1 - t) if t >= 0.5 else a + d * t


def read(parts) -> list:
    """One blocking read of the device tensors `parts`, as float64 (exact
    for the counts, which stay below 2^53): a list of Python floats."""
    flat = torch.cat([p.double().reshape(-1) for p in parts])
    return trace.to_host(flat).tolist()
