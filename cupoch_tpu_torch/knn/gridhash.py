"""Voxel hash-grid neighbour search (counterpart of the JAX package's
`knn/gridhash.py`): the last-resort backend for targets that no dense
grid plan accepts. The search is exact: every point within the radius
is a candidate, and neighbours are ordered by (squared distance,
index), so ties go to the smaller index.

build:  levels of cubic cells cell_size / 2^j, j = 0 .. J; at each, a
        spatial hash of the points' cells, a stable sort of the point
        indices by hash and per-bucket (start, count) tables. J is the
        first level whose mean bucket load, as a point sees it, is at
        most `LEVEL_LOAD` (one read at the build).
query:  a query's candidates at a level are all the points of the
        buckets of the 27 cells around its own, a bucket probed twice
        read once; the (query, candidate) pairs are made in chunks of
        about `PAIR_BUDGET`. 1-NN and k-NN start at the finest level.
        A query whose k-th nearest candidate lies within one cell is
        settled, since every point outside its 27 cells is farther;
        the others (`gridhash.rescued`) search the next coarser level,
        up to level 0, whose 27 cells hold the whole radius. Radius
        counts read level 0.

Hash collisions only add candidates from other cells, which the
distance test filters. Cells are taken in float64, so a cell's
membership is exact to 2^-52 of the coordinate; the settling test
keeps a margin of 2^-16 of a cell, well above the float32 rounding of
the squared distances.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utility import trace
from ..utility.shape import INVALID_INDEX
from .rollgrid import OFFSETS

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # spatial-hash primes
#: (query, candidate) pairs made at once
PAIR_BUDGET = 1 << 24
#: the finest level's mean bucket load (points a point shares its
#: bucket with, itself included) at most
LEVEL_LOAD = 8.0
#: levels at most: cells down to cell_size / 2^(MAX_LEVELS - 1)
MAX_LEVELS = 6
_SETTLE = 1.0 - 2.0 ** -16
_NONE = torch.iinfo(torch.int64).max
_offsets_on: dict = {}


class HashLevel:
    """One level: cell (float), order [N] int32 (point indices sorted
    by bucket), start / count [T] int32 per bucket."""

    __slots__ = ("cell", "order", "start", "count")

    def __init__(self, cell, order, start, count):
        self.cell, self.order, self.start, self.count = \
            cell, order, start, count


class HashGrid:
    """Built search structure: points [N, 3], cell_size (float),
    table_size T, and `levels` (`HashLevel`, the coarsest first).
    `sorted_indices`, `bucket_start` and `bucket_count` are level 0's
    tables, whose cells are cell_size."""

    def __init__(self, points, cell_size: float, table_size: int, levels):
        self.points = points
        self.cell_size = float(cell_size)
        self.table_size = int(table_size)
        self.levels = levels

    @property
    def sorted_indices(self):
        return self.levels[0].order

    @property
    def bucket_start(self):
        return self.levels[0].start

    @property
    def bucket_count(self):
        return self.levels[0].count


def _cell_hash(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    """The int32 hash of the reference, computed in int64: its low bits
    equal those of the wrapping int32 products and xors."""
    c = cells.long()
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return h & (table_size - 1)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _cells(points, cell: float) -> torch.Tensor:
    return torch.floor(points.double() / cell).long()


def _offsets(dev) -> torch.Tensor:
    """The 27 cell offsets [27, 3] int64 on `dev`, made once a device
    (a host-to-device copy waits for the stream)."""
    t = _offsets_on.get(dev)
    if t is None:
        t = _offsets_on[dev] = torch.tensor(OFFSETS, dtype=torch.int64,
                                            device=dev)
    return t


def build_grid(points: torch.Tensor, cell_size,
               mask: Optional[torch.Tensor] = None,
               table_size: int = 0) -> HashGrid:
    """Hash grid over [N, 3] points on their device (masked rows are
    parked in an overflow bucket no query probes)."""
    N = points.shape[0]
    if table_size == 0:
        table_size = max(64, _next_pow2(2 * N))
    T = table_size
    cell = float(cell_size)
    hashes, counts = [], []
    for j in range(MAX_LEVELS):
        h = _cell_hash(_cells(points, cell / 2 ** j), T)
        if mask is not None:
            h = torch.where(mask, h, T)
        hashes.append(h)
        counts.append(torch.bincount(h, minlength=T + 1)[:T])
    # mean load a level, as a point sees it: sum of count^2 / points
    loads = trace.to_host(torch.stack(
        [c.double().square().sum() for c in counts]
        + [counts[0].sum().double()]))
    n = max(float(loads[-1]), 1.0)
    loads = [float(x) / n for x in loads[:-1]]
    fine = next((j for j, x in enumerate(loads) if x <= LEVEL_LOAD),
                min(range(MAX_LEVELS), key=loads.__getitem__))
    levels = []
    for j in range(fine + 1):
        c = counts[j].to(torch.int32)
        levels.append(HashLevel(
            cell / 2 ** j, torch.argsort(hashes[j], stable=True)
            .to(torch.int32),
            torch.cumsum(c, 0, dtype=torch.int32) - c, c))
    return HashGrid(points, cell, T, levels)


def _runs(grid: HashGrid, level: HashLevel, q: torch.Tensor):
    """(start, count) [n, 27] int64 of the buckets of the 27 cells
    around each query; a bucket probed twice counts once."""
    h = _cell_hash(_cells(q, level.cell)[:, None, :] + _offsets(q.device),
                   grid.table_size)
    h = torch.sort(h, dim=1).values
    dup = torch.zeros_like(h, dtype=torch.bool)
    dup[:, 1:] = h[:, 1:] == h[:, :-1]
    count = torch.where(dup, 0, level.count[h].long())
    return level.start[h].long(), count


def _chunks(count: torch.Tensor):
    """[(a, b, pairs)]: ranges of queries holding about PAIR_BUDGET
    pairs each (one read of the total, one more of the ranges' ends
    past the budget)."""
    n = count.shape[0]
    cum = torch.cumsum(count.sum(1), 0)
    total = int(trace.to_host(cum[-1]))
    trace.count("gridhash.slots", total)
    if total <= PAIR_BUDGET:
        return [(0, n, total)]
    marks = torch.arange(1, -(-total // PAIR_BUDGET), device=cum.device,
                         dtype=torch.int64) * PAIR_BUDGET
    ends = torch.cat([torch.searchsorted(cum, marks, right=True),
                      torch.full((1,), n, device=cum.device,
                                 dtype=torch.int64)])
    got = trace.to_host(torch.stack(
        [ends, cum[(ends - 1).clamp(min=0)]])).tolist()
    out, a, done = [], 0, 0
    for e, c in zip(*got):
        if e > a:
            out.append((a, e, c - done))
            a, done = e, c
    return out


def _pairs(grid, level, q, start, count, P):
    """(qi, ti, d2) of the P pairs of the queries q with their bucket
    runs (start, count) [n, 27]: the query's row in q, the candidate's
    index into the points and their squared distance, each product
    and sum rounded on its own."""
    dev = q.device
    cnt = count.reshape(-1)
    run = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev),
                                  cnt, output_size=P)
    first = torch.cumsum(cnt, 0) - cnt
    si = start.reshape(-1)[run] + torch.arange(P, device=dev) - first[run]
    ti = level.order[si].long()
    qi = run // 27
    d = q[qi] - grid.points[ti]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
    return qi, ti, d2 + d[:, 2] * d[:, 2]


def _packed(d2, idx):
    """One int64 key a pair that orders by (distance, index): the bits
    of a non-negative float32 order as its value does."""
    return (d2.view(torch.int32).to(torch.int64) << 32) | idx


def _level_search(grid, level, q, r2, k: int) -> torch.Tensor:
    """[n, k] packed keys of each query's k nearest candidates within
    sqrt(r2) among its 27 cells at `level`, nearest first; _NONE
    fills."""
    dev = q.device
    n = q.shape[0]
    best = torch.full((n, k + (k > 1)), _NONE, dtype=torch.int64,
                      device=dev)
    if n == 0:
        return best[:, :k]
    start, count = _runs(grid, level, q)
    for a, b, P in _chunks(count):
        qi, ti, d2 = _pairs(grid, level, q[a:b], start[a:b], count[a:b], P)
        key = torch.where(d2 <= r2, _packed(d2, ti), _NONE)
        qi = qi + a
        if k == 1:
            best[:, 0].scatter_reduce_(0, qi, key, "amin")
            continue
        # pairs ordered by (query, key); each query's first k kept, the
        # rest written to a spare column
        o = torch.argsort(key, stable=True)
        o = o[torch.argsort(qi[o], stable=True)]
        qs = qi[o]
        per_q = count[a:b].sum(1)
        seg = torch.cumsum(per_q, 0) - per_q
        rank = torch.arange(P, device=dev) - seg[qs - a]
        best[qs, rank.clamp(max=k)] = key[o]
    return best[:, :k]


def _r2(radius, dev):
    return torch.as_tensor(radius, dtype=torch.float32).to(dev) ** 2


def _bits(x: float) -> int:
    return int(torch.tensor(x, dtype=torch.float32).view(torch.int32))


def _search(grid: HashGrid, queries: torch.Tensor, radius, k: int):
    """[Q, k] packed keys of each query's k nearest points within
    `radius`, from the finest level up (module docstring)."""
    if float(radius) > grid.cell_size:
        raise ValueError(f"radius {float(radius)} exceeds the grid's cell "
                         f"{grid.cell_size}: 27 cells would not hold it")
    dev = queries.device
    r2 = _r2(radius, dev)
    Q = queries.shape[0]
    trace.count("gridhash.queries", Q)
    best = None
    active = None
    for j in range(len(grid.levels) - 1, -1, -1):
        level = grid.levels[j]
        q = queries if active is None else queries[active]
        got = _level_search(grid, level, q, r2, k)
        if active is None:
            best = got
        else:
            best[active] = got
        if j == 0:
            break
        settled = (got[:, -1] >> 32) <= _bits((level.cell * _SETTLE) ** 2)
        left = int(trace.to_host((~settled).sum()))
        if active is None:
            trace.count("gridhash.rescued", left)
        if left == 0:
            break
        pick = torch.argsort(settled.to(torch.uint8), stable=True)[:left]
        active = pick if active is None else active[pick]
    return best


def _unpack(key):
    found = key != _NONE
    idx = torch.where(found, key & 0xFFFFFFFF, INVALID_INDEX) \
        .to(torch.int32)
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    return idx, torch.where(found, d2, float("inf"))


def query_nn(grid: HashGrid, queries: torch.Tensor, radius,
             query_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN within `radius` (at most the grid's cell): (index [Q] int32
    or -1, dist2 [Q], inf for none); ties go to the smaller index."""
    idx, d2 = _unpack(_search(grid, queries, radius, 1)[:, 0])
    if query_mask is not None:
        idx = torch.where(query_mask, idx, INVALID_INDEX)
        d2 = torch.where(query_mask, d2, float("inf"))
    return idx, d2


def query_hybrid(grid: HashGrid, queries: torch.Tensor, radius,
                 max_nn: int, query_mask: Optional[torch.Tensor] = None):
    """k-NN within radius (cupoch SearchHybrid): (idx [Q, max_nn] int32,
    dist2 [Q, max_nn], counts [Q] int32), sorted by (distance, index),
    -1 / inf fill."""
    idx, d2 = _unpack(_search(grid, queries, radius, max_nn))
    cnt = (idx >= 0).sum(-1).to(torch.int32)
    if query_mask is not None:
        idx = torch.where(query_mask[:, None], idx, INVALID_INDEX)
        d2 = torch.where(query_mask[:, None], d2, float("inf"))
        cnt = torch.where(query_mask, cnt, 0)
    return idx, d2, cnt


def query_radius_count(grid: HashGrid, queries: torch.Tensor, radius
                       ) -> torch.Tensor:
    """[Q] int32 number of points within `radius` (at most the grid's
    cell) of each query."""
    dev = queries.device
    r2 = _r2(radius, dev)
    Q = queries.shape[0]
    trace.count("gridhash.queries", Q)
    out = torch.zeros(Q, dtype=torch.int64, device=dev)
    if Q == 0:
        return out.to(torch.int32)
    level = grid.levels[0]
    start, count = _runs(grid, level, queries)
    for a, b, P in _chunks(count):
        qi, _, d2 = _pairs(grid, level, queries[a:b], start[a:b],
                           count[a:b], P)
        out.index_add_(0, qi + a, (d2 <= r2).long())
    return out.to(torch.int32)
