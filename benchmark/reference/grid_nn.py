"""Exact neighbour search within a radius, in plain PyTorch.

The target points are sorted into cubic cells of the search radius; a
query's candidates are the points of the 27 cells around its own, and
every candidate's squared distance is computed from the coordinate
differences, each product and sum rounded on its own. The nearest
neighbour is the least (distance, index) pair, so ties go to the
smallest index. Queries are taken in chunks whose candidate pairs fit a
fixed budget, so the search runs at any size on any device.
"""
from __future__ import annotations

import torch

PAIR_BUDGET = 1 << 25          # candidate pairs held at once
FINE = 4                       # fine cells a radius in the first pass
_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1)]


class Grid:
    def __init__(self, points: torch.Tensor, radius: float):
        self.points = points
        self.radius = float(radius)
        dev = points.device
        self.origin = points.min(0).values.double() - self.radius
        cells = self._cells(points)
        self.dims = cells.max(0).values + 2
        key = self._key(cells)
        order = torch.argsort(key, stable=True)
        self.order = order
        self.sorted_points = points[order]
        self.keys, self.counts = torch.unique_consecutive(
            key[order], return_counts=True)
        self.starts = torch.cumsum(self.counts, 0) - self.counts
        self.offsets = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)

    def _cells(self, p):
        return torch.floor((p.double() - self.origin)
                           / self.radius).to(torch.int64)

    def _key(self, cells):
        d = self.dims
        return (cells[:, 0] * d[1] + cells[:, 1]) * d[2] + cells[:, 2]

    def _cell_runs(self, queries):
        """(start [Q, 27], count [Q, 27]) of the sorted points in each
        cell around each query; 0 points where the cell is empty or
        outside the grid."""
        c = self._cells(queries)[:, None, :] + self.offsets[None]
        inside = ((c >= 0) & (c < self.dims)).all(-1)
        key = self._key(c.reshape(-1, 3)).reshape(c.shape[:2])
        pos = torch.searchsorted(self.keys, key.clamp(min=0))
        pos = pos.clamp(max=self.keys.numel() - 1)
        hit = inside & (self.keys[pos] == key)
        count = torch.where(hit, self.counts[pos], 0)
        return self.starts[pos], count

    def pairs(self, queries):
        """Yield (q0, qi, ti, d2) chunk by chunk: candidate pairs of
        queries[q0:...] (qi relative to q0, ti an index into the
        original points) with their squared distances."""
        start, count = self._cell_runs(queries)
        per_q = count.sum(1)
        cum = torch.cumsum(per_q, 0)
        n = queries.shape[0]
        q0 = 0
        while q0 < n:
            base = int(cum[q0 - 1]) if q0 else 0
            q1 = int(torch.searchsorted(cum, base + PAIR_BUDGET,
                                        right=True))
            q1 = min(max(q1, q0 + 1), n)
            cnt = count[q0:q1].reshape(-1)
            st = start[q0:q1].reshape(-1)
            total = int(cnt.sum())
            run = torch.repeat_interleave(
                torch.arange(cnt.numel(), device=cnt.device), cnt)
            first = torch.cumsum(cnt, 0) - cnt
            within = torch.arange(total, device=cnt.device) - first[run]
            si = st[run] + within
            qi = run // 27
            d = queries[q0:q1][qi] - self.sorted_points[si]
            d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
            d2 = d2 + d[:, 2] * d[:, 2]
            yield q0, qi, self.order[si], d2
            q0 = q1


def _packed(d2, idx):
    """One int64 key a pair that orders by (distance, index): the bits
    of a non-negative float32 order as its value does."""
    return (d2.to(torch.float32).view(torch.int32).to(torch.int64) << 32) \
        | idx.to(torch.int64)


_NONE = torch.iinfo(torch.int64).max


def _best(grid: Grid, queries, r2):
    """[Q] packed (distance, index) of each query's nearest candidate
    within sqrt(r2) among its 27 cells; _NONE where there is none."""
    best = torch.full((queries.shape[0],), _NONE, dtype=torch.int64,
                      device=queries.device)
    for q0, qi, ti, d2 in grid.pairs(queries):
        ok = d2.to(torch.float32) <= r2
        best.scatter_reduce_(0, q0 + qi[ok], _packed(d2[ok], ti[ok]),
                             "amin")
    return best


def _unpack(best):
    found = best != _NONE
    idx = torch.where(found, best & 0xFFFFFFFF, -1)
    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    return idx, torch.where(found, d2, float("inf"))


class NearestIndex:
    """Exact nearest neighbour within `radius` in two passes: a fine
    grid of cells `radius / FINE` settles every query whose nearest
    candidate among its 27 fine cells lies within one fine cell (no
    point outside those cells is nearer); the rest search the grid of
    cells `radius`. On dense surfaces the first pass settles nearly
    every query from a small share of the candidates."""

    def __init__(self, points, radius: float):
        self.points = points
        self.radius = float(radius)
        self.fine = Grid(points, radius / FINE)
        self._coarse = None

    @property
    def coarse(self):
        if self._coarse is None:
            self._coarse = Grid(self.points, self.radius)
        return self._coarse

    def nearest(self, queries):
        r2 = self.radius ** 2
        best = _best(self.fine, queries, min(r2, self.fine.radius ** 2))
        left = torch.nonzero(best == _NONE).reshape(-1)
        if left.numel():
            best[left] = _best(self.coarse, queries[left], r2)
        return _unpack(best)


def count_within(grid: Grid, queries, radius=None):
    """[Q] number of points within the radius of each query."""
    r2 = float(grid.radius if radius is None else radius) ** 2
    out = torch.zeros(queries.shape[0], dtype=torch.int64,
                      device=queries.device)
    for q0, qi, _, d2 in grid.pairs(queries):
        out.index_add_(0, q0 + qi, (d2.to(torch.float32) <= r2).long())
    return out
