"""Voxel hash-grid neighbour search (counterpart of the JAX package's
`knn/gridhash.py`): the last-resort backend for targets that no dense
grid plan accepts.

build:  cell id per point -> spatial hash -> stable sort of the point
        indices by hash -> per-bucket (start, count) tables.
query:  probe the 27 neighbouring cells, take up to `bucket_cap`
        candidates from each bucket, compute true distances, mask and
        reduce (min for 1-NN, the k least for k-NN).

Hash collisions only add candidates from unrelated cells, which the
distance test filters; a bucket holding more than `bucket_cap` points
drops the rest, as in the reference. Queries run in tiles whose
[tile, 27 * cap] candidate block holds about `_BLOCK` slots (some 30
bytes a slot across its index, point, distance and mask tensors): few
enough launches on the card, a bounded block on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utility import trace
from ..utility.shape import INVALID_INDEX
from .rollgrid import OFFSETS

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # spatial-hash primes
_BLOCK = 1 << 25  # candidate slots of one query tile


class HashGrid:
    """Built search structure: points [N, 3] (padded), sorted_indices
    [N] (point order by bucket), bucket_start / bucket_count [T] int32,
    cell_size [] f32, table_size T and bucket_cap ints. A query takes
    `width` = min(bucket_cap, the fullest bucket's count) slots a
    bucket: the slots past every bucket's count hold no candidate, so
    a sparse table (a surface scan) scans fewer slots and finds the
    same candidates."""

    def __init__(self, points, sorted_indices, bucket_start, bucket_count,
                 cell_size, table_size: int, bucket_cap: int = 32):
        self.points = points
        self.sorted_indices = sorted_indices
        self.bucket_start = bucket_start
        self.bucket_count = bucket_count
        self.cell_size = cell_size
        self.table_size = int(table_size)
        self.bucket_cap = int(bucket_cap)
        fullest = int(trace.to_host(bucket_count.max())) \
            if bucket_count.numel() else 0
        self.width = max(1, min(self.bucket_cap, fullest))


def _cell_hash(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    """The int32 hash of the reference, computed in int64: its low bits
    equal those of the wrapping int32 products and xors."""
    c = cells.long()
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return (h & (table_size - 1)).to(torch.int32)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _cells(points, cell_size):
    return torch.floor(points / cell_size).to(torch.int32)


def build_grid(points: torch.Tensor, cell_size,
               mask: Optional[torch.Tensor] = None, table_size: int = 0,
               bucket_cap: int = 32) -> HashGrid:
    """Hash grid over [N, 3] points on their device (masked rows are
    parked in an overflow bucket no query probes)."""
    N = points.shape[0]
    dev = points.device
    if table_size == 0:
        table_size = max(64, _next_pow2(2 * N))
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32).to(dev)
    h = _cell_hash(_cells(points, cell_size), table_size)
    if mask is not None:
        h = torch.where(mask, h, table_size)
    order = torch.argsort(h, stable=True).to(torch.int32)
    counts = torch.bincount(h.long(), minlength=table_size + 1) \
        .to(torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return HashGrid(points, order, starts[:table_size],
                    counts[:table_size], cell_size, table_size, bucket_cap)


def _candidates_for(grid: HashGrid, q_tile: torch.Tensor):
    """(cand_idx [T, 27*width] int64, cand_valid [T, 27*width] bool) for
    a [T, 3] query tile."""
    cap = grid.width
    dev = q_tile.device
    offs = torch.tensor(OFFSETS, dtype=torch.int32, device=dev)
    nbr = _cells(q_tile, grid.cell_size)[:, None, :] + offs[None]
    hh = _cell_hash(nbr, grid.table_size).long()             # [T, 27]
    start = grid.bucket_start[hh]
    count = grid.bucket_count[hh]
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    slot = (start[..., None] + j).clamp(0, grid.sorted_indices.shape[0] - 1)
    valid = j < count[..., None]
    cand = grid.sorted_indices[slot.long()].long()           # [T, 27, cap]
    # two offsets hashing to one bucket would list its points twice:
    # keep the first offset of each bucket
    same = (hh[:, :, None] == hh[:, None, :]).to(torch.uint8)
    first = same.argmax(-1)
    is_first = first == torch.arange(27, device=dev)[None, :]
    valid = valid & is_first[..., None]
    T = q_tile.shape[0]
    return cand.reshape(T, 27 * cap), valid.reshape(T, 27 * cap)


def _tiles(grid: HashGrid, queries: torch.Tensor):
    """`queries` split into tiles of about `_BLOCK` candidate slots."""
    return queries.split(max(1024, _BLOCK // (27 * grid.width)))


def _tile_d2(grid: HashGrid, q_tile):
    cand, valid = _candidates_for(grid, q_tile)
    diff = q_tile[:, None, :] - grid.points[cand]
    d2 = (diff * diff).sum(-1)
    return cand, valid, d2


def _r2(radius, dev):
    return torch.as_tensor(radius, dtype=torch.float32).to(dev) ** 2


def query_nn(grid: HashGrid, queries: torch.Tensor, radius,
             query_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN within `radius`: (index [Q] int32 or -1, dist2 [Q], inf for
    none). Ties go to the first candidate in probe order."""
    r2 = _r2(radius, queries.device)
    idxs, d2s = [], []
    for q in _tiles(grid, queries):
        cand, valid, d2 = _tile_d2(grid, q)
        d2 = torch.where(valid & (d2 <= r2), d2, float("inf"))
        bd2, best = d2.min(-1)
        bidx = torch.gather(cand, 1, best[:, None])[:, 0]
        idxs.append(torch.where(torch.isfinite(bd2), bidx, INVALID_INDEX)
                    .to(torch.int32))
        d2s.append(bd2)
    idx, d2 = _cat(idxs, d2s, (0,), queries.device)
    if query_mask is not None:
        idx = torch.where(query_mask, idx, INVALID_INDEX)
        d2 = torch.where(query_mask, d2, float("inf"))
    return idx, d2


def _cat(idxs, d2s, shape, dev):
    if not idxs:
        return (torch.empty(shape, dtype=torch.int32, device=dev),
                torch.empty(shape, dtype=torch.float32, device=dev))
    return torch.cat(idxs), torch.cat(d2s)


def query_hybrid(grid: HashGrid, queries: torch.Tensor, radius,
                 max_nn: int, query_mask: Optional[torch.Tensor] = None):
    """k-NN within radius (cupoch SearchHybrid): (idx [Q, max_nn] int32,
    dist2 [Q, max_nn], counts [Q] int32), sorted by distance, -1 / inf
    fill."""
    dev = queries.device
    r2 = _r2(radius, dev)
    idxs, d2s = [], []
    for q in _tiles(grid, queries):
        cand, valid, d2 = _tile_d2(grid, q)
        d2 = torch.where(valid & (d2 <= r2), d2, float("inf"))
        k = min(max_nn, d2.shape[-1])
        kd2, pos = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        kidx = torch.gather(cand, 1, pos)
        kidx = torch.where(torch.isfinite(kd2), kidx, INVALID_INDEX) \
            .to(torch.int32)
        if k < max_nn:
            kidx = torch.nn.functional.pad(kidx, (0, max_nn - k),
                                           value=INVALID_INDEX)
            kd2 = torch.nn.functional.pad(kd2, (0, max_nn - k),
                                          value=float("inf"))
        idxs.append(kidx)
        d2s.append(kd2)
    idx, d2 = _cat(idxs, d2s, (0, max_nn), dev)
    cnt = (idx >= 0).sum(-1).to(torch.int32)
    if query_mask is not None:
        idx = torch.where(query_mask[:, None], idx, INVALID_INDEX)
        d2 = torch.where(query_mask[:, None], d2, float("inf"))
        cnt = torch.where(query_mask, cnt, 0)
    return idx, d2, cnt


def query_radius_count(grid: HashGrid, queries: torch.Tensor, radius
                       ) -> torch.Tensor:
    """[Q] int32 number of points within `radius` of each query."""
    r2 = _r2(radius, queries.device)
    out = [(valid & (d2 <= r2)).sum(-1).to(torch.int32)
           for _, valid, d2 in (_tile_d2(grid, q)
                                for q in _tiles(grid, queries))]
    return torch.cat(out) if out else torch.empty(
        (0,), dtype=torch.int32, device=queries.device)
