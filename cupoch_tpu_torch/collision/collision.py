"""Pairwise intersection of voxel grids, occupancy grids, line sets and
primitives (cupoch collision/collision.{h,cu}).

The broad phase is a dense all-pairs AABB test, tiled over the first
set's rows so no [N, M] matrix is ever whole; each tile's `nonzero`,
concatenated, gives the row-major order of the whole matrix's. Above
_DENSE_LIMIT pairs, two voxel sets go through a bucket broad phase
instead: the second set's boxes binned by centre into a uniform grid
whose cell exceeds the boxes' reach (and grows until the grid holds at
most _BUCKET_GRID_CELLS cells, where the JAX package takes the dense
phase instead), each first-set box tested against
its cell's 27-neighbourhood (the LBVH's role in the reference,
collision.cu:21-22), with up to _MAX_PAIRS_PER_QUERY hits a box and the
overflowing boxes counted as dropped. The narrow phases (segment/box
slabs, primitive inside tests) run on the same device.
"""
from __future__ import annotations

import enum
from typing import List, Tuple

import numpy as np
import torch

from ..geometry.image_ops import _f32
from ..geometry.intersection_test import line_segment_aabb
from ..geometry.lineset import LineSet
from ..geometry.occupancygrid import OccupancyGrid
from ..geometry.voxelgrid import VoxelGrid
from ..knn.rungrid import _bin_to_slots
from ..utility import console
from .primitives import Primitive

_DENSE_LIMIT = 16_000_000     # N * M above this: the bucket broad phase
_MAX_PAIRS_PER_QUERY = 32
# elements of one [rows, M] tile of a dense pair test
_TILE_ELEMS = 1 << 24
# cells of the bucket grid at most
_BUCKET_GRID_CELLS = 4_000_000
# elements of one [cells, query slots, lanes] block of the bucket test
_BUCKET_ELEMS = 1 << 25

RUN_OFFSETS_ = tuple(sorted(
    ((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)),
    key=lambda o: (o[0] * o[0] + o[1] * o[1] + o[2] * o[2],) + o))


class CollisionType(enum.IntEnum):
    # values match collision.h:40-46
    Unspecified = 0
    Primitives = 1
    VoxelGrid = 2
    OccupancyGrid = 3
    LineSet = 4


class CollisionResult:
    """collision.h:39-66. `collision_index_pairs` is an [K, 2] int32
    tensor on the device the test ran on; `route` says which broad
    phase ran ("dense" or "bucket") and `n_dropped` how many boxes the
    bucket phase dropped."""

    def __init__(self, first=CollisionType.Unspecified,
                 second=CollisionType.Unspecified, index_pairs=None):
        self.first = first
        self.second = second
        self.collision_index_pairs = (
            torch.zeros((0, 2), dtype=torch.int32) if index_pairs is None
            else index_pairs.to(torch.int32))
        self.route = "dense"
        self.n_dropped = 0

    def is_collided(self) -> bool:
        return self.collision_index_pairs.shape[0] > 0

    def get_collision_index_pairs(self) -> torch.Tensor:
        return self.collision_index_pairs

    def get_first_collision_indices(self) -> torch.Tensor:
        return torch.unique(self.collision_index_pairs[:, 0])

    def get_second_collision_indices(self) -> torch.Tensor:
        return torch.unique(self.collision_index_pairs[:, 1])

    def __repr__(self):
        return (f"CollisionResult ({self.first.name} vs {self.second.name}) "
                f"with {int(self.collision_index_pairs.shape[0])} pairs "
                f"({self.route} broad phase).")


# ---------------------------------------------------------------------------
# dense pair tests, tiled over the first set's rows
# ---------------------------------------------------------------------------

def _tiled_pairs(n: int, m: int, test, device) -> torch.Tensor:
    """[K, 2] int32 (row, column) of the true cells of the [n, m] matrix
    `test(rows)` gives a row slice of, in row-major order."""
    tile = max(1, _TILE_ELEMS // max(m, 1))
    parts = []
    for s in range(0, n, tile):
        hit = test(slice(s, min(s + tile, n)))
        nz = torch.nonzero(hit).to(torch.int32)
        nz[:, 0] += s
        parts.append(nz)
    if not parts:
        return torch.zeros((0, 2), dtype=torch.int32, device=device)
    return torch.cat(parts, 0)


def aabb_overlap_pairs(lo1, hi1, lo2, hi2, margin: float) -> torch.Tensor:
    """Pairs (i, j) of margin-inflated overlapping boxes of two AABB
    sets."""
    m = _f32(margin, lo1.device)
    hi2m = hi2 + m
    hi1m = hi1 + m

    def test(rows):
        ok = None
        for k in range(3):
            t = (lo1[rows, k, None] <= hi2m[None, :, k]) \
                & (lo2[None, :, k] <= hi1m[rows, k, None])
            ok = t if ok is None else ok & t
        return ok

    return _tiled_pairs(lo1.shape[0], lo2.shape[0], test, lo1.device)


def segment_box_pairs(lo, hi, p0, p1, margin: float) -> torch.Tensor:
    """Pairs (box, segment) of margin-inflated boxes crossed by
    segments p0-p1."""
    m = _f32(margin, lo.device)
    lom = lo - m
    him = hi + m

    def test(rows):
        return line_segment_aabb(p0[None], p1[None], lom[rows, None],
                                 him[rows, None])

    return _tiled_pairs(lo.shape[0], p0.shape[0], test, lo.device)


# ---------------------------------------------------------------------------
# bucket broad phase
# ---------------------------------------------------------------------------

def _slot_cap(counts: torch.Tensor) -> int:
    """Slots a cell: the 99.9th percentile of the non-empty cells'
    counts, rounded up to a multiple of 8, at least 8."""
    c = counts[counts > 0].cpu().numpy()
    if not len(c):
        return 8
    return max(8, -(-int(np.percentile(c, 99.9)) // 8) * 8)


def bucket_overlap_pairs(lo1, hi1, lo2, hi2, margin: float,
                         max_pairs: int = _MAX_PAIRS_PER_QUERY
                         ) -> Tuple[torch.Tensor, int]:
    """Scalable AABB-set overlap: (pairs [K, 2] int32, boxes dropped).
    The cell is the largest box extent plus the margin, grown by a
    quarter at a time while the grid would exceed _BUCKET_GRID_CELLS
    cells. A cell holds the 99.9th percentile of the cells' box counts;
    the boxes past that are dropped and counted. Up to `max_pairs` hits a
    first-set box, the first in lane order."""
    dev = lo1.device
    c1 = (lo1 + hi1) * 0.5
    c2 = (lo2 + hi2) * 0.5
    e1 = float((hi1 - lo1).amax()) if lo1.shape[0] else 0.0
    e2 = float((hi2 - lo2).amax()) if lo2.shape[0] else 0.0
    h = (e1 + e2) * 0.5 + float(margin) + 1e-6
    cmin = np.minimum(c1.amin(0).cpu().numpy(), c2.amin(0).cpu().numpy())
    cmax = np.maximum(c1.amax(0).cpu().numpy(), c2.amax(0).cpu().numpy())
    while True:
        gmin = cmin - 2 * h
        dims = np.maximum(np.ceil((cmax + 2 * h - gmin) / h).astype(int)
                          + 1, 1)
        C = int(np.prod(dims))
        if C <= _BUCKET_GRID_CELLS:
            break
        h *= 1.25
    Gx, Gy, Gz = (int(d) for d in dims)
    gmin_t = torch.as_tensor(gmin, device=dev)
    h_t = _f32(h, dev)

    def lin_cells(c):
        ci = torch.floor((c - gmin_t) / h_t).long()
        return (ci[:, 0] * Gy + ci[:, 1]) * Gz + ci[:, 2]

    def binned(lo, hi):
        lin = lin_cells((lo + hi) * 0.5)
        cap = _slot_cap(torch.bincount(lin, minlength=C))
        chans = [lo[:, k].contiguous() for k in range(3)] \
            + [hi[:, k].contiguous() for k in range(3)]
        fills = [float("inf")] * 3 + [float("-inf")] * 3
        outs, index, dropped = _bin_to_slots(
            (lin * 64).to(torch.int32), C, cap, chans, fills)
        return outs, index, int(dropped), cap

    b2, index2, drop2, cap = binned(lo2, hi2)
    b1, index1, drop1, qcap = binned(lo1, hi1)
    KC = 27 * cap
    k = min(max_pairs, KC)
    m = _f32(margin, dev)
    lane_score = (KC - torch.arange(KC, device=dev)).to(torch.float32)
    offs = torch.tensor(RUN_OFFSETS_, device=dev)
    # only the cells that hold a first-set box make pairs, in cell order
    cells = torch.nonzero((index1 >= 0).any(1))[:, 0]
    block = max(1, _BUCKET_ELEMS // (qcap * KC))
    pairs = []
    for s in range(0, cells.shape[0], block):
        cell = cells[s:s + block]
        cx, cy, cz = cell // (Gy * Gz), (cell // Gz) % Gy, cell % Gz
        nb = ((((cx[:, None] + offs[:, 0]) % Gx) * Gy
               + (cy[:, None] + offs[:, 1]) % Gy) * Gz
              + (cz[:, None] + offs[:, 2]) % Gz)             # [T, 27]

        def lanes(a):
            return a[nb].reshape(cell.shape[0], KC)

        ci = lanes(index2)
        qi = index1[cell]
        hit = (qi[:, :, None] >= 0) & (ci[:, None, :] >= 0)
        for kk in range(3):
            clo, chi = lanes(b2[kk]), lanes(b2[3 + kk])
            qlo, qhi = b1[kk][cell], b1[3 + kk][cell]
            hit = hit & (qlo[:, :, None] <= chi[:, None, :] + m) \
                & (clo[:, None, :] <= qhi[:, :, None] + m)
        score = hit.to(torch.float32) * lane_score
        vals, top = torch.topk(score, k, -1)
        got = vals > 0.0
        hidx = torch.gather(ci[:, None, :].expand(-1, qcap, -1), -1, top)
        q = qi[:, :, None].expand_as(hidx)
        pairs.append(torch.stack([q[got], hidx[got]], -1))
    out = torch.cat(pairs, 0) if pairs else torch.zeros(
        (0, 2), dtype=torch.int32, device=dev)
    return out.to(torch.int32), drop1 + drop2


# ---------------------------------------------------------------------------
# boxes of the containers
# ---------------------------------------------------------------------------

def _voxel_aabbs(vg: VoxelGrid):
    lo = vg._origin_t() + vg.voxels_keys.to(torch.float32) * vg.voxel_size
    return lo, lo + vg.voxel_size


def _occ_aabbs(og: OccupancyGrid):
    idx, _, _ = og.extract_occupied_voxels()
    lo = og._origin_t() + (idx.to(torch.float32) - og.resolution // 2) \
        * og.voxel_size
    return lo, lo + og.voxel_size, idx


def _flat_occ_index(og: OccupancyGrid, idx: torch.Tensor) -> torch.Tensor:
    R = og.resolution
    return (idx[:, 0] * R + idx[:, 1]) * R + idx[:, 2]


def _result(first, second, pairs, swap: bool) -> CollisionResult:
    if swap:
        return CollisionResult(second, first, pairs.flip(1))
    return CollisionResult(first, second, pairs)


def _box_sets(lo1, hi1, lo2, hi2, margin: float):
    """(pairs, route, dropped): the bucket phase above _DENSE_LIMIT
    pairs, else the dense one."""
    n, m = int(lo1.shape[0]), int(lo2.shape[0])
    if n * m > _DENSE_LIMIT:
        pairs, dropped = bucket_overlap_pairs(lo1, hi1, lo2, hi2, margin)
        if dropped:
            console.log_warning(
                "[ComputeIntersection] bucket broad phase dropped "
                f"{dropped} overflowing boxes")
        console.log_debug("[ComputeIntersection] %d x %d boxes: bucket "
                          "broad phase, %d dropped", n, m, dropped)
        return pairs, "bucket", dropped
    console.log_debug("[ComputeIntersection] %d x %d boxes: dense broad "
                      "phase", n, m)
    return aabb_overlap_pairs(lo1, hi1, lo2, hi2, margin), "dense", 0


# ---------------------------------------------------------------------------
# typed intersections (the 12 ComputeIntersection overloads,
# collision.h:88-143)
# ---------------------------------------------------------------------------

def _voxel_voxel(vg1: VoxelGrid, vg2: VoxelGrid, margin: float):
    lo1, hi1 = _voxel_aabbs(vg1)
    lo2, hi2 = _voxel_aabbs(vg2)
    pairs, route, dropped = _box_sets(lo1, hi1, lo2, hi2, margin)
    res = CollisionResult(CollisionType.VoxelGrid, CollisionType.VoxelGrid,
                          pairs)
    res.route, res.n_dropped = route, dropped
    return res


def _segments(ls: LineSet):
    li = ls.lines.long()
    return ls.points[li[:, 0]], ls.points[li[:, 1]]


def _voxel_lineset(vg: VoxelGrid, ls: LineSet, margin: float, swap: bool):
    lo, hi = _voxel_aabbs(vg)
    pairs = segment_box_pairs(lo, hi, *_segments(ls), margin)
    return _result(CollisionType.VoxelGrid, CollisionType.LineSet, pairs,
                   swap)


def _occgrid_lineset(og: OccupancyGrid, ls: LineSet, margin: float,
                     swap: bool):
    lo, hi, idx = _occ_aabbs(og)
    pairs = segment_box_pairs(lo, hi, *_segments(ls), margin)
    pairs[:, 0] = _flat_occ_index(og, idx)[pairs[:, 0].long()]
    return _result(CollisionType.OccupancyGrid, CollisionType.LineSet,
                   pairs, swap)


def _voxel_occgrid(vg: VoxelGrid, og: OccupancyGrid, margin: float,
                   swap: bool):
    lo1, hi1 = _voxel_aabbs(vg)
    lo2, hi2, idx = _occ_aabbs(og)
    pairs, route, dropped = _box_sets(lo1, hi1, lo2, hi2, margin)
    pairs[:, 1] = _flat_occ_index(og, idx)[pairs[:, 1].long()]
    res = _result(CollisionType.VoxelGrid, CollisionType.OccupancyGrid,
                  pairs, swap)
    res.route, res.n_dropped = route, dropped
    return res


def _prims_vs_centres(prims: List[Primitive], centers: torch.Tensor,
                      inflate, labels: torch.Tensor) -> torch.Tensor:
    """(primitive, label) pairs of the centres inside each inflated
    primitive, primitive by primitive."""
    parts = [torch.zeros((0, 2), dtype=torch.int32, device=centers.device)]
    for i, p in enumerate(prims):
        hit = torch.nonzero(p._contains(centers, margin=inflate))[:, 0]
        parts.append(torch.stack([torch.full_like(hit, i), labels[hit]],
                                 -1).to(torch.int32))
    return torch.cat(parts, 0)


def _primitives_voxels(prims: List[Primitive], vg: VoxelGrid, margin: float,
                       swap: bool):
    """Primitive against voxel centre, the primitive inflated by the
    margin and half a voxel's diagonal (conservative like the
    reference's per-type functors, collision.cu:36-201)."""
    centers = vg.get_voxel_centers()
    inflate = margin + vg.voxel_size * np.sqrt(3.0) / 2.0
    labels = torch.arange(len(vg), device=vg.device)
    return _result(CollisionType.Primitives, CollisionType.VoxelGrid,
                   _prims_vs_centres(prims, centers, inflate, labels), swap)


def _primitives_occgrid(prims: List[Primitive], og: OccupancyGrid,
                        margin: float, swap: bool):
    idx, _, _ = og.extract_occupied_voxels()
    inflate = margin + og.voxel_size * np.sqrt(3.0) / 2.0
    return _result(CollisionType.Primitives, CollisionType.OccupancyGrid,
                   _prims_vs_centres(prims, og.voxel_centers(idx), inflate,
                                     _flat_occ_index(og, idx)), swap)


def _primitives_primitives(p1: List[Primitive], p2: List[Primitive],
                           margin: float):
    dev = p1[0].device

    def bounds(prims):
        b = [p._aabb_bounds() for p in prims]
        return [torch.as_tensor(np.stack([x[k] for x in b]).astype(
            np.float32), device=dev) for k in (0, 1)]

    pairs = aabb_overlap_pairs(*bounds(p1), *bounds(p2), margin)
    return CollisionResult(CollisionType.Primitives, CollisionType.Primitives,
                           pairs)


def compute_intersection(obj1, obj2, margin: float = 0.0) -> CollisionResult:
    """Type-dispatching intersection (the ComputeIntersection overload
    set, collision.h:88-143); the pairs index obj1's elements first."""
    def is_prims(o):
        return (isinstance(o, Primitive)
                or (isinstance(o, (list, tuple)) and len(o) > 0
                    and all(isinstance(p, Primitive) for p in o)))

    def as_prims(o):
        return [o] if isinstance(o, Primitive) else list(o)

    if isinstance(obj1, VoxelGrid) and isinstance(obj2, VoxelGrid):
        return _voxel_voxel(obj1, obj2, margin)
    if isinstance(obj1, VoxelGrid) and isinstance(obj2, LineSet):
        return _voxel_lineset(obj1, obj2, margin, swap=False)
    if isinstance(obj1, LineSet) and isinstance(obj2, VoxelGrid):
        return _voxel_lineset(obj2, obj1, margin, swap=True)
    if isinstance(obj1, VoxelGrid) and isinstance(obj2, OccupancyGrid):
        return _voxel_occgrid(obj1, obj2, margin, swap=False)
    if isinstance(obj1, OccupancyGrid) and isinstance(obj2, VoxelGrid):
        return _voxel_occgrid(obj2, obj1, margin, swap=True)
    if isinstance(obj1, OccupancyGrid) and isinstance(obj2, LineSet):
        return _occgrid_lineset(obj1, obj2, margin, swap=False)
    if isinstance(obj1, LineSet) and isinstance(obj2, OccupancyGrid):
        return _occgrid_lineset(obj2, obj1, margin, swap=True)
    if is_prims(obj1) and isinstance(obj2, VoxelGrid):
        return _primitives_voxels(as_prims(obj1), obj2, margin, swap=False)
    if isinstance(obj1, VoxelGrid) and is_prims(obj2):
        return _primitives_voxels(as_prims(obj2), obj1, margin, swap=True)
    if is_prims(obj1) and isinstance(obj2, OccupancyGrid):
        return _primitives_occgrid(as_prims(obj1), obj2, margin, swap=False)
    if isinstance(obj1, OccupancyGrid) and is_prims(obj2):
        return _primitives_occgrid(as_prims(obj2), obj1, margin, swap=True)
    if is_prims(obj1) and is_prims(obj2):
        return _primitives_primitives(as_prims(obj1), as_prims(obj2), margin)
    console.log_error("[ComputeIntersection] unsupported type pair "
                      f"({type(obj1).__name__}, {type(obj2).__name__}).")
