"""Work a correspondence kernel's launch has to do, counted from its
inputs alone: each target point and normal and each query read once,
one int32 written a query, and a squared distance (3 differences, 3
products, 2 sums) for every target point within the threshold of a
query."""
from __future__ import annotations

from ..reference import grid_nn

FLOPS_PER_PAIR = 8


def correspondence_work(queries, targets, threshold) -> dict:
    pairs = int(grid_nn.count_within(grid_nn.Grid(targets, threshold),
                                     queries).sum())
    n, m = queries.shape[0], targets.shape[0]
    return {"bytes": m * 24 + n * 12 + n * 4,
            "ops": pairs * FLOPS_PER_PAIR, "pairs": pairs}
