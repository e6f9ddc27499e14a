"""Constants shared by the grid searches.

Only the constants that the pooled grid (`poolgrid.py`) uses are here
so far: the 27 neighbour offsets, the estimator codes and the layout
of the Gauss-Newton sums. The run-structured grid itself is not
ported yet.
"""
from __future__ import annotations

INVALID_INDEX = -1
WINDOW = 128  # candidate lanes are padded to a multiple of this

# 27 neighbor offsets in ascending center-to-center distance:
# own cell, 6 faces, 12 edges, 8 corners.
RUN_OFFSETS = tuple(sorted(
    ((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)),
    key=lambda o: (o[0] * o[0] + o[1] * o[1] + o[2] * o[2],) + o))

# estimator codes; values match
# registration.estimation.TransformationEstimationType where relevant
EST_NONE = 0    # correspondence only
EST_PT2PT = 1
EST_PT2PL = 2
EST_SYM = 3

N_SUMS = 32
# GN slot layout: 0-20 JTJ upper-tri, 21-26 JTr, 27 count, 28 err
# PT2PT layout:   0 count, 1-3 sum(t), 4-6 sum(p), 7-15 sum(t p^T),
#                 16 err
