"""Marching-cubes case tables, derived programmatically.

cupoch ships the classic Lorensen/Cline lookup tables as header
constants (integration/marching_cubes_const.h).
Instead of transcribing them, this module *derives* an equivalent
triangulation table from first principles at import time:

for each of the 256 inside/outside corner configurations
  1. find cube edges with a sign change,
  2. on every cube face, pair cut edges so the arc of the face
     boundary between a pair contains only *inside* corners (this rule
     depends only on the face's own corner pattern, so the two cubes
     sharing a face always make the same choice -> watertight),
  3. chain the pairs into closed loops and fan-triangulate each loop,
     oriented so triangle normals point toward the *outside* region.

The derived table has the same contract as the canonical one: at most
5 triangles per case, each triangle a triple of cube-edge indices.
Convention ("inside" = bit set = tsdf < level) matches cupoch's
extractor (uniform_tsdfvolume.cu marching-cubes pass).

Cube corner / edge numbering (Bourke convention, as in cupoch):
corners 0..7 at (0,0,0),(1,0,0),(1,1,0),(0,1,0),(0,0,1),(1,0,1),
(1,1,1),(0,1,1); edge k connects EDGE_VERTS[k].
"""
from __future__ import annotations

import numpy as np

CORNERS = np.asarray([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
], np.int32)

EDGE_VERTS = np.asarray([
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
], np.int32)

# faces as CCW corner cycles viewed from OUTSIDE the cube
_FACES = [
    (0, 3, 2, 1),  # z = 0 (bottom, outward -z)
    (4, 5, 6, 7),  # z = 1 (top, outward +z)
    (0, 1, 5, 4),  # y = 0 (outward -y)
    (2, 3, 7, 6),  # y = 1 (outward +y)
    (1, 2, 6, 5),  # x = 1 (outward +x)
    (0, 4, 7, 3),  # x = 0 (outward -x)
]

_EDGE_OF = {}
for _k, (_a, _b) in enumerate(EDGE_VERTS):
    _EDGE_OF[(int(_a), int(_b))] = _k
    _EDGE_OF[(int(_b), int(_a))] = _k


def _face_pairs(case: int, face) -> list:
    """Pair cut edges on one face.

    Walk the CCW boundary; a cut edge is exited at an *outside* corner
    after an inside corner (or vice versa). Pair each cut edge whose
    following arc runs through inside corners with the next cut edge,
    directed so the inside region stays to the polygon's interior.
    Returns ordered (from_edge, to_edge) segments of the iso-polygon.
    """
    inside = [(case >> c) & 1 for c in range(8)]
    cuts = []
    n = len(face)
    for i in range(n):
        a, b = face[i], face[(i + 1) % n]
        if inside[a] != inside[b]:
            cuts.append((i, _EDGE_OF[(a, b)]))
    if not cuts:
        return []
    pairs = []
    # Walking CCW (outside view): segment goes from the edge where we
    # LEAVE the inside region to the edge where we ENTER it; directed
    # this way successive polygon vertices keep inside on the left
    # when viewed from outside -> consistent orientation.
    for j, (i, e) in enumerate(cuts):
        a = face[i]
        if inside[a]:  # leaving inside region at this cut
            nxt = cuts[(j + 1) % len(cuts)]
            pairs.append((e, nxt[1]))
    return pairs


def _case_triangles(case: int) -> list:
    segs = []
    for f in _FACES:
        segs.extend(_face_pairs(case, f))
    tris = []
    # chain segments into loops
    seg_from = {}
    for a, b in segs:
        seg_from.setdefault(a, []).append(b)
    used = set()
    for a0 in list(seg_from):
        if a0 in used:
            continue
        loop = [a0]
        used.add(a0)
        cur = seg_from[a0][0]
        while cur != a0:
            loop.append(cur)
            used.add(cur)
            cur = seg_from[cur][0]
        if len(loop) >= 3:
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i + 1], loop[i]))
    return tris


def _build():
    tri_table = -np.ones((256, 16), np.int32)
    num_tris = np.zeros(256, np.int32)
    edge_table = np.zeros(256, np.int32)
    for case in range(256):
        tris = _case_triangles(case)
        num_tris[case] = len(tris)
        flat = [e for t in tris for e in t]
        tri_table[case, : len(flat)] = flat
        mask = 0
        for e in set(flat):
            mask |= 1 << e
        edge_table[case] = mask
    return tri_table, num_tris, edge_table


TRI_TABLE, NUM_TRIS, EDGE_TABLE = _build()
MAX_TRIS_PER_CELL = int(NUM_TRIS.max())  # == 5 like the canonical table
