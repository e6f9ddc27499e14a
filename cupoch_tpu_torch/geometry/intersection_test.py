"""Batched geometric intersection and distance tests (cupoch
geometry/intersection_test.{h,inl}, distance_test.inl): triangle/AABB
(separating axes), segment/AABB (slabs), triangle/triangle and the
point-to-segment and point-to-triangle squared distances.

Every function takes [..., 3] tensors that broadcast against each other
and returns the broadcast shape, on their device. The arithmetic is
written one elementwise operation at a time, so the card and the CPU
give the same bits.
"""
from __future__ import annotations

import torch


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _axis_test(a0, a1, c0, c1, ea, eb, fa, fb, h0, h1):
    """One cross-axis test of triangle_aabb: two vertices' projections
    (a, c) on the axis against the box radius."""
    p0 = ea * a0 + eb * a1
    p1 = ea * c0 + eb * c1
    lo = torch.minimum(p0, p1)
    hi = torch.maximum(p0, p1)
    rad = fa * h0 + fb * h1
    return (lo <= rad) & (hi >= -rad)


def triangle_aabb(box_center, box_half, v0, v1, v2):
    """Triangle/AABB overlap by the 13 separating axes (cupoch
    intersection_test.inl TriangleAABB)."""
    u0 = v0 - box_center
    u1 = v1 - box_center
    u2 = v2 - box_center
    e0 = u1 - u0
    e1 = u2 - u1
    e2 = u0 - u2
    h = box_half

    def cross_tests(e, a, c):
        fe = torch.abs(e)
        tx = _axis_test(a[..., 1], a[..., 2], c[..., 1], c[..., 2],
                        e[..., 2], -e[..., 1], fe[..., 2], fe[..., 1],
                        h[..., 1], h[..., 2])
        ty = _axis_test(a[..., 0], a[..., 2], c[..., 0], c[..., 2],
                        -e[..., 2], e[..., 0], fe[..., 2], fe[..., 0],
                        h[..., 0], h[..., 2])
        tz = _axis_test(a[..., 0], a[..., 1], c[..., 0], c[..., 1],
                        e[..., 1], -e[..., 0], fe[..., 1], fe[..., 0],
                        h[..., 0], h[..., 1])
        return tx & ty & tz

    ok = cross_tests(e0, u0, u2) & cross_tests(e1, u0, u2) \
        & cross_tests(e2, u0, u1)
    tri_min = torch.minimum(torch.minimum(u0, u1), u2)
    tri_max = torch.maximum(torch.maximum(u0, u1), u2)
    ok = ok & ((tri_min <= h) & (tri_max >= -h)).all(-1)
    n = _cross(e0, e1)
    d = -_dot(n, u0)
    r = _dot(torch.abs(n), h)
    return ok & (torch.abs(d) <= r)


def line_segment_aabb(p0, p1, box_min, box_max):
    """Segment/AABB overlap by the slab method (cupoch
    intersection_test.inl LineSegmentAABB)."""
    d = p1 - p0
    safe_d = torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    t0 = (box_min - p0) / safe_d
    t1 = (box_max - p0) / safe_d
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    par_ok = ((torch.abs(d) > 1e-20)
              | ((p0 >= box_min) & (p0 <= box_max))).all(-1)
    return (tmax >= tmin.clamp(min=0.0)) & (tmin <= 1.0) & par_ok


def tri_tri(p1, q1, r1, p2, q2, r2, eps: float = 1e-10):
    """Triangle/triangle overlap by the interval test on the planes'
    intersection line (cupoch intersection_test.inl TriangleTriangle)."""
    p1, q1, r1, p2, q2, r2 = torch.broadcast_tensors(p1, q1, r1, p2, q2, r2)

    def signed(a, b, c, d):
        s = _dot(_cross(b - a, c - a), d - a)
        # a vertex on the other plane would break the crossing-edge
        # choice below: it counts as just above (the coplanar branch
        # still sees |s| <= eps)
        return torch.where(s == 0.0, 1e-30, s)

    d_p2 = signed(p1, q1, r1, p2)
    d_q2 = signed(p1, q1, r1, q2)
    d_r2 = signed(p1, q1, r1, r2)
    same2 = ((d_p2 > eps) & (d_q2 > eps) & (d_r2 > eps)) | (
        (d_p2 < -eps) & (d_q2 < -eps) & (d_r2 < -eps))
    d_p1 = signed(p2, q2, r2, p1)
    d_q1 = signed(p2, q2, r2, q1)
    d_r1 = signed(p2, q2, r2, r1)
    same1 = ((d_p1 > eps) & (d_q1 > eps) & (d_r1 > eps)) | (
        (d_p1 < -eps) & (d_q1 < -eps) & (d_r1 < -eps))
    maybe = ~(same1 | same2)

    n1 = _cross(q1 - p1, r1 - p1)
    n2 = _cross(q2 - p2, r2 - p2)
    axis = torch.argmax(torch.abs(_cross(n1, n2)), -1, keepdim=True)

    def seg(a, b, da, db):
        den = da - db
        t = da / torch.where(torch.abs(den) < 1e-20, 1e-20, den)
        return a + t * (b - a)

    def interval(p, q, r, dp, dq, dr):
        pp = torch.gather(p, -1, axis)[..., 0]
        pq = torch.gather(q, -1, axis)[..., 0]
        pr = torch.gather(r, -1, axis)[..., 0]
        cross_pq = dp * dq < 0
        cross_pr = dp * dr < 0
        cross_qr = dq * dr < 0
        s_pq = seg(pp, pq, dp, dq)
        s_pr = seg(pp, pr, dp, dr)
        s_qr = seg(pq, pr, dq, dr)
        t1v = torch.where(cross_pq, s_pq, torch.where(cross_pr, s_pr, s_qr))
        t2v = torch.where(cross_qr, s_qr, torch.where(cross_pr, s_pr, s_pq))
        return torch.minimum(t1v, t2v), torch.maximum(t1v, t2v)

    a_lo, a_hi = interval(p1, q1, r1, d_p1, d_q1, d_r1)
    b_lo, b_hi = interval(p2, q2, r2, d_p2, d_q2, d_r2)
    overlap = (a_lo <= b_hi) & (b_lo <= a_hi)

    coplanar = (torch.abs(d_p1) <= eps) & (torch.abs(d_q1) <= eps) & (
        torch.abs(d_r1) <= eps)
    t1min = torch.minimum(torch.minimum(p1, q1), r1)
    t1max = torch.maximum(torch.maximum(p1, q1), r1)
    t2min = torch.minimum(torch.minimum(p2, q2), r2)
    t2max = torch.maximum(torch.maximum(p2, q2), r2)
    co_overlap = ((t1min <= t2max) & (t2min <= t1max)).all(-1)
    return maybe & torch.where(coplanar, co_overlap, overlap)


def point_segment_dist2(p, a, b):
    """Squared distance of p to the segment ab (cupoch distance_test.inl
    PointLineSegment)."""
    ab = b - a
    t = _dot(p - a, ab) / _dot(ab, ab).clamp(min=1e-20)
    t = t.clamp(0.0, 1.0)
    c = a + t[..., None] * ab
    e = p - c
    return _dot(e, e)


def point_triangle_dist2(p, a, b, c):
    """Squared distance of p to the triangle abc, region by region
    (cupoch distance_test.inl PointTriangle; Ericson, RTCD 5.1.5)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = (va + vb + vc).clamp(min=1e-20)
    v = vb / denom
    w = vc / denom
    closest = a + v[..., None] * ab + w[..., None] * ac
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    t_ab = torch.where(torch.abs(d1 - d3) > 1e-20,
                       d1 / (d1 - d3).clamp(min=1e-20), 0.0)
    t_ac = torch.where(torch.abs(d2 - d6) > 1e-20,
                       d2 / (d2 - d6).clamp(min=1e-20), 0.0)
    t_bc = (d4 - d3) / ((d4 - d3) + (d5 - d6)).clamp(min=1e-20)
    cand = closest
    cand = torch.where(on_bc[..., None], b + t_bc[..., None] * (c - b), cand)
    cand = torch.where(on_ac[..., None], a + t_ac[..., None] * ac, cand)
    cand = torch.where(on_ab[..., None], a + t_ab[..., None] * ab, cand)
    cand = torch.where(in_c[..., None], c, cand)
    cand = torch.where(in_b[..., None], b, cand)
    cand = torch.where(in_a[..., None], a, cand)
    e = p - cand
    return _dot(e, e)
