"""Dense room fragments for scan registration, made on the device.

The room is the scene of the port's global-registration check (a room
corner in metres: a floor over [0,4]^2, a wavy wall 1.5 m high and six
objects that float above the floor), copied here so the benchmark owns
it. A fragment is `n` points sampled on its surfaces in proportion to
their areas, with their analytic normals, Gaussian noise on each
coordinate and a share of uniform outliers in the room's box. The
number of points on each surface is fixed by the areas alone, so every
seed and every frame holds the same number of points.
"""
from __future__ import annotations

import math

import torch

OBJECTS = (
    ("box", (0.8, 0.8, 0.30), (0.40, 0.30, 0.25)),
    ("box", (2.0, 0.9, 0.40), (0.60, 0.20, 0.35)),
    ("box", (3.2, 1.0, 0.45), (0.25, 0.25, 0.50)),
    ("sphere", (0.9, 2.4, 0.45), 0.25),
    ("cylinder", (2.1, 2.4, 0.45), (0.15, 0.50)),
    ("box", (3.2, 2.5, 0.40), (0.50, 0.40, 0.15)),
)
WALL_HEIGHT = 1.5
ROOM_BOX = (4.0, 4.0, WALL_HEIGHT)
CENTRE = (2.0, 2.0, 0.5)


def _wall_y(x):
    return 3.9 + 0.08 * torch.sin(2.5 * x)


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _parts():
    """[(area, sampler)]: a sampler maps (rand, m) to (points [m, 3],
    normals [m, 3]) in float64, where rand(shape) draws uniform [0, 1)."""
    def floor(rand, m):
        u = rand((m, 2)) * 4.0
        p = torch.cat([u, torch.zeros_like(u[:, :1])], 1)
        n = torch.zeros_like(p)
        n[:, 2] = 1.0
        return p, n

    def wall(rand, m):
        u = rand((m, 2))
        x = u[:, 0] * 4.0
        p = torch.stack([x, _wall_y(x), u[:, 1] * WALL_HEIGHT], 1)
        n = torch.stack([-0.2 * torch.cos(2.5 * x), torch.ones_like(x),
                         torch.zeros_like(x)], 1)
        return p, _unit(n)

    def face(c, e, axis, sign):
        def sample(rand, m):
            p = (rand((m, 3)) - 0.5) * torch.tensor(e, dtype=torch.float64,
                                                     device=_dev(rand))
            p[:, axis] = sign * e[axis] / 2
            n = torch.zeros_like(p)
            n[:, axis] = sign
            return p + torch.tensor(c, dtype=torch.float64,
                                    device=p.device), n
        others = [e[a] for a in range(3) if a != axis]
        return others[0] * others[1], sample

    def sphere(c, r):
        def sample(rand, m):
            # uniform on the sphere: z uniform in [-1, 1], angle uniform
            u = rand((m, 2))
            z = 2.0 * u[:, 0] - 1.0
            a = 2.0 * math.pi * u[:, 1]
            s = torch.sqrt((1.0 - z * z).clamp(min=0.0))
            n = torch.stack([s * torch.cos(a), s * torch.sin(a), z], 1)
            return torch.tensor(c, dtype=torch.float64,
                                device=n.device) + r * n, n
        return 4.0 * math.pi * r * r, sample

    def cyl_side(c, r, h):
        def sample(rand, m):
            u = rand((m, 2))
            a = 2.0 * math.pi * u[:, 0]
            n = torch.stack([torch.cos(a), torch.sin(a),
                             torch.zeros_like(a)], 1)
            p = r * n
            p[:, 2] = (u[:, 1] - 0.5) * h
            return p + torch.tensor(c, dtype=torch.float64,
                                    device=p.device), n
        return 2.0 * math.pi * r * h, sample

    def cyl_cap(c, r, h, sign):
        def sample(rand, m):
            u = rand((m, 2))
            a = 2.0 * math.pi * u[:, 0]
            rad = r * torch.sqrt(u[:, 1])
            p = torch.stack([rad * torch.cos(a), rad * torch.sin(a),
                             torch.full_like(a, sign * h / 2)], 1)
            n = torch.zeros_like(p)
            n[:, 2] = sign
            return p + torch.tensor(c, dtype=torch.float64,
                                    device=p.device), n
        return math.pi * r * r, sample

    parts = [(16.0, floor), (4.04 * WALL_HEIGHT, wall)]
    for kind, c, size in OBJECTS:
        if kind == "box":
            parts += [face(c, size, a, s) for a in range(3) for s in (-1, 1)]
        elif kind == "sphere":
            parts.append(sphere(c, size))
        else:
            r, h = size
            parts += [cyl_side(c, r, h), cyl_cap(c, r, h, -1),
                      cyl_cap(c, r, h, 1)]
    return parts


def _dev(rand):
    return rand.device


def part_counts(n: int, outlier_share: float):
    """Points a surface gets of `n` (largest remainders; outliers
    last): the same for every seed and frame."""
    parts = _parts()
    n_out = int(round(outlier_share * n))
    areas = [a for a, _ in parts]
    total = sum(areas)
    exact = [(n - n_out) * a / total for a in areas]
    counts = [int(math.floor(x)) for x in exact]
    short = (n - n_out) - sum(counts)
    order = sorted(range(len(exact)), key=lambda i: counts[i] - exact[i])
    for i in order[:short]:
        counts[i] += 1
    return counts + [n_out]


def fragment(gen: torch.Generator, n: int, noise: float,
             outlier_share: float):
    """(points [n, 3], normals [n, 3]) float64 on the generator's
    device: one noisy sample of the room with analytic normals (a
    random unit normal on each outlier), in a random order."""
    dev = gen.device

    def rand(shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64,
                          device=dev)
    rand.device = dev
    counts = part_counts(n, outlier_share)
    pts, nrm = [], []
    for (_, sample), m in zip(_parts(), counts[:-1]):
        p, q = sample(rand, m)
        pts.append(p)
        nrm.append(q)
    n_out = counts[-1]
    pts.append(rand((n_out, 3)) * torch.tensor(ROOM_BOX, dtype=torch.float64,
                                               device=dev))
    nrm.append(_unit(torch.randn((n_out, 3), generator=gen,
                                 dtype=torch.float64, device=dev)))
    p = torch.cat(pts)
    p = p + noise * torch.randn(p.shape, generator=gen, dtype=torch.float64,
                                device=dev)
    order = torch.randperm(n, generator=gen, device=dev)
    return p[order], torch.cat(nrm)[order]


# steps of two low-discrepancy sequences: any run of consecutive frames
# gets sizes of motion spread evenly over [0, 1), whatever the offset
GOLDEN = 0.6180339887498949
SILVER = 0.4142135623730951


def motion_sizes(offset, k: int):
    """(turn, shift) fractions of frame k for a seed's offsets."""
    return ((offset[0] + k * GOLDEN) % 1.0, (offset[1] + k * SILVER) % 1.0)


def random_motion(gen: torch.Generator, max_deg: float, max_shift: float,
                  sizes):
    """A rigid motion [4, 4] float64 on the generator's device: a turn
    of sizes[0] * `max_deg` about a random axis through the room's
    centre and a shift of sizes[1] * `max_shift` in a random
    direction."""
    dev = gen.device
    u = torch.tensor(sizes, dtype=torch.float64, device=dev)
    axes = _unit(torch.randn((2, 3), generator=gen, dtype=torch.float64,
                             device=dev))
    ang = math.radians(max_deg) * u[0]
    k = axes[0]
    K = torch.zeros((3, 3), dtype=torch.float64, device=dev)
    K[0, 1], K[0, 2], K[1, 2] = -k[2], k[1], -k[0]
    K = K - K.T
    R = torch.eye(3, dtype=torch.float64, device=dev) + torch.sin(ang) * K \
        + (1.0 - torch.cos(ang)) * (K @ K)
    c = torch.tensor(CENTRE, dtype=torch.float64, device=dev)
    M = torch.eye(4, dtype=torch.float64, device=dev)
    M[:3, :3] = R
    M[:3, 3] = c - R @ c + max_shift * u[1] * axes[1]
    return M
