"""TriangleMesh primitive factories (cupoch
geometry/trianglemesh_factory.cu:391-900): the 14 Create* primitives
(tetrahedron, octahedron, icosahedron, box, sphere, half-sphere,
cylinder, tube, capsule, cone, torus, arrow, coordinate frame, Moebius
strip). The small vertex and triangle tables are built on the host with
numpy and land on `device` (default "cuda") in the TriangleMesh."""
from __future__ import annotations

import numpy as np
import torch

from ..utility import console


def _mesh(vertices, triangles, device):
    from .trianglemesh import TriangleMesh

    return TriangleMesh(np.asarray(vertices, np.float32),
                        np.asarray(triangles, np.int32), device=device)


def create_tetrahedron(radius: float = 1.0,
                       device=None):
    """reference: trianglemesh_factory.cu:391-411."""
    if radius <= 0:
        console.log_error("[CreateTetrahedron] radius <= 0")
    r = radius
    v = np.asarray([
        [np.sqrt(8. / 9.), 0., -1. / 3.],
        [-np.sqrt(2. / 9.), np.sqrt(2. / 3.), -1. / 3.],
        [-np.sqrt(2. / 9.), -np.sqrt(2. / 3.), -1. / 3.],
        [0., 0., 1.],
    ]) * r
    t = [[0, 2, 1], [0, 3, 2], [0, 1, 3], [1, 2, 3]]
    return _mesh(v, t, device)


def create_octahedron(radius: float = 1.0,
                      device=None):
    """reference: trianglemesh_factory.cu:413-434."""
    if radius <= 0:
        console.log_error("[CreateOctahedron] radius <= 0")
    r = radius
    v = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1],
                    [-1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32) * r
    t = [[0, 1, 2], [1, 3, 2], [3, 4, 2], [4, 0, 2],
         [0, 5, 1], [1, 5, 3], [3, 5, 4], [4, 5, 0]]
    return _mesh(v, t, device)


def create_icosahedron(radius: float = 1.0,
                       device=None):
    """reference: trianglemesh_factory.cu:436-476."""
    if radius <= 0:
        console.log_error("[CreateIcosahedron] radius <= 0")
    p = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        [-1, 0, p], [1, 0, p], [1, 0, -p], [-1, 0, -p],
        [0, -p, 1], [0, p, 1], [0, p, -1], [0, -p, -1],
        [-p, -1, 0], [p, -1, 0], [p, 1, 0], [-p, 1, 0],
    ], np.float32) * radius
    t = [[0, 4, 1], [0, 1, 5], [1, 4, 9], [1, 9, 10], [1, 10, 5],
         [0, 8, 4], [0, 11, 8], [0, 5, 11], [5, 6, 11], [5, 10, 6],
         [4, 8, 7], [4, 7, 9], [3, 6, 2], [3, 2, 7], [2, 6, 10],
         [2, 10, 9], [2, 9, 7], [3, 11, 6], [3, 8, 11], [3, 7, 8]]
    return _mesh(v, t, device)


def create_box(width: float = 1.0, height: float = 1.0, depth: float = 1.0,
               device=None):
    """reference: trianglemesh_factory.cu:478-513."""
    if width <= 0 or height <= 0 or depth <= 0:
        console.log_error("[CreateBox] dimensions <= 0")
    v = np.asarray([[x, y, z] for x in (0.0, width)
                    for y in (0.0, height) for z in (0.0, depth)], np.float32)
    t = [[4, 7, 5], [4, 6, 7], [0, 2, 4], [2, 6, 4],
         [0, 1, 2], [1, 3, 2], [1, 5, 7], [1, 7, 3],
         [2, 3, 7], [2, 7, 6], [0, 4, 1], [1, 4, 5]]
    return _mesh(v, t, device)


def _sphere_vertices(radius, resolution, half=False):
    n_lat = resolution + 1 if not half else resolution // 2 + 1
    thetas = np.pi * np.arange(1, n_lat) / resolution  # exclude poles
    phis = 2 * np.pi * np.arange(2 * resolution) / (2 * resolution)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.sin(tt) * np.sin(pp)
    z = np.cos(tt)
    ring = np.stack([x, y, z], -1).reshape(-1, 3)
    return ring, len(thetas)


def create_sphere(radius: float = 1.0, resolution: int = 20,
                  device=None):
    """UV sphere (reference: trianglemesh_factory.cu:515-548)."""
    if radius <= 0:
        console.log_error("[CreateSphere] radius <= 0")
    if resolution <= 0:
        console.log_error("[CreateSphere] resolution <= 0")
    ring, n_rings = _sphere_vertices(radius, resolution)
    m = 2 * resolution
    top = np.asarray([[0, 0, 1.0]])
    bot = np.asarray([[0, 0, -1.0]])
    v = np.concatenate([top, bot, ring], 0) * radius
    tris = []
    for j in range(m):
        jn = (j + 1) % m
        tris.append([0, 2 + j, 2 + jn])                 # top cap
        base = 2 + (n_rings - 1) * m
        tris.append([1, base + jn, base + j])           # bottom cap
    for i in range(n_rings - 1):
        for j in range(m):
            jn = (j + 1) % m
            a = 2 + i * m + j
            b = 2 + i * m + jn
            c = 2 + (i + 1) * m + j
            d = 2 + (i + 1) * m + jn
            tris += [[a, c, d], [a, d, b]]
    return _mesh(v, tris, device)


def create_half_sphere(radius: float = 1.0, resolution: int = 20,
                       device=None):
    """reference: trianglemesh_factory.cu:550-582."""
    if radius <= 0:
        console.log_error("[CreateHalfSphere] radius <= 0")
    ring, n_rings = _sphere_vertices(radius, resolution, half=True)
    m = 2 * resolution
    top = np.asarray([[0, 0, 1.0]])
    v = np.concatenate([top, ring], 0) * radius
    tris = []
    for j in range(m):
        jn = (j + 1) % m
        tris.append([0, 1 + j, 1 + jn])
    for i in range(n_rings - 1):
        for j in range(m):
            jn = (j + 1) % m
            a = 1 + i * m + j
            b = 1 + i * m + jn
            c = 1 + (i + 1) * m + j
            d = 1 + (i + 1) * m + jn
            tris += [[a, c, d], [a, d, b]]
    return _mesh(v, tris, device)


def create_cylinder(radius: float = 1.0, height: float = 2.0,
                    resolution: int = 20, split: int = 4,
                    device=None):
    """reference: trianglemesh_factory.cu:584-627."""
    if radius <= 0 or height <= 0:
        console.log_error("[CreateCylinder] radius or height <= 0")
    if resolution <= 0 or split <= 0:
        console.log_error("[CreateCylinder] resolution or split <= 0")
    phis = 2 * np.pi * np.arange(resolution) / resolution
    zs = height / 2 - np.arange(split + 1) * height / split
    rings = [np.stack([radius * np.cos(phis), radius * np.sin(phis),
                       np.full(resolution, z)], -1) for z in zs]
    v = np.concatenate(
        [np.asarray([[0, 0, height / 2], [0, 0, -height / 2]])] + rings, 0)
    tris = []
    m = resolution
    for j in range(m):
        jn = (j + 1) % m
        tris.append([0, 2 + j, 2 + jn])
        base = 2 + split * m
        tris.append([1, base + jn, base + j])
    for i in range(split):
        for j in range(m):
            jn = (j + 1) % m
            a = 2 + i * m + j
            b = 2 + i * m + jn
            c = 2 + (i + 1) * m + j
            d = 2 + (i + 1) * m + jn
            tris += [[a, c, d], [a, d, b]]
    return _mesh(v, tris, device)


def create_tube(radius: float = 1.0, height: float = 2.0,
                resolution: int = 20, split: int = 4,
                device=None):
    """Open cylinder without caps (reference:
    trianglemesh_factory.cu:629-663)."""
    if radius <= 0 or height <= 0:
        console.log_error("[CreateTube] radius or height <= 0")
    phis = 2 * np.pi * np.arange(resolution) / resolution
    zs = height / 2 - np.arange(split + 1) * height / split
    rings = [np.stack([radius * np.cos(phis), radius * np.sin(phis),
                       np.full(resolution, z)], -1) for z in zs]
    v = np.concatenate(rings, 0)
    tris = []
    m = resolution
    for i in range(split):
        for j in range(m):
            jn = (j + 1) % m
            a = i * m + j
            b = i * m + jn
            c = (i + 1) * m + j
            d = (i + 1) * m + jn
            tris += [[a, c, d], [a, d, b]]
    return _mesh(v, tris, device)


def create_capsule(radius: float = 1.0, height: float = 2.0,
                   resolution: int = 20, split: int = 4,
                   device=None):
    """Two half-spheres + tube (reference:
    trianglemesh_factory.cu:665-694)."""
    if radius <= 0 or height <= 0:
        console.log_error("[CreateCapsule] radius or height <= 0")
    top = create_half_sphere(radius, resolution, device=device)
    top.translate((0, 0, height / 2))
    bottom = create_half_sphere(radius, resolution, device=device)
    bottom.vertices = bottom.vertices * torch.tensor(
        [1.0, -1.0, -1.0], device=bottom.device)
    # mirroring flips orientation; swap winding back
    bottom.triangles = bottom.triangles[:, [0, 2, 1]]
    bottom.translate((0, 0, -height / 2))
    tube = create_tube(radius, height, resolution, split, device=device)
    return top + bottom + tube


def create_cone(radius: float = 1.0, height: float = 2.0,
                resolution: int = 20, split: int = 1,
                device=None):
    """reference: trianglemesh_factory.cu:696-741."""
    if radius <= 0 or height <= 0:
        console.log_error("[CreateCone] radius or height <= 0")
    phis = 2 * np.pi * np.arange(resolution) / resolution
    levels = np.arange(split + 1)
    v = [np.asarray([[0, 0, 0], [0, 0, height]], np.float32)]
    for i in levels[:-1]:
        r = radius * (split - i) / split
        z = height * i / split
        v.append(np.stack([r * np.cos(phis), r * np.sin(phis),
                           np.full(resolution, z)], -1))
    v = np.concatenate(v, 0)
    tris = []
    m = resolution
    for j in range(m):
        jn = (j + 1) % m
        tris.append([0, 2 + jn, 2 + j])  # base (facing -z)
        apex_base = 2 + (split - 1) * m
        tris.append([1, apex_base + j, apex_base + jn])
    for i in range(split - 1):
        for j in range(m):
            jn = (j + 1) % m
            a = 2 + i * m + j
            b = 2 + i * m + jn
            c = 2 + (i + 1) * m + j
            d = 2 + (i + 1) * m + jn
            tris += [[a, d, c], [a, b, d]]
    return _mesh(v, tris, device)


def create_torus(torus_radius: float = 1.0, tube_radius: float = 0.5,
                 radial_resolution: int = 30, tubular_resolution: int = 20,
                 device=None):
    """reference: trianglemesh_factory.cu:743-773."""
    if torus_radius <= 0 or tube_radius <= 0:
        console.log_error("[CreateTorus] radius <= 0")
    if radial_resolution < 2 or tubular_resolution < 2:
        console.log_error("[CreateTorus] resolution < 2")
    R, r = torus_radius, tube_radius
    u = 2 * np.pi * np.arange(radial_resolution) / radial_resolution
    vgrid = 2 * np.pi * np.arange(tubular_resolution) / tubular_resolution
    uu, vv = np.meshgrid(u, vgrid, indexing="ij")
    x = (R + r * np.cos(vv)) * np.cos(uu)
    y = (R + r * np.cos(vv)) * np.sin(uu)
    z = r * np.sin(vv)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    tris = []
    for i in range(radial_resolution):
        inn = (i + 1) % radial_resolution
        for j in range(tubular_resolution):
            jn = (j + 1) % tubular_resolution
            a = i * tubular_resolution + j
            b = i * tubular_resolution + jn
            c = inn * tubular_resolution + j
            d = inn * tubular_resolution + jn
            tris += [[a, c, d], [a, d, b]]
    return _mesh(verts, tris, device)


def create_arrow(cylinder_radius: float = 1.0, cone_radius: float = 1.5,
                 cylinder_height: float = 5.0, cone_height: float = 4.0,
                 resolution: int = 20, cylinder_split: int = 4,
                 cone_split: int = 1,
                 device=None):
    """Cylinder shaft + cone head pointing +z
    (reference: trianglemesh_factory.cu:775-816)."""
    if cylinder_radius <= 0 or cone_radius <= 0:
        console.log_error("[CreateArrow] radius <= 0")
    cyl = create_cylinder(cylinder_radius, cylinder_height, resolution,
                          cylinder_split, device=device)
    cyl.translate((0, 0, cylinder_height / 2))
    cone = create_cone(cone_radius, cone_height, resolution, cone_split,
                       device=device)
    cone.translate((0, 0, cylinder_height))
    return cyl + cone


def create_coordinate_frame(size: float = 1.0, origin=(0.0, 0.0, 0.0),
                            device=None):
    """RGB xyz-axes frame (reference: trianglemesh_factory.cu:818-857)."""
    if size <= 0:
        console.log_error("[CreateCoordinateFrame] size <= 0")
    s = size
    frame = create_sphere(0.06 * s, resolution=10, device=device)
    frame.paint_uniform_color((0.5, 0.5, 0.5))

    def axis(color, R):
        a = create_arrow(0.035 * s, 0.06 * s, 0.8 * s, 0.2 * s,
                         device=device)
        a.paint_uniform_color(color)
        a.rotate(R, center=False)
        return a

    Ry = np.asarray([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    Rx = np.asarray([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    eye = np.eye(3, dtype=np.float32)
    frame += axis((1.0, 0, 0), Ry)     # x red
    frame += axis((0, 1.0, 0), Rx)     # y green
    frame += axis((0, 0, 1.0), eye)    # z blue
    frame.translate(np.asarray(origin, np.float32))
    return frame


def create_moebius(length_split: int = 70, width_split: int = 15,
                   twists: int = 1, radius: float = 1.0,
                   flatness: float = 1.0, width: float = 1.0,
                   scale: float = 1.0,
                   device=None):
    """reference: trianglemesh_factory.cu:859-900."""
    if length_split <= 0 or width_split <= 0:
        console.log_error("[CreateMoebius] split <= 0")
    u = 2 * np.pi * np.arange(length_split) / length_split
    w = width * (np.arange(width_split) / (width_split - 1) - 0.5)
    uu, ww = np.meshgrid(u, w, indexing="ij")
    half_twist = twists * uu / 2.0
    x = scale * (radius + ww * np.cos(half_twist)) * np.cos(uu)
    y = scale * (radius + ww * np.cos(half_twist)) * np.sin(uu)
    z = scale * flatness * ww * np.sin(half_twist)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    tris = []
    for i in range(length_split):
        inn = (i + 1) % length_split
        flip = inn == 0 and twists % 2 == 1
        for j in range(width_split - 1):
            a = i * width_split + j
            b = i * width_split + j + 1
            if flip:
                # odd twists glue the strip end reversed
                c = inn * width_split + (width_split - 1 - j)
                d = inn * width_split + (width_split - 2 - j)
            else:
                c = inn * width_split + j
                d = inn * width_split + j + 1
            tris += [[a, c, d], [a, d, b]]
    return _mesh(verts, tris, device)
