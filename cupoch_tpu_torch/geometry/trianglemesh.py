"""TriangleMesh container (cupoch geometry/meshbase.h, trianglemesh.h):
vertices [N, 3] f32 and triangles [M, 3] int32 on one device, with
vertex normals and colours, per-corner UVs [3M, 2] and a texture Image,
the triangle and vertex normals, the cleanups, uniform sampling, the
neighbour filters, the bounding boxes, the self-intersection test, `+`,
the rigid transforms and the surface area and volume."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utility import console, transforms
from .boundingvolume import AxisAlignedBoundingBox, OrientedBoundingBox
from .geometry import Geometry3D, GeometryType, as_f32, sqrt_f32


def _unit_rows(n: torch.Tensor) -> torch.Tensor:
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)


class MeshBase(Geometry3D):
    """cupoch geometry/meshbase.h."""

    def __init__(self, gtype=GeometryType.TriangleMesh, device=None):
        super().__init__(gtype, device)
        self.vertices = np.zeros((0, 3), np.float32)
        self.vertex_normals = None
        self.vertex_colors = None

    @property
    def vertices(self):
        return self._vertices

    @vertices.setter
    def vertices(self, v):
        self._vertices = as_f32(v, self.device)

    @property
    def vertex_normals(self):
        return self._vertex_normals

    @vertex_normals.setter
    def vertex_normals(self, v):
        self._vertex_normals = None if v is None else as_f32(v, self.device)

    @property
    def vertex_colors(self):
        return self._vertex_colors

    @vertex_colors.setter
    def vertex_colors(self, v):
        self._vertex_colors = None if v is None else as_f32(v, self.device)

    def _primary_points(self):
        return self.vertices

    def _has(self, field) -> bool:
        n = self.vertices.shape[0]
        return field is not None and field.shape[0] == n and n > 0

    def has_vertices(self) -> bool:
        return self.vertices.shape[0] > 0

    def has_vertex_normals(self) -> bool:
        return self._has(self.vertex_normals)

    def has_vertex_colors(self) -> bool:
        return self._has(self.vertex_colors)

    def is_empty(self) -> bool:
        return not self.has_vertices()

    def normalize_normals(self):
        if self.has_vertex_normals():
            self.vertex_normals = _unit_rows(self.vertex_normals)
        return self

    def paint_uniform_color(self, color):
        self.vertex_colors = as_f32(color, self.device).expand(
            self.vertices.shape[0], 3).contiguous()
        return self

    def transform(self, T):
        T = as_f32(T, self.device, (4,))
        self.vertices = transforms.transform_points(T, self.vertices)
        if self.has_vertex_normals():
            self.vertex_normals = transforms.rotate_normals(
                T, self.vertex_normals)
        return self

    def translate(self, t, relative: bool = True):
        t = as_f32(t, self.device)
        if relative:
            self.vertices = self.vertices + t
        else:
            self.vertices = self.vertices - self.vertices.mean(0) + t
        return self

    def scale(self, s, center: bool = True):
        if center:
            c = self.vertices.mean(0)
            self.vertices = (self.vertices - c) * s + c
        else:
            self.vertices = self.vertices * s
        return self

    def rotate(self, R, center: bool = True):
        R = as_f32(R, self.device, (3,))
        if center:
            c = self.vertices.mean(0)
            self.vertices = (self.vertices - c) @ R.T + c
        else:
            self.vertices = self.vertices @ R.T
        if self.has_vertex_normals():
            self.vertex_normals = self.vertex_normals @ R.T
        return self


class TriangleMesh(MeshBase):
    """cupoch geometry/trianglemesh.h."""

    def __init__(self, vertices=None, triangles=None, device=None):
        super().__init__(GeometryType.TriangleMesh, device)
        if vertices is not None:
            self.vertices = vertices
        self.triangles = (np.zeros((0, 3), np.int32) if triangles is None
                          else triangles)
        self.triangle_normals = None
        self.triangle_uvs = None
        #: an Image, or None
        self.texture = None
        #: the broad phase ("dense" or "bucket") the last
        #: `get_self_intersecting_triangles` took, and the boxes its
        #: bucket phase dropped (retested by the dense one)
        self.last_intersection_route = None
        self.last_intersection_dropped = 0

    @property
    def triangles(self):
        return self._triangles

    @triangles.setter
    def triangles(self, v):
        t = v if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(v, np.int32))
        self._triangles = t.to(self.device, torch.int32).reshape(-1, 3)

    def has_triangles(self) -> bool:
        return self.triangles.shape[0] > 0

    @property
    def triangle_uvs(self):
        return self._triangle_uvs

    @triangle_uvs.setter
    def triangle_uvs(self, v):
        self._triangle_uvs = None if v is None \
            else as_f32(v, self.device, (2,))

    def has_triangle_normals(self) -> bool:
        m = self.triangles.shape[0]
        return (self.triangle_normals is not None
                and self.triangle_normals.shape[0] == m and m > 0)

    def has_triangle_uvs(self) -> bool:
        return (self.triangle_uvs is not None and
                self.triangle_uvs.shape[0] == 3 * self.triangles.shape[0])

    def has_texture(self) -> bool:
        """cupoch trianglemesh.h texture_ (HasTexture)."""
        return self.texture is not None and self.texture.has_data()

    def sample_texture_vertex_colors(self):
        """Colours [N, 3] f32 of the vertices, each the texture's texel
        at the UV of the vertex's first triangle corner (a host
        renderer's stand-in for cupoch's textured shader), scaled to
        [0, 1] when the texture holds bytes; None without UVs and a
        texture."""
        if not (self.has_texture() and self.has_triangle_uvs()):
            return None
        dev = self.device
        tex = self.texture.data.to(dev)
        h, w = int(tex.shape[0]), int(tex.shape[1])
        corners = self.triangles.reshape(-1).long()
        n_corners = corners.shape[0]
        first = torch.full((self.vertices.shape[0],), n_corners,
                           dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, corners, torch.arange(
            n_corners, device=dev), "amin")
        # a vertex no triangle uses reads the first corner's UV
        first = torch.where(first == n_corners, 0, first)
        uvv = self.triangle_uvs[first]
        px = (uvv[:, 0] * float(w - 1)).to(torch.int64).clamp(0, w - 1)
        py = ((1.0 - uvv[:, 1]) * float(h - 1)).to(torch.int64) \
            .clamp(0, h - 1)
        c = tex[py, px].to(torch.float32)
        if float(c.max()) > 1.0 + 1e-6:
            c = c / 255.0
        if c.shape[-1] == 1:
            c = c.expand(-1, 3)
        return c[:, :3].contiguous()

    def __repr__(self):
        return (f"TriangleMesh with {int(self.vertices.shape[0])} points and "
                f"{int(self.triangles.shape[0])} triangles on "
                f"{self.device}.")

    def __add__(self, other: "TriangleMesh") -> "TriangleMesh":
        nv = int(self.vertices.shape[0])
        out = TriangleMesh(
            torch.cat([self.vertices, other.vertices.to(self.device)], 0),
            torch.cat([self.triangles,
                       other.triangles.to(self.device) + nv], 0),
            device=self.device)
        if self.has_vertex_normals() and other.has_vertex_normals():
            out.vertex_normals = torch.cat(
                [self.vertex_normals, other.vertex_normals.to(self.device)])
        if self.has_vertex_colors() and other.has_vertex_colors():
            out.vertex_colors = torch.cat(
                [self.vertex_colors, other.vertex_colors.to(self.device)])
        return out

    def __iadd__(self, other):
        m = self + other
        self.vertices, self.triangles = m.vertices, m.triangles
        self.vertex_normals = m.vertex_normals
        self.vertex_colors = m.vertex_colors
        return self

    # -- normals (cupoch trianglemesh.cu ComputeTriangleNormals /
    #    ComputeVertexNormals) ------------------------------------------
    def _face_normals(self) -> torch.Tensor:
        v, t = self.vertices, self.triangles.long()
        v0 = v[t[:, 0]]
        return torch.linalg.cross(v[t[:, 1]] - v0, v[t[:, 2]] - v0, dim=-1)

    def compute_triangle_normals(self, normalized: bool = True):
        n = self._face_normals()
        self.triangle_normals = _unit_rows(n) if normalized else n
        return self

    def compute_vertex_normals(self, normalized: bool = True):
        """Each vertex the sum of its triangles' area-weighted normals."""
        fn = self._face_normals()
        t = self.triangles.long()
        vn = torch.zeros_like(self.vertices)
        for k in range(3):
            vn.index_add_(0, t[:, k], fn)
        self.vertex_normals = _unit_rows(vn) if normalized else vn
        self.triangle_normals = _unit_rows(fn)
        return self

    # -- measures -------------------------------------------------------
    def get_surface_area(self) -> float:
        """cupoch trianglemesh.cu GetSurfaceArea."""
        return float(0.5 * torch.linalg.norm(self._face_normals(),
                                             dim=-1).sum())

    def get_volume(self) -> float:
        """Signed volume by the divergence theorem (watertight meshes)."""
        v, t = self.vertices, self.triangles.long()
        v0, v1, v2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
        return float((v0 * torch.linalg.cross(v1, v2, dim=-1)).sum() / 6.0)

    # -- cleanup (cupoch trianglemesh.cu Remove*) -----------------------
    def _keep_vertices(self, keep: torch.Tensor):
        """Keep the vertex rows `keep` (indices or a mask) with their
        normals and colours."""
        self.vertices = self.vertices[keep]
        for name in ("vertex_normals", "vertex_colors"):
            v = getattr(self, name)
            if v is not None and len(v):
                setattr(self, name, v[keep])

    def remove_duplicated_vertices(self):
        """Merge the vertices whose coordinates agree to 7 decimals
        (numpy's `round` of the float32 values), keeping each group's
        first vertex, in the order of first occurrence."""
        v = self.vertices.cpu().numpy()
        if not len(v):
            return self
        _, inv = np.unique(v.round(decimals=7), axis=0,
                           return_inverse=True)
        inv = inv.reshape(-1)
        first = np.full(inv.max() + 1, len(v), np.int64)
        np.minimum.at(first, inv, np.arange(len(v)))
        order = np.argsort(first)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        dev = self.device
        self._keep_vertices(torch.as_tensor(first[order], device=dev))
        if self.has_triangles():
            self.triangles = torch.as_tensor(rank[inv], device=dev)[
                self.triangles.long()]
        return self

    def remove_duplicated_triangles(self):
        """Keep the first of the triangles with the same vertex set, in
        their order."""
        t = self.triangles
        if not t.shape[0]:
            return self
        key, _ = torch.sort(t, dim=1)
        _, inv = torch.unique(key, dim=0, return_inverse=True)
        m = t.shape[0]
        first = torch.full((int(inv.max()) + 1,), m, dtype=torch.int64,
                           device=t.device)
        first.scatter_reduce_(0, inv, torch.arange(m, device=t.device),
                              "amin")
        self.triangles = t[torch.sort(first).values]
        return self

    def remove_degenerate_triangles(self):
        t = self.triangles
        ok = ((t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2])
              & (t[:, 2] != t[:, 0]))
        self.triangles = t[ok]
        return self

    def remove_unreferenced_vertices(self):
        t = self.triangles.long()
        used = torch.zeros(self.vertices.shape[0], dtype=torch.bool,
                           device=self.device)
        used[t.reshape(-1)] = True
        remap = torch.cumsum(used.to(torch.int64), 0) - 1
        self._keep_vertices(used)
        self.triangles = remap[t]
        return self

    # -- sampling (cupoch trianglemesh.cu SamplePointsUniformly) --------
    def _host_areas(self) -> torch.Tensor:
        """The triangles' areas in float64 on the host: the same on
        every device, so the draws are too."""
        v = self.vertices.detach().cpu().double()
        t = self.triangles.cpu().long()
        v0 = v[t[:, 0]]
        return 0.5 * torch.linalg.norm(torch.linalg.cross(
            v[t[:, 1]] - v0, v[t[:, 2]] - v0, dim=-1), dim=-1)

    def sample_points_uniformly(self, number_of_points: int,
                                seed: int = 0):
        """A PointCloud of `number_of_points` points drawn uniformly
        over the surface: a triangle by its area, then a barycentric
        point (`uniform_draws`), with interpolated vertex normals and
        colours."""
        from .pointcloud import PointCloud

        if number_of_points <= 0 or not self.has_triangles():
            console.log_error("[sample_points_uniformly] Invalid input.")
        tri_idx, r = uniform_draws(self._host_areas(), number_of_points,
                                   seed)
        pts, normals, colors = sample_uniform(
            self.vertices, self.triangles,
            self.vertex_normals if self.has_vertex_normals() else None,
            self.vertex_colors if self.has_vertex_colors() else None,
            tri_idx.to(self.device), r.to(self.device))
        pcd = PointCloud(pts, device=self.device)
        if normals is not None:
            pcd.normals = normals
        if colors is not None:
            pcd.colors = colors
        return pcd

    # -- filters (cupoch trianglemesh.cu FilterSharpen / FilterSmooth*) --
    def _adjacency_sums(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each vertex's sum of the vertices it shares an edge with (an
        edge in two triangles counts twice), and that count [N, 1]. The
        sums run in float64 and round once, so the card's atomic adds
        give the CPU's result whatever their order."""
        t = self.triangles.long()
        v = self.vertices.to(torch.float64)
        s = torch.zeros_like(v)
        for a, b in ((0, 1), (1, 2), (2, 0)):
            s.index_add_(0, t[:, a], v[t[:, b]])
            s.index_add_(0, t[:, b], v[t[:, a]])
        c = torch.bincount(t.reshape(-1), minlength=v.shape[0]) * 2
        return s.to(torch.float32), c.to(torch.float32)[:, None]

    def _filtered(self) -> "TriangleMesh":
        out = TriangleMesh(self.vertices, self.triangles, device=self.device)
        out.vertex_normals = self.vertex_normals
        out.vertex_colors = self.vertex_colors
        return out

    def filter_sharpen(self, number_of_iterations: int = 1,
                       strength: float = 1.0) -> "TriangleMesh":
        out = self._filtered()
        for _ in range(number_of_iterations):
            s, c = out._adjacency_sums()
            out.vertices = out.vertices + strength * (
                out.vertices * c - s) / c.clamp(min=1.0)
        return out

    def filter_smooth_simple(self, number_of_iterations: int = 1
                             ) -> "TriangleMesh":
        out = self._filtered()
        for _ in range(number_of_iterations):
            s, c = out._adjacency_sums()
            out.vertices = (out.vertices + s) / (c + 1.0)
        return out

    def _laplacian_step(self, factor: float):
        s, c = self._adjacency_sums()
        lap = s / c.clamp(min=1.0) - self.vertices
        self.vertices = self.vertices + factor * lap

    def filter_smooth_laplacian(self, number_of_iterations: int = 1,
                                lambda_: float = 0.5) -> "TriangleMesh":
        out = self._filtered()
        for _ in range(number_of_iterations):
            out._laplacian_step(lambda_)
        return out

    def filter_smooth_taubin(self, number_of_iterations: int = 1,
                             lambda_: float = 0.5, mu: float = -0.53
                             ) -> "TriangleMesh":
        out = self._filtered()
        for _ in range(number_of_iterations):
            out._laplacian_step(lambda_)
            out._laplacian_step(mu)
        return out

    # -- boxes ----------------------------------------------------------
    def get_axis_aligned_bounding_box(self) -> AxisAlignedBoundingBox:
        return AxisAlignedBoundingBox.create_from_points(self.vertices)

    def get_oriented_bounding_box(self) -> OrientedBoundingBox:
        return OrientedBoundingBox.create_from_points(self.vertices)

    # -- self-intersection (cupoch trianglemesh.h:193-197) ---------------
    def get_self_intersecting_triangles(self) -> torch.Tensor:
        """Pairs [K, 2] int32 (i < j, sorted) of intersecting triangles
        that share no vertex: the triangles' boxes through the dense test
        or, above `collision._DENSE_LIMIT` box pairs, the bucket broad
        phase, then the exact triangle-triangle test on the candidates.
        The bucket phase keeps every hit of a box, and a box it drops
        meets no box, not even itself, so its row goes through the dense
        test: the pairs are all pairs, as the reference's all-pairs test
        gives (the JAX package keeps 32 hits a box and loses the dropped
        boxes' pairs). The route taken and the boxes dropped are kept in
        `last_intersection_route` and `last_intersection_dropped`."""
        from ..collision import collision as col
        from .intersection_test import tri_tri

        dev = self.device
        t = self.triangles.long()
        F = t.shape[0]
        empty = torch.zeros((0, 2), dtype=torch.int32, device=dev)
        self.last_intersection_route = "dense"
        self.last_intersection_dropped = 0
        if F == 0:
            return empty
        tv = self.vertices[t]                              # [F, 3, 3]
        lo, hi = tv.amin(1), tv.amax(1)
        if F * F > col._DENSE_LIMIT:
            pairs, dropped = col.bucket_overlap_pairs(lo, hi, lo, hi, 0.0,
                                                      max_pairs=F)
            self.last_intersection_route = "bucket"
            self.last_intersection_dropped = dropped
            if dropped:
                # both sets binned alike: a kept box meets itself
                met = torch.zeros(F, dtype=torch.bool, device=dev)
                met[pairs[:, 0].long()] = True
                rows = torch.nonzero(~met)[:, 0]
                extra = col.aabb_overlap_pairs(lo[rows], hi[rows], lo, hi,
                                               0.0).long()
                extra[:, 0] = rows[extra[:, 0]]
                pairs = torch.cat([pairs.long(), extra])
                console.log_debug("[GetSelfIntersectingTriangles] %d "
                                  "dropped boxes retested densely", dropped)
            pairs = pairs.long()
            key = torch.unique(torch.minimum(pairs[:, 0], pairs[:, 1]) * F
                               + torch.maximum(pairs[:, 0], pairs[:, 1]))
            pairs = torch.stack([key // F, key % F], -1)
        else:
            pairs = col.aabb_overlap_pairs(lo, hi, lo, hi, 0.0).long()
        pairs = pairs[pairs[:, 0] < pairs[:, 1]]
        ta, tb = t[pairs[:, 0]], t[pairs[:, 1]]
        shared = (ta[:, :, None] == tb[:, None, :]).any(2).any(1)
        pairs = pairs[~shared]
        if not pairs.shape[0]:
            return empty
        a, b = tv[pairs[:, 0]], tv[pairs[:, 1]]
        hit = tri_tri(a[:, 0], a[:, 1], a[:, 2], b[:, 0], b[:, 1], b[:, 2])
        return pairs[hit].to(torch.int32)

    def is_self_intersecting(self) -> bool:
        """cupoch trianglemesh.h:193 IsSelfIntersecting."""
        return len(self.get_self_intersecting_triangles()) > 0


def uniform_draws(areas: torch.Tensor, n_points: int, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draws of `sample_points_uniformly`: [n] int64 triangle
    indices, each by its share of `areas`, and [n, 2] uniforms in
    [0, 1), from a host `torch.Generator` seeded with `seed`, so the
    card and the CPU sample alike. (The JAX package draws with
    `jax.random.choice` and `uniform`, which cannot be reproduced here;
    its tests feed those draws to `sample_uniform`.)"""
    p = areas.detach().to("cpu", torch.float64)
    p = p / p.sum().clamp(min=1e-300)
    g = torch.Generator().manual_seed(int(seed))
    tri_idx = torch.multinomial(p, n_points, replacement=True, generator=g)
    r = torch.rand((n_points, 2), generator=g, dtype=torch.float32)
    return tri_idx, r


def sample_uniform(v, t, vn, vc, tri_idx, r):
    """Points on triangles `tri_idx` at barycentric coordinates from the
    uniforms r [n, 2] (sqrt(r0) spreads them evenly), with `vn` and
    `vc` (or None) interpolated alike: (points, normals, colours)."""
    r1 = sqrt_f32(r[:, :1])
    a = 1 - r1
    b = r1 * (1 - r[:, 1:])
    c = r1 * r[:, 1:]
    tv = t[tri_idx].long()

    def interp(attr):
        return a * attr[tv[:, 0]] + b * attr[tv[:, 1]] + c * attr[tv[:, 2]]

    return (interp(v), None if vn is None else interp(vn),
            None if vc is None else interp(vc))


# -- primitive factories (cupoch trianglemesh_factory.cu:391-900) -----
def _bind_factories():
    from . import trianglemesh_factory as F

    for name in ("tetrahedron", "octahedron", "icosahedron", "box",
                 "sphere", "half_sphere", "cylinder", "tube", "capsule",
                 "cone", "torus", "arrow", "coordinate_frame", "moebius"):
        setattr(TriangleMesh, "create_" + name,
                staticmethod(getattr(F, "create_" + name)))


_bind_factories()
