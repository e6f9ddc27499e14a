"""TriangleMesh container (cupoch geometry/meshbase.h, trianglemesh.h):
vertices [N, 3] f32 and triangles [M, 3] int32 on one device, with
vertex normals and colours, the triangle and vertex normals, the
degenerate-triangle cleanup, `+`, the rigid transforms and the surface
area and volume."""
from __future__ import annotations

import numpy as np
import torch

from ..utility import transforms
from .geometry import Geometry3D, GeometryType, as_f32


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

    @property
    def triangles(self):
        return self._triangles

    @triangles.setter
    def triangles(self, v):
        t = v if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.asarray(v, np.int32))
        self._triangles = t.to(self.device, torch.int32).reshape(-1, 3)

    def has_triangles(self) -> bool:
        return self.triangles.shape[0] > 0

    def has_triangle_normals(self) -> bool:
        m = self.triangles.shape[0]
        return (self.triangle_normals is not None
                and self.triangle_normals.shape[0] == m and m > 0)

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

    # -- cleanup (cupoch trianglemesh.cu RemoveDegenerateTriangles) ------
    def remove_degenerate_triangles(self):
        t = self.triangles
        ok = ((t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2])
              & (t[:, 2] != t[:, 0]))
        self.triangles = t[ok]
        return self


# -- primitive factories (cupoch trianglemesh_factory.cu:391-900) -----
def _bind_factories():
    from . import trianglemesh_factory as F

    for name in ("tetrahedron", "octahedron", "icosahedron", "box",
                 "sphere", "half_sphere", "cylinder", "tube", "capsule",
                 "cone", "torus", "arrow", "coordinate_frame", "moebius"):
        setattr(TriangleMesh, "create_" + name,
                staticmethod(getattr(F, "create_" + name)))


_bind_factories()
