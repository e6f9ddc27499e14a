"""Collision primitives: Box, Sphere, Capsule, Cylinder and Mesh (cupoch
collision/primitives.{h,cu}, primitives.h:36-257).

A primitive is a host object: its shape parameters and 4x4 pose are
numpy values, its bounds are computed on the host. Its inside test
(`_contains`) runs on the device of the points it is given, with the
float32 (Box, Sphere, Cylinder, Mesh) or float64 (Capsule) arithmetic of
the reference's host formulas written one elementwise operation at a
time, and a threshold compared in float64 where the reference's numpy
promotion compares in float64. Voxelization tests voxel centres on the
primitive's `device`; sweeping interpolates the pose.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from ..geometry.geometry import norm_f32
from ..utility.device import resolve_device

# query points a Mesh inside test takes at once
_MESH_QUERY_CHUNK = 4096


class PrimitiveType(enum.IntEnum):
    # values match primitives.h:38-44
    Unspecified = 0
    Box = 1
    Sphere = 2
    Capsule = 3
    Cylinder = 4
    Mesh = 5


def _le(x: torch.Tensor, thr) -> torch.Tensor:
    """x <= thr as numpy compares them: in float64 when `thr` is a
    float64 numpy value, else in float32 against thr rounded to it."""
    a = np.asarray(thr)
    if isinstance(thr, (np.ndarray, np.generic)) and a.dtype == np.float64:
        return x.double() <= torch.as_tensor(a, device=x.device)
    return x <= torch.as_tensor(a.astype(np.float32), device=x.device)


def _grid_keys(num, device) -> torch.Tensor:
    axes = [torch.arange(int(n), device=device) for n in num]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, 3)


class Primitive:
    """Base of the primitives: a type, a 4x4 pose and the device its
    voxel grids and meshes are made on (default "cuda")."""

    def __init__(self, ptype=PrimitiveType.Unspecified, transform=None,
                 device=None):
        self.type = ptype
        self.device = resolve_device(device)
        self.transform = (np.eye(4, dtype=np.float32) if transform is None
                          else np.asarray(transform, np.float32).copy())

    def transform_(self, T):
        self.transform = self.transform @ np.asarray(T, np.float32)
        return self

    def get_axis_aligned_bounding_box(self):
        from ..geometry.boundingvolume import AxisAlignedBoundingBox

        lo, hi = self._aabb_bounds()
        return AxisAlignedBoundingBox(lo, hi, device=self.device)

    def _aabb_bounds(self):
        raise NotImplementedError

    def _contains(self, pts: torch.Tensor, margin=0.0) -> torch.Tensor:
        """[N] bool: world points inside the primitive inflated by
        `margin`, on the points' device."""
        raise NotImplementedError

    def _to_local(self, pts: torch.Tensor) -> torch.Tensor:
        """(pts - t) R in float32: world points in the primitive's
        frame."""
        T = torch.as_tensor(self.transform, device=pts.device)
        d = pts - T[:3, 3]
        return torch.stack([d[:, 0] * T[0, k] + d[:, 1] * T[1, k]
                            + d[:, 2] * T[2, k] for k in range(3)], -1)

    # -- conversions ---------------------------------------------------------
    def create_mesh(self):
        raise NotImplementedError

    def _centres(self, lo, num, voxel_size: float):
        """(keys [K, 3] int64, centres lo + (key + 0.5) v in float64) of
        the num[0] x num[1] x num[2] box at `lo`."""
        keys = _grid_keys(num, self.device)
        lo_t = torch.as_tensor(np.asarray(lo, np.float64), device=self.device)
        return keys, lo_t + (keys.double() + 0.5) * voxel_size

    def create_voxel_grid(self, voxel_size: float):
        """Solid voxelization by a centre-inside test (cupoch
        CreateVoxelGrid, primitives.cu)."""
        from ..geometry.voxelgrid import VoxelGrid

        lo, hi = self._aabb_bounds()
        lo = lo - voxel_size * 0.5
        num = np.maximum(np.ceil((hi - lo) / voxel_size).astype(int) + 1, 1)
        keys, centers = self._centres(lo, num, voxel_size)
        inside = self._contains(centers.float())
        out = VoxelGrid(self.device)
        out.voxel_size = float(voxel_size)
        out.origin = lo.astype(np.float32)
        out.voxels_keys = keys[inside].to(torch.int32)
        out.voxels_colors = torch.ones((len(out), 3), dtype=torch.float32,
                                       device=self.device)
        return out

    def create_voxel_grid_with_sweeping(self, voxel_size: float,
                                        dst_transform, sampling: int = 10):
        """The union of the voxelizations at `sampling` poses from this
        pose to `dst_transform`, translation interpolated linearly and
        rotation along the geodesic (cupoch CreateVoxelGridWithSweeping,
        primitives.cu)."""
        from ..geometry.voxelgrid import VoxelGrid, unique_keys

        src = self.transform.copy()
        dst = np.asarray(dst_transform, np.float32)
        lo0, hi0 = self._aabb_bounds()
        self.transform = dst
        lo1, hi1 = self._aabb_bounds()
        self.transform = src
        lo = np.minimum(lo0, lo1) - voxel_size * 0.5
        lo_t = torch.as_tensor(np.asarray(lo, np.float64), device=self.device)
        # a device divisor: the card divides by a host scalar through its
        # reciprocal, which is not the division's rounding
        vs_t = torch.tensor(float(voxel_size), dtype=torch.float64,
                            device=self.device)
        all_keys = []
        for i in range(sampling):
            a = i / max(sampling - 1, 1)
            T = src.copy()
            T[:3, 3] = (1 - a) * src[:3, 3] + a * dst[:3, 3]
            T[:3, :3] = _rot_interp(src[:3, :3], dst[:3, :3], a)
            self.transform = T
            lo_i, hi_i = self._aabb_bounds()
            num = np.maximum(
                np.ceil((hi_i - lo_i) / voxel_size).astype(int) + 1, 1)
            _, centers = self._centres(lo_i - voxel_size * 0.5, num,
                                       voxel_size)
            inside = self._contains(centers.float())
            all_keys.append(torch.floor((centers[inside] - lo_t) / vs_t)
                            .to(torch.int32))
        self.transform = src
        out = VoxelGrid(self.device)
        out.voxel_size = float(voxel_size)
        out.origin = lo.astype(np.float32)
        out.voxels_keys, out.voxels_colors = unique_keys(
            torch.cat(all_keys, 0) if all_keys else torch.zeros(
                (0, 3), dtype=torch.int32, device=self.device))
        return out


def _rot_interp(R0, R1, a):
    """Geodesic interpolation between rotations via axis-angle."""
    M = R0.T @ R1
    cos_t = np.clip((np.trace(M) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-8:
        return R0
    w = (1 / (2 * np.sin(theta))) * np.asarray(
        [M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    wa = w * theta * a
    t = np.linalg.norm(wa)
    K = np.asarray([[0, -wa[2], wa[1]], [wa[2], 0, -wa[0]],
                    [-wa[1], wa[0], 0]]) / max(t, 1e-12)
    Ra = np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * (K @ K)
    return (R0 @ Ra).astype(np.float32)


class Box(Primitive):
    """primitives.h:66-86: `lengths` along the local axes, centred on
    the pose."""

    def __init__(self, lengths=(0.0, 0.0, 0.0), transform=None,
                 device=None):
        super().__init__(PrimitiveType.Box, transform, device)
        self.lengths = np.asarray(lengths, np.float32)

    def _aabb_bounds(self):
        ra = np.abs(self.transform[:3, :3]) @ (0.5 * self.lengths)
        t = self.transform[:3, 3]
        return t - ra, t + ra

    def _contains(self, pts, margin=0.0):
        local = self._to_local(pts.float())
        return _le(torch.abs(local), self.lengths / 2 + margin).all(-1)

    def create_mesh(self):
        from ..geometry.trianglemesh import TriangleMesh

        m = TriangleMesh.create_box(*map(float, self.lengths),
                                    device=self.device)
        m.translate(-self.lengths / 2)
        m.transform(self.transform)
        return m


class Sphere(Primitive):
    """primitives.h:88-113."""

    def __init__(self, radius: float = 0.0, center=(0.0, 0.0, 0.0),
                 device=None):
        super().__init__(PrimitiveType.Sphere, None, device)
        self.radius = float(radius)
        self.transform[:3, 3] = np.asarray(center, np.float32)

    def _aabb_bounds(self):
        t = self.transform[:3, 3]
        r = self.radius
        return t - r, t + r

    def _contains(self, pts, margin=0.0):
        c = torch.as_tensor(self.transform[:3, 3], device=pts.device)
        d = pts.float() - c
        return _le(norm_f32(d[:, 0], d[:, 1], d[:, 2]), self.radius + margin)

    def create_mesh(self):
        from ..geometry.trianglemesh import TriangleMesh

        m = TriangleMesh.create_sphere(self.radius, device=self.device)
        m.transform(self.transform)
        return m


def _axis_ends(transform, height: float):
    """The local z segment's world end points, in float64."""
    h2 = height / 2
    a = transform[:3, :3] @ np.asarray([0, 0, -h2]) + transform[:3, 3]
    b = transform[:3, :3] @ np.asarray([0, 0, h2]) + transform[:3, 3]
    return a, b


class Capsule(Primitive):
    """A segment along local z with hemispherical caps
    (primitives.h:115-152)."""

    def __init__(self, radius: float = 0.0, height: float = 0.0,
                 transform=None, device=None):
        super().__init__(PrimitiveType.Capsule, transform, device)
        self.radius = float(radius)
        self.height = float(height)

    def _endpoints(self):
        return _axis_ends(self.transform, self.height)

    def _aabb_bounds(self):
        a, b = self._endpoints()
        return (np.minimum(a, b) - self.radius,
                np.maximum(a, b) + self.radius)

    def _contains(self, pts, margin=0.0):
        a, b = self._endpoints()
        ab = b - a
        denom = max(float(ab @ ab), 1e-12)
        p = pts.float().double()
        d = [p[:, k] - float(a[k]) for k in range(3)]
        t = ((d[0] * float(ab[0]) + d[1] * float(ab[1]) + d[2] * float(ab[2]))
             / torch.tensor(denom, dtype=torch.float64, device=p.device)
             ).clamp(0.0, 1.0)
        e = [p[:, k] - (float(a[k]) + t * float(ab[k])) for k in range(3)]
        return torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) \
            <= float(self.radius + margin)

    def create_mesh(self):
        from ..geometry.trianglemesh import TriangleMesh

        m = TriangleMesh.create_capsule(self.radius, self.height,
                                        device=self.device)
        m.transform(self.transform)
        return m


class Cylinder(Primitive):
    """primitives.h:154-191."""

    def __init__(self, radius: float = 0.0, height: float = 0.0,
                 transform=None, device=None):
        super().__init__(PrimitiveType.Cylinder, transform, device)
        self.radius = float(radius)
        self.height = float(height)

    def _aabb_bounds(self):
        # conservative: the capsule's bound
        a, b = _axis_ends(self.transform, self.height)
        return (np.minimum(a, b) - self.radius,
                np.maximum(a, b) + self.radius)

    def _contains(self, pts, margin=0.0):
        local = self._to_local(pts.float())
        rad = norm_f32(local[:, 0], local[:, 1])
        return _le(rad, self.radius + margin) & _le(
            torch.abs(local[:, 2]), self.height / 2 + margin)

    def create_mesh(self):
        from ..geometry.trianglemesh import TriangleMesh

        m = TriangleMesh.create_cylinder(self.radius, self.height,
                                         device=self.device)
        m.transform(self.transform)
        return m


class Mesh(Primitive):
    """Triangle-mesh primitive: the pose applied lazily, a solid inside
    test by ray-crossing parity, surface voxelization and sweeping
    (primitives.h:190, where the reference leaves the AABB and the
    voxelization unimplemented; the JAX package completes them).
    `vertices` [V, 3] and `triangles` [F, 3] are host numpy arrays."""

    def __init__(self, vertices=None, triangles=None, transform=None,
                 device=None):
        super().__init__(PrimitiveType.Mesh, transform, device)
        self.vertices = (np.zeros((0, 3), np.float32) if vertices is None
                         else np.asarray(vertices, np.float32))
        self.triangles = (np.zeros((0, 3), np.int32) if triangles is None
                          else np.asarray(triangles, np.int32))

    @classmethod
    def from_triangle_mesh(cls, mesh, transform=None, device=None):
        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)

        return cls(host(mesh.vertices), host(mesh.triangles), transform,
                   device=mesh.device if device is None else device)

    def _world_vertices(self) -> np.ndarray:
        return self.vertices @ self.transform[:3, :3].T \
            + self.transform[:3, 3]

    def _aabb_bounds(self):
        if not len(self.vertices):
            z = np.zeros(3, np.float32)
            return z, z
        v = self._world_vertices()
        return v.min(0), v.max(0)

    def _contains(self, pts, margin=0.0):
        """Point in mesh by the parity of +x ray crossings (solid
        containment for closed meshes), in chunks of queries; a positive
        `margin` adds the points within it of a vertex."""
        pts = pts.float()
        dev = pts.device
        if not len(self.triangles) or not pts.shape[0]:
            return torch.zeros(pts.shape[0], dtype=torch.bool, device=dev)
        v = torch.as_tensor(self._world_vertices().astype(np.float32),
                            device=dev)
        tri = torch.as_tensor(self.triangles.astype(np.int64), device=dev)
        a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
        e1 = b - a
        e2 = c - a
        # p = d x e2 with d = +x: (0, -e2z, e2y)
        p1, p2 = -e2[:, 2], e2[:, 1]
        det = e1[:, 1] * p1 + e1[:, 2] * p2
        ok = torch.abs(det) > 1e-12
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        inside = []
        for s in range(0, pts.shape[0], _MESH_QUERY_CHUNK):
            q = pts[s:s + _MESH_QUERY_CHUNK]
            tv = q[:, None, :] - a[None]                     # [Q, F, 3]
            u = (tv[..., 1] * p1 + tv[..., 2] * p2) * inv
            # qv = tv x e1; w = qv . d = qv_x; t = qv . e2
            qx = tv[..., 1] * e1[:, 2] - tv[..., 2] * e1[:, 1]
            qy = tv[..., 2] * e1[:, 0] - tv[..., 0] * e1[:, 2]
            qz = tv[..., 0] * e1[:, 1] - tv[..., 1] * e1[:, 0]
            w = qx * inv
            t = (qx * e2[:, 0] + qy * e2[:, 1] + qz * e2[:, 2]) * inv
            hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t > 1e-9)
            ins = (hit.sum(-1) % 2) == 1
            if margin > 0.0:
                dv = q[:, None, :] - v[None]
                ins = ins | _le(norm_f32(dv[..., 0], dv[..., 1],
                                      dv[..., 2]).amin(-1), margin)
            inside.append(ins)
        return torch.cat(inside)

    def create_mesh(self):
        from ..geometry.trianglemesh import TriangleMesh

        m = TriangleMesh(self.vertices.copy(), self.triangles.copy(),
                         device=self.device)
        m.transform(self.transform)
        return m

    def create_voxel_grid(self, voxel_size: float):
        """Surface voxelization by the triangle/voxel overlap test (the
        mesh path, voxelgrid_factory.cu CreateFromTriangleMesh)."""
        from ..geometry.voxelgrid import VoxelGrid

        return VoxelGrid.create_from_triangle_mesh(self.create_mesh(),
                                                   voxel_size)
