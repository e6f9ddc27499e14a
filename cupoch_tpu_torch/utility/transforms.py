"""Rigid-transform helpers used by the ICP path.

`transform_vector6_to_matrix4` follows cupoch's solver convention
(utility/eigen.h TransformVector6fToMatrix4f):
R = Rz(rz) @ Ry(ry) @ Rx(rx). Everything stays float32; the package
turns TF32 off at import so the products here run in full f32.
"""
from __future__ import annotations

import torch


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a [..., 4, 4] homogeneous transform from R and t."""
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _rot_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    if axis == 0:
        rows = [[o, z, z], [z, c, -s], [z, s, c]]
    elif axis == 1:
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    else:
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def transform_vector6_to_matrix4(x: torch.Tensor) -> torch.Tensor:
    """Euler-angle 6-vector (rx, ry, rz, tx, ty, tz) -> 4x4."""
    R = (_rot_axis(x[..., 2], 2) @ _rot_axis(x[..., 1], 1)
         @ _rot_axis(x[..., 0], 0))
    return make_transform(R, x[..., 3:6])


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to [N, 3] points."""
    return points @ T[:3, :3].T + T[:3, 3]
