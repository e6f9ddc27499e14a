"""SO(3) / SE(3) helpers and rotation builders (counterpart of the JAX
package's `utility/transforms.py`).

`transform_vector6_to_matrix4` follows cupoch's solver convention
(utility/eigen.h TransformVector6fToMatrix4f):
R = Rz(rz) @ Ry(ry) @ Rx(rx). The Euler, axis-angle and quaternion
builders mirror cupoch geometry_utils.h. Everything stays float32; the
package turns TF32 off at import so the products here run in full f32.
Every function takes batched inputs on their leading dimensions.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) \
        else torch.as_tensor(x, dtype=torch.float32)


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric [..., 3, 3] matrix of a [..., 3] vector."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, with its Taylor form near zero."""
    w = _t(w)
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2.clamp(min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    return _eye3(w, W.shape) + a * W + b * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse of `exp_so3` (angle in [0, pi]); the diagonal method
    above an angle of 3, where the antisymmetric part vanishes."""
    R = _t(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    # 1 - 1e-8 rounds to 1 in f32; 1e-6 keeps theta < ~1.4e-3 where
    # the unit scale is accurate to ~3e-7
    small = cos > 1.0 - 1e-6
    theta = torch.where(small, torch.zeros_like(cos),
                        torch.arccos(torch.where(small, 0.0, cos)))
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_safe = torch.where(small, 1.0, torch.sin(theta))
    sin_safe = torch.where(sin_safe.abs() < _EPS, _EPS, sin_safe)
    scale = torch.where(small, 1.0, theta / sin_safe)[..., None]
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis_sq = ((diag - cos[..., None])
               / (1.0 - cos[..., None]).clamp(min=_EPS)).clamp(min=0.0)
    axis = torch.sqrt(torch.where(near_pi[..., None], axis_sq, 1.0))
    signs = torch.stack([torch.sign(R[..., 2, 1] - R[..., 1, 2]),
                         torch.sign(R[..., 0, 2] - R[..., 2, 0]),
                         torch.sign(R[..., 1, 0] - R[..., 0, 1])], -1)
    signs = torch.where(signs == 0, 1.0, signs)
    w_pi = axis * signs * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w * scale)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: xi = [w, v] (rotation first) -> [..., 4, 4]."""
    xi = _t(xi)
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2.clamp(min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    R = exp_so3(w)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    V = _eye3(xi, R.shape) + b * W + c * W2
    return make_transform(R, (V @ v[..., None])[..., 0])


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of `exp_se3`: [..., 4, 4] -> [..., 6]."""
    T = _t(T)
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = log_so3(R)
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    W = hat(w)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    half_cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - 0.5 * theta * torch.sin(theta)
         / (1.0 - torch.cos(theta)).clamp(min=_EPS)) / theta2_safe)
    Vinv = _eye3(T, R.shape) - 0.5 * W + half_cot * (W @ W)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], -1)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a [..., 4, 4] homogeneous transform from R and t."""
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def inverse_transform(T: torch.Tensor) -> torch.Tensor:
    T = _t(T)
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


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


def rotation_matrix_x(a) -> torch.Tensor:
    return _rot_axis(_t(a), 0)


def rotation_matrix_y(a) -> torch.Tensor:
    return _rot_axis(_t(a), 1)


def rotation_matrix_z(a) -> torch.Tensor:
    return _rot_axis(_t(a), 2)


def transform_vector6_to_matrix4(x: torch.Tensor) -> torch.Tensor:
    """Euler-angle 6-vector (rx, ry, rz, tx, ty, tz) -> 4x4."""
    R = (_rot_axis(x[..., 2], 2) @ _rot_axis(x[..., 1], 1)
         @ _rot_axis(x[..., 0], 0))
    return make_transform(R, x[..., 3:6])


_AXIS = {"X": 0, "Y": 1, "Z": 2}


def rotation_from_euler(order: str, angles) -> torch.Tensor:
    """Intrinsic Euler composition, e.g. order="XYZ" -> Rx @ Ry @ Rz
    (cupoch GetRotationMatrixFrom{XYZ,YZX,ZXY,XZY,ZYX,YXZ})."""
    angles = _t(angles)
    R = _rot_axis(angles[..., 0], _AXIS[order[0]])
    for i, ax in enumerate(order[1:], start=1):
        R = R @ _rot_axis(angles[..., i], _AXIS[ax])
    return R


def rotation_from_axis_angle(axis_angle) -> torch.Tensor:
    """Axis-angle vector (direction * angle) -> rotation matrix."""
    return exp_so3(_t(axis_angle))


def rotation_from_quaternion(q) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix (normalises q)."""
    q = _t(q)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def quaternion_from_rotation(R) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free."""
    R = _t(R)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt((1 + tr).clamp(min=0)) / 2
    qx = torch.sqrt((1 + m00 - m11 - m22).clamp(min=0)) / 2
    qy = torch.sqrt((1 - m00 + m11 - m22).clamp(min=0)) / 2
    qz = torch.sqrt((1 - m00 - m11 + m22).clamp(min=0)) / 2
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = torch.stack([qw, qx, qy, qz], -1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to [N, 3] points."""
    return points @ T[:3, :3].T + T[:3, 3]


def rotate_normals(T_or_R: torch.Tensor, normals: torch.Tensor
                   ) -> torch.Tensor:
    """Rotate [N, 3] normals by the rotation block of a 3x3 or 4x4."""
    return normals @ T_or_R[..., :3, :3].transpose(-1, -2)
