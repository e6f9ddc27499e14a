"""Schur-complement bundle adjustment, replicated or with its landmarks
sharded over a mesh of ranks (the JAX package's
`slam/bundle_adjustment.py`).

Each rank builds the reduced camera system of its landmarks,

    S = sum_l (H_cc^l - H_cl H_ll^-1 H_lc),
    g = sum_l (b_c^l - H_cl H_ll^-1 b_l),

one psum a iteration reduces (S, g, err), every rank solves the same
[6C, 6C] system with camera 0 held fixed and applies the same pose
update, then updates its own landmarks from its own observations. The
traffic is the camera system alone, whatever the map's size.

The iterations run in float64 on the float32 problem (the JAX
package's run in float32). Monocular BA leaves the map's scale free
but for the damping, and at BAL Trafalgar's size a float32 solve of S
moved the cameras by 0.36 (after scale alignment) for last-bit
differences in S between two rank counts (an H100 run); in float64 the
answer does not depend on how the landmarks are split.

Projection: pinhole (fx, fy, cx, cy); poses are world-to-camera
extrinsics T; residual = pi(T X) - uv.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel.collectives import Mesh
from ..utility.device import resolve_device
from ..utility.transforms import exp_se3

BLOCK_AXIS = "blocks"


class BAProblem(NamedTuple):
    """A bundle-adjustment problem in arrays (numpy or tensors).

    poses:        [C, 4, 4]  world-to-camera extrinsics
    points:       [L, 3]     landmarks
    obs_cam:      [L, K]     camera of each observation slot (-1 empty)
    obs_uv:       [L, K, 2]  pixel measurements
    intrinsics:   [4]        fx, fy, cx, cy
    """

    poses: object
    points: object
    obs_cam: object
    obs_uv: object
    intrinsics: object


def make_block_mesh(n_devices: Optional[int] = None, device=None,
                    group=None) -> Mesh:
    """1-D mesh over the landmark (map-block) axis: the ranks of `group`
    (default the initialised world; none: one rank)."""
    mesh = Mesh(BLOCK_AXIS, group=group, device=device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh of {n_devices} ranks needs a group of "
                         f"{n_devices}; this one has {mesh.size}")
    return mesh


def _on(problem: BAProblem, dev) -> BAProblem:
    def t(x, dtype):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    return BAProblem(t(problem.poses, torch.float32),
                     t(problem.points, torch.float32),
                     t(problem.obs_cam, torch.int64),
                     t(problem.obs_uv, torch.float32),
                     t(problem.intrinsics, torch.float32))


def _project(T, X, intr):
    """pi(T X) [..., 2] and the camera-frame point [..., 3]."""
    pc = (T[..., :3, :3] @ X[..., None])[..., 0] + T[..., :3, 3]
    z = pc[..., 2].clamp(min=1e-6)
    uv = torch.stack([intr[0] * pc[..., 0] / z + intr[2],
                      intr[1] * pc[..., 1] / z + intr[3]], -1)
    return uv, pc


def _residual_jacobians(poses, intr, X, cidx, uv):
    """Per observation [L, K]: the residual [.., 2] and its Jacobians
    with respect to the camera's left twist [.., 2, 6] and the point
    [.., 2, 3], in closed form."""
    T = poses[cidx]
    fx, fy = intr[0], intr[1]
    pred, pc = _project(T, X[:, None, :], intr)
    r = pred - uv
    x, y = pc[..., 0], pc[..., 1]
    iz = 1.0 / pc[..., 2].clamp(min=1e-6)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    J_pc = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], -1),
        torch.stack([zero, fy * iz, -fy * y * iz2], -1)], -2)
    # d pc / d twist for exp(xi) T with xi = [w, v]: dw x pc + dv
    pz = pc[..., 2]
    pc_hat = torch.stack([
        torch.stack([zero, -pz, y], -1),
        torch.stack([pz, zero, -x], -1),
        torch.stack([-y, x, zero], -1)], -2)
    J_pose = torch.cat([-(J_pc @ pc_hat), J_pc], -1)
    J_point = J_pc @ T[..., :3, :3]
    return r, J_pose, J_point


def local_schur(poses, points, obs_cam, obs_uv, intr, n_cams: int, lam):
    """The reduced camera system of these landmarks, in the dtype of
    `points`: (S [C, C, 6, 6], g [C, 6], H_ll^-1 [L, 3, 3], b_l [L, 3],
    A = H_cl H_ll^-1 [L, K, 6, 3], the squared error)."""
    valid = obs_cam >= 0
    cidx = obs_cam.clamp(0, n_cams - 1)
    r, J_pose, J_point = _residual_jacobians(poses, intr, points, cidx,
                                             obs_uv)
    w = valid.to(points.dtype)[..., None, None]
    Jp = J_pose * w
    Jx = J_point * w
    rw = r * valid[..., None]
    H_ll = torch.einsum("lkri,lkrj->lij", Jx, J_point) \
        + lam * torch.eye(3, dtype=points.dtype, device=points.device)
    b_l = torch.einsum("lkri,lkr->li", Jx, r)
    # H_cl and A are zero at empty slots, so the cross terms of a pair
    # with an empty slot are too
    H_cl = torch.einsum("lkri,lkrj->lkij", Jp, J_point)
    H_cc = torch.einsum("lkri,lkrj->lkij", Jp, J_pose)
    b_c = torch.einsum("lkri,lkr->lki", Jp, rw)
    H_ll_inv = torch.linalg.inv(H_ll)
    A = torch.einsum("lkij,ljm->lkim", H_cl, H_ll_inv)
    # - H_cl H_ll^-1 H_lc couples every pair of cameras that see the
    # landmark
    cross = torch.einsum("lkim,lnjm->lknij", A, H_cl)
    g_l = b_c - torch.einsum("lkim,lm->lki", A, b_l)
    err = (rw * rw).sum()
    L, K = obs_cam.shape
    S = points.new_zeros((n_cams * n_cams, 36))
    S.index_add_(0, (cidx * (n_cams + 1)).reshape(-1), H_cc.reshape(-1, 36))
    S.index_add_(0, (cidx[:, :, None] * n_cams + cidx[:, None, :])
                 .reshape(-1), cross.reshape(-1, 36), alpha=-1)
    g = points.new_zeros((n_cams, 6))
    g.index_add_(0, cidx.reshape(-1), g_l.reshape(-1, 6))
    return S.reshape(n_cams, n_cams, 6, 6), g, H_ll_inv, b_l, A, err


def back_substitute(points, obs_cam, H_ll_inv, b_l, A, dx_cam,
                    n_cams: int):
    """dX_l = -H_ll^-1 (b_l + H_lc dx_c), from local observations only."""
    cidx = obs_cam.clamp(0, n_cams - 1)
    valid = (obs_cam >= 0).to(A.dtype)
    dxc = dx_cam.reshape(n_cams, 6)[cidx] * valid[..., None]
    corr = torch.einsum("lkij,lki->lj", A, dxc)
    dX = -(torch.einsum("lij,lj->li", H_ll_inv, b_l) + corr)
    return points + dX


def solve_camera_system(S, g, lam, n_cams: int):
    """The camera update [6C] of S [C, C, 6, 6] and g [C, 6], with camera
    0 held fixed."""
    Sr = S.permute(0, 2, 1, 3).reshape(6 * n_cams, 6 * n_cams)[6:, 6:]
    Sr.diagonal().add_(lam)
    dxr = -torch.linalg.solve(Sr, g.reshape(-1)[6:])
    return torch.cat([dxr.new_zeros(6), dxr])


def bundle_adjustment(problem: BAProblem, iterations: int = 10,
                      damping: float = 1e-4, mesh: Optional[Mesh] = None,
                      device=None):
    """Gauss-Newton with the Schur complement; returns (poses [C, 4, 4],
    points [L, 3], the last iteration's squared error) with the tensors
    on the mesh's device, or on `device` (None: the card) without a mesh.

    With `mesh`, each rank takes its block of the landmarks (padded with
    landmarks that have no observation), and the points are gathered
    back at the end. Every rank must call with the same problem."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    p = _on(problem, dev)
    n_cams = int(p.poses.shape[0])
    L, K = p.obs_cam.shape
    d = 1 if mesh is None else mesh.size
    per = -(-L // d)
    pad = per * d - L
    points = torch.cat([p.points, p.points.new_zeros((pad, 3))]).double()
    obs_cam = torch.cat([p.obs_cam, p.obs_cam.new_full((pad, K), -1)])
    obs_uv = torch.cat([p.obs_uv, p.obs_uv.new_zeros((pad, K, 2))]).double()
    if mesh is not None:
        sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
        points, obs_cam, obs_uv = points[sl], obs_cam[sl], obs_uv[sl]
    poses, intr = p.poses.double(), p.intrinsics.double()
    err = torch.zeros((), device=dev)
    for _ in range(iterations):
        S, g, H_ll_inv, b_l, A, err = local_schur(
            poses, points, obs_cam, obs_uv, intr, n_cams, damping)
        if mesh is not None:
            S, g, err = mesh.psum(S), mesh.psum(g), mesh.psum(err)
        dx = solve_camera_system(S, g, damping, n_cams)
        poses = exp_se3(dx.reshape(n_cams, 6)) @ poses
        points = back_substitute(points, obs_cam, H_ll_inv, b_l, A, dx,
                                 n_cams)
    if mesh is not None:
        points = mesh.all_gather(points)
    return poses.float(), points[:L].float(), float(err)


def reprojection_rmse(problem: BAProblem, poses=None, points=None,
                      device=None) -> float:
    """Root mean square reprojection error over the valid observations,
    on `device` (None: where `poses` lie if a tensor, else the card)."""
    if device is None and isinstance(poses, torch.Tensor):
        device = poses.device
    p = _on(problem, resolve_device(device))
    poses = p.poses if poses is None else \
        torch.as_tensor(poses).to(p.points.device, torch.float32)
    points = p.points if points is None else \
        torch.as_tensor(points).to(p.points.device, torch.float32)
    valid = p.obs_cam >= 0
    cidx = p.obs_cam.clamp(0, poses.shape[0] - 1)
    pred, _ = _project(poses[cidx], points[:, None, :], p.intrinsics)
    r = (pred - p.obs_uv) * valid[..., None]
    n = valid.sum().clamp(min=1)
    return float(torch.sqrt((r * r).sum() / n))
