"""Point-to-plane ICP, plain PyTorch (cupoch RegistrationICP with
TransformationEstimationPointToPlane and ICPConvergenceCriteria).

Each iteration moves the source by the current pose, pairs each moved
point with its exact nearest target point within the threshold
(`grid_nn`), reduces the Gauss-Newton system of the point-to-plane
residuals, solves it on the host and composes the Euler-angle update
(R = Rz Ry Rx) on the left of the pose. It stops when fitness and
inlier RMSE both change by less than the relative tolerances, or after
`max_iteration` updates; fitness and RMSE are those of the final pose.
`dtype` is the working type of the points, normals and sums: float32
as the configuration states, or a lower one for the control.
"""
from __future__ import annotations

import torch

from . import grid_nn

_HOST = torch.device("cpu")


def euler_update(x):
    """[4, 4] float64 from (rx, ry, rz, tx, ty, tz)."""
    def rot(a, axis):
        c, s = torch.cos(a), torch.sin(a)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        R = torch.eye(3, dtype=torch.float64)
        R[i, i], R[j, j] = c, c
        R[i, j], R[j, i] = (-s, s) if axis != 1 else (s, -s)
        return R
    x = x.double()
    T = torch.eye(4, dtype=torch.float64)
    T[:3, :3] = rot(x[2], 2) @ rot(x[1], 1) @ rot(x[0], 0)
    T[:3, 3] = x[3:6]
    return T


def point_to_plane(source, target, target_normals, threshold, init,
                   relative_fitness=1e-6, relative_rmse=1e-6,
                   max_iteration=30, dtype=torch.float32):
    """(pose [4, 4] float32 on the host, fitness, inlier RMSE,
    iterations) registering `source` [N, 3] onto `target` [M, 3] with
    `target_normals`, all on one device."""
    src = source.to(dtype)
    tgt = target.to(dtype)
    nrm = target_normals.to(dtype)
    index = grid_nn.NearestIndex(tgt, threshold)
    n_src = max(src.shape[0], 1)
    T = torch.as_tensor(init, dtype=torch.float32).to(_HOST)

    def state(T):
        Td = T.to(src.device, dtype)
        moved = src @ Td[:3, :3].T + Td[:3, 3]
        idx, d2 = index.nearest(moved)
        ok = idx >= 0
        cnt = float(ok.sum())
        err = float(torch.where(ok, d2, 0.0).to(torch.float32).sum())
        fit = cnt / n_src
        rmse = (err / cnt) ** 0.5 if cnt > 0 else 0.0
        return moved, idx, ok, fit, rmse

    def system(moved, idx, ok):
        ti = idx.clamp(min=0)
        n = nrm[ti]
        d = moved - tgt[ti]
        r = (d * n).sum(-1)
        J = torch.cat([torch.linalg.cross(moved, n, dim=-1), n], -1)
        w = ok.to(dtype)[:, None]
        Jw = J * w
        JTJ = (Jw.T @ J).to(torch.float32)
        JTr = (Jw * r[:, None]).sum(0).to(torch.float32)
        return JTJ.to(_HOST), JTr.to(_HOST)

    moved, idx, ok, fit, rmse = state(T)
    it = 0
    prev = None
    while True:
        if prev is not None and abs(prev[0] - fit) < relative_fitness \
                and abs(prev[1] - rmse) < relative_rmse:
            break
        if it >= max_iteration:
            break
        JTJ, JTr = system(moved, idx, ok)
        try:
            x = torch.linalg.solve(JTJ.double(), -JTr.double())
        except RuntimeError:
            break
        if not torch.isfinite(x).all():
            break
        T = (euler_update(x) @ T.double()).to(torch.float32)
        it += 1
        prev = (fit, rmse)
        moved, idx, ok, fit, rmse = state(T)
    return T, fit, rmse, it
