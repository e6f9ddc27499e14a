"""Small linear solves for the Gauss-Newton step (cupoch
utility/eigen.h: SolveLinearSystemPSD, SolveJacobianSystemAndObtain-
ExtrinsicMatrix)."""
from __future__ import annotations

from typing import Tuple

import torch

from . import transforms


def _chol_solve_unrolled(A: torch.Tensor, b: torch.Tensor):
    """Fully unrolled scalar Cholesky solve for n <= 8.

    Returns (x [n], det_A), with NaNs when A is not positive definite
    (the caller's finiteness check takes the fallback). The ICP loop
    calls it on host tensors: the 6x6 system is a few hundred scalar
    operations, which would each be a kernel launch on the card."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    det_sqrt = L[0][0]
    for i in range(1, n):
        det_sqrt = det_sqrt * L[i][i]
    return torch.stack(x), det_sqrt * det_sqrt


def solve_linear_system_psd(A: torch.Tensor, b: torch.Tensor,
                            check_det: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve A x = b for PSD A (n <= 8) by Cholesky; returns (ok, x),
    with x = 0 when the system is degenerate."""
    if A.ndim != 2 or A.shape[-1] > 8:
        raise NotImplementedError(
            "solve_linear_system_psd: only n <= 8 is ported")
    x, det = _chol_solve_unrolled(A, b)
    ok = torch.isfinite(x).all()
    if check_det:
        ok = ok & (det.abs() > 1e-12)
    x = torch.where(ok, x, torch.zeros_like(x))
    return ok, x


def solve_jacobian_system(JTJ: torch.Tensor, JTr: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """6x6 GN step -> (ok, 4x4 extrinsic), solving JTJ dx = -JTr."""
    ok, x = solve_linear_system_psd(JTJ, -JTr)
    T = transforms.transform_vector6_to_matrix4(x)
    T = torch.where(ok, T, torch.eye(4, dtype=T.dtype, device=T.device))
    return ok, T
