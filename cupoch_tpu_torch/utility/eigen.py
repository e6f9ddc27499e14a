"""The J^T J / J^T r reduction and the small linear solves of the
Gauss-Newton step (cupoch utility/eigen.h: ComputeJTJandJTr,
SolveLinearSystemPSD, SolveJacobianSystemAndObtainExtrinsicMatrix),
and the closed-form batched 3x3 eigen helpers of
normal estimation and Generalized ICP (utility/eigenvalue.h)."""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from . import transforms


def compute_jtj_jtr(
    jac_res_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    data: torch.Tensor,
    mask: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """J^T J and J^T r over the rows of `data` (cupoch
    ComputeJTJandJTr). `jac_res_fn(row) -> (J [..., D], r [...])` may
    give several residuals a row, stacked on a leading axis; it is
    mapped over the rows with `torch.func.vmap`. Rows where `mask` is
    false add nothing. Returns (JTJ [D, D], JTr [D], the sum of the
    squared residuals, the residual count), in f32 with TF32 off."""
    J, r = torch.func.vmap(jac_res_fn)(data)
    if J.ndim == 2:
        J = J[:, None, :]
        r = r[:, None]
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (r.ndim - 1)).to(J.dtype)
        J = J * m[..., None]
        r = r * m
    Jf = J.reshape(-1, J.shape[-1])
    rf = r.reshape(-1)
    count = mask.sum() * r.shape[-1] if mask is not None else rf.shape[0]
    return Jf.T @ Jf, Jf.T @ rf, (rf * rf).sum(), count


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


def _det3(B: torch.Tensor) -> torch.Tensor:
    """Determinant of batched 3x3 matrices, by cofactors along row 0."""
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))


def _unit(v: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v / max(|v|, eps), |v|) along the last axis."""
    norm = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / norm.clamp(min=eps), norm


def symeig3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form eigendecomposition of batched symmetric 3x3 matrices
    (cupoch FastEigen3x3's role), in the working type, with no
    iteration: the trigonometric eigenvalue formula and cross-product
    eigenvectors. Returns (eigenvalues ascending [..., 3], eigenvectors
    [..., 3, 3] with [..., :, i] the i-th)."""
    eps = 1e-12
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * eye
    p2 = (B * B).sum((-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp(min=eps))
    r = (_det3(B) / (2.0 * p.clamp(min=eps) ** 3)).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    # (near-)isotropic matrices: every direction is an eigenvector
    iso = p2 < eps
    vals = torch.where(iso[..., None], torch.stack([q, q, q], -1),
                       torch.stack([e3, e2, e1], -1))

    def eigvec(lam):
        M = A - lam[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        cands = torch.stack([torch.linalg.cross(r0, r1, dim=-1),
                             torch.linalg.cross(r0, r2, dim=-1),
                             torch.linalg.cross(r1, r2, dim=-1)], -2)
        best = (cands * cands).sum(-1).argmax(-1)
        v = torch.gather(cands, -2, best[..., None, None].expand(
            best.shape + (1, 3)))[..., 0, :]
        u, norm = _unit(v, eps)
        fallback = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype,
                                device=A.device).expand_as(v)
        return torch.where(norm > eps, u, fallback)

    v0 = eigvec(vals[..., 0])
    v2 = eigvec(vals[..., 2])
    # orthogonalise the largest against the smallest, then v1 = v2 x v0
    v2 = v2 - (v2 * v0).sum(-1, keepdim=True) * v0
    u2, n2 = _unit(v2, eps)
    v2 = torch.where(n2 > eps, u2, _any_orthonormal(v0))
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    vecs = torch.stack([v0, v1, v2], -1)
    vecs = torch.where(iso[..., None, None], eye.expand_as(vecs), vecs)
    return vals, vecs


def _any_orthonormal(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit v (branch-free)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=v.dtype, device=v.device)
    a = torch.where(v[..., 0:1].abs() > 0.9, ey, ex)
    return _unit(torch.linalg.cross(v, a.expand_as(v), dim=-1), 1e-12)[0]


def sqrtm_psd3(A: torch.Tensor) -> torch.Tensor:
    """Symmetric square root of batched PSD 3x3 matrices (cupoch
    SqrtMatrix3x3)."""
    vals, vecs = symeig3x3(A)
    s = torch.sqrt(vals.clamp(min=0.0))
    return torch.einsum("...ij,...j,...kj->...ik", vecs, s, vecs)


def rotation_e1_to_x(x: torch.Tensor) -> torch.Tensor:
    """Rotations taking e1 = (1, 0, 0) to the unit vectors x [..., 3]
    (cupoch generalized_icp.cu GetRotationFromE1ToX); antiparallel x
    gets a half turn about an axis orthogonal to e1."""
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device)
    v = torch.linalg.cross(e1.expand_as(x), x, dim=-1)
    c = x[..., 0]                                   # e1 . x
    eye = torch.eye(3, dtype=x.dtype, device=x.device) \
        .expand(x.shape[:-1] + (3, 3))
    flip = torch.tensor([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]],
                        dtype=x.dtype, device=x.device).expand_as(eye)
    a, b, cc = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(a)
    sv = torch.stack([torch.stack([zero, -cc, b], -1),
                      torch.stack([cc, zero, -a], -1),
                      torch.stack([-b, a, zero], -1)], -2)
    factor = 1.0 / (1.0 + c).clamp(min=1e-8)
    R = eye + sv + (sv @ sv) * factor[..., None, None]
    return torch.where((c < -1.0 + 1e-6)[..., None, None], flip, R)
