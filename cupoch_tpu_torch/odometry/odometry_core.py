"""RGB-D odometry on dense [H, W] images (cupoch odometry/odometry.cu,
rgbdodometry_jacobian.inl).

Each pyramid level is a device loop of Gauss-Newton steps with no host
read inside it: every step reprojects the source depth into the target
to find the correspondences, forms the photometric (and geometric)
Jacobians of every pixel, reduces the masked 6x6 system with two f32
matrix products (TF32 off) and solves it on the device; the `solved`
flag of the last step stays a device tensor. Invalid depth is NaN, as
in cupoch (preprocess_depth_functor).
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import image_ops
from ..utility import eigen as ueigen
from ..utility import trace
from ..utility.transforms import log_se3

# cupoch rgbdodometry_jacobian.inl
SOBEL_SCALE = 0.125
LAMBDA_HYBRID_DEPTH = 0.968


# [H, W] forms of the [H, W, C] image functions
def filter_gaussian3(x):
    return image_ops.filter_gaussian3(x[..., None])[..., 0]


def filter_sobel_dx(x):
    return image_ops.filter_sobel_dx(x[..., None])[..., 0]


def filter_sobel_dy(x):
    return image_ops.filter_sobel_dy(x[..., None])[..., 0]


def downsample2(x):
    return image_ops.downsample2(x[..., None])[..., 0]


def camera_tensors(K: np.ndarray, device):
    """(K, K^-1) of a host 3x3 intrinsic matrix as f32 tensors on
    `device`; the inverse is taken on the host in f32, so every device
    uses the same one."""
    K_h = torch.as_tensor(np.asarray(K, np.float32))
    return K_h.to(device), torch.linalg.inv(K_h).to(device)


def compute_correspondence(depth_s, depth_t, K, K_inv, T, max_depth_diff):
    """Dense reprojection correspondence (cupoch
    compute_correspondence_map): each source pixel with a finite depth
    goes to u, v = K R K^-1 [u_s v_s 1] d_s + K t in the target, and is
    kept when it lands inside the image in front of the camera on a
    finite target depth within max_depth_diff of its own. Returns (u_t,
    v_t clipped into the image, int64 [H, W], the transformed depth,
    the mask)."""
    H, W = depth_s.shape
    uu, vv = image_ops.pixel_grid(H, W, depth_s.device)
    R, t = T[:3, :3], T[:3, 3]
    KRK_inv = (K @ R) @ K_inv
    Kt = K @ t
    valid_s = torch.isfinite(depth_s)
    ds0 = torch.where(valid_s, depth_s, 0.0)
    uvw = torch.stack([uu, vv, torch.ones_like(uu)], -1)
    proj = ds0[..., None] * (uvw @ KRK_inv.T) + Kt
    z = proj[..., 2]
    safe_z = torch.where(z.abs() > 1e-8, z, 1.0)
    u_t = torch.floor(proj[..., 0] / safe_z + 0.5).to(torch.int64)
    v_t = torch.floor(proj[..., 1] / safe_z + 0.5).to(torch.int64)
    inb = (u_t >= 0) & (u_t < W) & (v_t >= 0) & (v_t < H) & valid_s \
        & (z > 0)
    u_tc = u_t.clamp(0, W - 1)
    v_tc = v_t.clamp(0, H - 1)
    d_t = depth_t[v_tc, u_tc]
    ok = inb & torch.isfinite(d_t) & ((z - d_t).abs() <= max_depth_diff)
    return u_tc, v_tc, z, ok


def depth_to_xyz(depth, K):
    """[H, W] depth -> [H, W, 3] camera-frame points (cupoch
    convert_depth_to_xyz_image_functor)."""
    H, W = depth.shape
    uu, vv = image_ops.pixel_grid(H, W, depth.device)
    x = (uu - K[0, 2]) * depth / K[0, 0]
    y = (vv - K[1, 2]) * depth / K[1, 1]
    return torch.stack([x, y, depth], -1)


def _jacobians(jac_type: str, src_color, tgt_color, tgt_depth, src_xyz,
               dx_color, dx_depth, dy_color, dy_depth, K, T, u_t, v_t, ok):
    """Per-pixel Jacobian rows and residuals (J0 [H, W, 6], r0, J1, r1)
    and the weights `ok` as f32 (cupoch RGBDOdometryJacobianFromColorTerm
    / FromHybridTerm::ComputeJacobianAndResidual); rows and residuals
    are 0 where `ok` is false."""
    fx, fy = K[0, 0], K[1, 1]
    R, t = T[:3, :3], T[:3, 3]

    I_t = tgt_color[v_t, u_t]
    diff_photo = I_t - src_color
    dIdx = SOBEL_SCALE * dx_color[v_t, u_t]
    dIdy = SOBEL_SCALE * dy_color[v_t, u_t]

    p3d = src_xyz @ R.T + t
    X, Y, Z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    invz = 1.0 / torch.where(Z.abs() > 1e-8, Z, 1.0)

    c0 = dIdx * fx * invz
    c1 = dIdy * fy * invz
    c2 = -(c0 * X + c1 * Y) * invz
    J_photo = torch.stack([-Z * c1 + Y * c2, Z * c0 - X * c2,
                           -Y * c0 + X * c1, c0, c1, c2], -1)

    if jac_type == "color":
        J0, r0 = J_photo, diff_photo
        J1 = torch.zeros_like(J_photo)
        r1 = torch.zeros_like(r0)
    else:
        sqrt_ld = torch.sqrt(torch.tensor(LAMBDA_HYBRID_DEPTH,
                                          dtype=torch.float32))
        sqrt_li = torch.sqrt(torch.tensor(1.0 - LAMBDA_HYBRID_DEPTH,
                                          dtype=torch.float32))
        sqrt_ld, sqrt_li = float(sqrt_ld), float(sqrt_li)
        dDdx = SOBEL_SCALE * dx_depth[v_t, u_t]
        dDdy = SOBEL_SCALE * dy_depth[v_t, u_t]
        dDdx = torch.where(torch.isnan(dDdx), 0.0, dDdx)
        dDdy = torch.where(torch.isnan(dDdy), 0.0, dDdy)
        diff_geo = tgt_depth[v_t, u_t] - Z
        d0 = dDdx * fx * invz
        d1 = dDdy * fy * invz
        d2 = -(d0 * X + d1 * Y) * invz
        J0 = sqrt_li * J_photo
        r0 = sqrt_li * diff_photo
        J1 = sqrt_ld * torch.stack([(-Z * d1 + Y * d2) - Y,
                                    (Z * d0 - X * d2) + X,
                                    -Y * d0 + X * d1, d0, d1, d2 - 1.0], -1)
        r1 = sqrt_ld * diff_geo

    # invalid depth is NaN: zero it with where (0 * NaN is NaN)
    J0 = torch.where(ok[..., None], J0, 0.0)
    J1 = torch.where(ok[..., None], J1, 0.0)
    r0 = torch.where(ok, r0, 0.0)
    r1 = torch.where(ok, r1, 0.0)
    return J0, r0, J1, r1, ok.to(torch.float32)


def _reduce_system(J0, r0, J1, r1, w):
    """Weighted JTJ, JTr and r^2 sum over both residual rows (cupoch
    ComputeJTJandJTr<..., 2>)."""
    J0u, J1u = J0.reshape(-1, 6), J1.reshape(-1, 6)
    J0f = (J0 * w[..., None]).reshape(-1, 6)
    J1f = (J1 * w[..., None]).reshape(-1, 6)
    r0f, r1f = r0.reshape(-1), r1.reshape(-1)
    JTJ = J0f.T @ J0u + J1f.T @ J1u
    JTr = J0f.T @ r0f + J1f.T @ r1f
    r2 = (w.reshape(-1) * (r0f * r0f + r1f * r1f)).sum()
    return JTJ, JTr, r2


def _src_xyz(src_depth, K):
    return depth_to_xyz(torch.where(torch.isfinite(src_depth), src_depth,
                                    0.0), K)


def level_odometry(src_color, src_depth, tgt_color, tgt_depth,
                   dx_color, dx_depth, dy_color, dy_depth, K, K_inv,
                   T_init, max_depth_diff: float, jac_type: str,
                   n_iter: int):
    """`n_iter` Gauss-Newton steps at one pyramid level (cupoch
    ComputeMultiscale's iteration loop over DoSingleIteration). Returns
    (T [4, 4], the last step's `solved` flag), both on the device."""
    src_xyz = _src_xyz(src_depth, K)
    T = T_init
    solved = torch.ones((), dtype=torch.bool, device=T.device)
    for _ in range(n_iter):
        with trace.span("odometry.correspondence"):
            u_t, v_t, _, ok = compute_correspondence(
                src_depth, tgt_depth, K, K_inv, T, max_depth_diff)
        with trace.span("odometry.jacobians"):
            J0, r0, J1, r1, w = _jacobians(
                jac_type, src_color, tgt_color, tgt_depth, src_xyz, dx_color,
                dx_depth, dy_color, dy_depth, K, T, u_t, v_t, ok)
        with trace.span("odometry.reduce"):
            JTJ, JTr, _ = _reduce_system(J0, r0, J1, r1, w)
        with trace.span("odometry.solve"):
            solved, delta = ueigen.solve_jacobian_system(JTJ, JTr)
            T = torch.where(solved, delta @ T, T)
    return T, solved


def level_odometry_weighted(src_color, src_depth, tgt_color, tgt_depth,
                            dx_color, dx_depth, dy_color, dy_depth, K,
                            K_inv, T_init, max_depth_diff: float, nu: float,
                            sigma2, inv_sigma_diag, prev_twist, curr_vel,
                            jac_type: str, n_iter: int):
    """The t-distribution-weighted variant with a twist prior (cupoch
    DoSingleIterationWeighted, ComputeWeightedJTJandJTr): per-pixel r^2
    -> w_sum = sum(r^2 (nu + 1) / (nu + r^2 / sigma2)), weights (nu + 1)
    / (nu + r^2 / w_sum), JTJ += diag(inv_sigma), JTr -= inv_sigma
    (prev_twist - log(curr_vel)). Returns (T, curr_vel, sigma2), all on
    the device."""
    src_xyz = _src_xyz(src_depth, K)
    T = T_init
    eye_prior = torch.diag(inv_sigma_diag)
    for _ in range(n_iter):
        u_t, v_t, _, ok = compute_correspondence(
            src_depth, tgt_depth, K, K_inv, T, max_depth_diff)
        J0, r0, J1, r1, w = _jacobians(
            jac_type, src_color, tgt_color, tgt_depth, src_xyz, dx_color,
            dx_depth, dy_color, dy_depth, K, T, u_t, v_t, ok)
        r2 = r0 * r0 + r1 * r1
        w_sum = (w * r2 * (nu + 1.0) / (nu + r2 / sigma2)).sum()
        wt = w * (nu + 1.0) / (nu + r2 / w_sum.clamp(min=1e-12))
        JTJ, JTr, _ = _reduce_system(J0, r0, J1, r1, wt)
        JTJ = JTJ + eye_prior
        JTr = JTr - inv_sigma_diag * (prev_twist - log_se3(curr_vel))
        solved, delta = ueigen.solve_jacobian_system(JTJ, JTr)
        T = torch.where(solved, delta @ T, T)
        curr_vel = torch.where(solved, delta @ curr_vel, curr_vel)
        sigma2 = w_sum
    return T, curr_vel, sigma2


def information_matrix(depth_s, depth_t, K, K_inv, T, max_depth_diff):
    """6x6 information matrix over the final correspondences (cupoch
    CreateInformationMatrix): I + G^T G over the target points' rows."""
    u_t, v_t, _, ok = compute_correspondence(
        depth_s, depth_t, K, K_inv, T, max_depth_diff)
    q = _src_xyz(depth_t, K)[v_t, u_t]
    x, y, zt = q[..., 0], q[..., 1], q[..., 2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    g1 = torch.stack([zero, zt, -y, one, zero, zero], -1)
    g2 = torch.stack([-zt, zero, x, zero, one, zero], -1)
    g3 = torch.stack([y, -x, zero, zero, zero, one], -1)
    w = ok.to(torch.float32)[..., None]
    G = torch.cat([(g * w).reshape(-1, 6) for g in (g1, g2, g3)], 0)
    Gu = torch.cat([g.reshape(-1, 6) for g in (g1, g2, g3)], 0)
    return torch.eye(6, dtype=torch.float32, device=T.device) + G.T @ Gu


def normalize_intensity_scales(color_s, color_t, depth_s, depth_t, K,
                               K_inv, T, max_depth_diff):
    """0.5 / the mean intensity of each image over the correspondence
    set (cupoch NormalizeIntensity)."""
    u_t, v_t, _, ok = compute_correspondence(
        depth_s, depth_t, K, K_inv, T, max_depth_diff)
    w = ok.to(torch.float32)
    cnt = w.sum().clamp(min=1.0)
    mean_s = (w * color_s).sum() / cnt
    mean_t = (w * color_t[v_t, u_t]).sum() / cnt
    return 0.5 / mean_s.clamp(min=1e-12), 0.5 / mean_t.clamp(min=1e-12)
