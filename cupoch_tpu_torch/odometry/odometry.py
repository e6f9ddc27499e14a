"""RGB-D odometry entry points (cupoch odometry/odometry.h,
odometry.cu ComputeRGBDOdometryT).

The host runs the coarse-to-fine schedule; each pyramid level is one
device loop (`odometry_core.level_odometry`), and the host reads the
level's `solved` flag once after it.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..geometry.image import FilterType, RGBDImage
from ..utility import console, trace
from ..utility.transforms import log_se3
from . import odometry_core as core


class OdometryOption:
    """cupoch odometry/odometry_option.h (same defaults)."""

    def __init__(self,
                 iteration_number_per_pyramid_level: Optional[List[int]] = None,
                 max_depth_diff: float = 0.03,
                 min_depth: float = 0.0,
                 max_depth: float = 4.0,
                 nu: float = 5.0,
                 sigma2_init: float = 1.0,
                 inv_sigma_mat_diag=None):
        self.iteration_number_per_pyramid_level = (
            [20, 10, 5] if iteration_number_per_pyramid_level is None
            else list(iteration_number_per_pyramid_level))
        self.max_depth_diff = float(max_depth_diff)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        self.nu = float(nu)
        self.sigma2_init = float(sigma2_init)
        self.inv_sigma_mat_diag = (
            np.zeros(6, np.float32) if inv_sigma_mat_diag is None
            else np.asarray(inv_sigma_mat_diag, np.float32))


class RGBDOdometryJacobian:
    jac_type = "color"


class RGBDOdometryJacobianFromColorTerm(RGBDOdometryJacobian):
    """Steinbruecker's photometric term (cupoch
    rgbdodometry_jacobian.h)."""

    jac_type = "color"


class RGBDOdometryJacobianFromHybridTerm(RGBDOdometryJacobian):
    """Park's photometric and geometric term (cupoch
    rgbdodometry_jacobian.h)."""

    jac_type = "hybrid"


def _chan0(img) -> torch.Tensor:
    return img.data.to(torch.float32)[..., 0]


def _preprocess_depth(depth: torch.Tensor, option: OdometryOption
                      ) -> torch.Tensor:
    """Depth outside [min_depth, max_depth] or not positive -> NaN
    (cupoch preprocess_depth_functor)."""
    bad = (depth < option.min_depth) | (depth > option.max_depth) \
        | (depth <= 0)
    return torch.where(bad, float("nan"), depth)


def _initialize(source: RGBDImage, target: RGBDImage, intrinsic, odo_init,
                option: OdometryOption):
    """cupoch InitializeRGBDOdometry: smoothed intensities scaled to a
    mean of 0.5 over the initial correspondences, and smoothed depths
    with NaN where invalid."""
    dev = source.color.data.device
    src_gray = source.color.filter(FilterType.Gaussian3)
    tgt_gray = target.color.filter(FilterType.Gaussian3)
    sd = core.filter_gaussian3(_preprocess_depth(_chan0(source.depth),
                                                 option))
    td = core.filter_gaussian3(_preprocess_depth(_chan0(target.depth),
                                                 option))
    K, K_inv = core.camera_tensors(intrinsic.intrinsic_matrix, dev)
    sc, tc = _chan0(src_gray), _chan0(tgt_gray)
    scale_s, scale_t = core.normalize_intensity_scales(
        sc, tc, sd, td, K, K_inv,
        torch.as_tensor(odo_init, device=dev), option.max_depth_diff)
    return sc * scale_s, sd, tc * scale_t, td


def _camera_matrix_pyramid(intrinsic, levels: int):
    """cupoch CreateCameraMatrixPyramid: fx, fy, cx, cy halved a level."""
    mats = [np.asarray(intrinsic.intrinsic_matrix, np.float32)]
    for _ in range(1, levels):
        m = 0.5 * mats[-1]
        m[2, 2] = 1.0
        mats.append(m)
    return mats


def _pyramid(img: torch.Tensor, levels: int, smooth: bool):
    out = [img]
    for _ in range(1, levels):
        x = out[-1]
        if smooth:
            x = core.filter_gaussian3(x)
        out.append(core.downsample2(x))
    return out


def _prepare(rgbd_source, rgbd_target, intrinsic, odo_init, option):
    """Both images' pyramids, the camera pyramid and the initial pose on
    the source's device."""
    odo_init = np.eye(4, dtype=np.float32) if odo_init is None \
        else np.asarray(odo_init, np.float32)
    sc, sd, tc, td = _initialize(rgbd_source, rgbd_target, intrinsic,
                                 odo_init, option)
    levels = len(option.iteration_number_per_pyramid_level)
    pyr = [_pyramid(x, levels, smooth) for x, smooth in
           ((sc, True), (sd, False), (tc, True), (td, False))]
    K_p = _camera_matrix_pyramid(intrinsic, levels)
    if not np.any(odo_init):
        odo_init = np.eye(4, dtype=np.float32)
    return pyr, K_p, torch.as_tensor(odo_init, device=sc.device)


def _level_inputs(pyr, K_p, level: int, device):
    """A level's images, the target's Sobel gradients and (K, K^-1)."""
    sc_p, sd_p, tc_p, td_p = pyr
    tgt_c, tgt_d = tc_p[level], td_p[level]
    K, K_inv = core.camera_tensors(K_p[level], device)
    return (sc_p[level], sd_p[level], tgt_c, tgt_d,
            core.filter_sobel_dx(tgt_c), core.filter_sobel_dx(tgt_d),
            core.filter_sobel_dy(tgt_c), core.filter_sobel_dy(tgt_d),
            K, K_inv)


def _information(pyr, K_p, T, option):
    K, K_inv = core.camera_tensors(K_p[0], T.device)
    return core.information_matrix(pyr[1][0], pyr[3][0], K, K_inv, T,
                                   option.max_depth_diff)


def compute_rgbd_odometry(
    rgbd_source: RGBDImage,
    rgbd_target: RGBDImage,
    pinhole_camera_intrinsic,
    odo_init=None,
    jacobian: RGBDOdometryJacobian = RGBDOdometryJacobianFromHybridTerm(),
    option: OdometryOption = None,
) -> Tuple[bool, np.ndarray, np.ndarray]:
    """The 4x4 motion from the source to the target RGB-D frame, on the
    images' device (cupoch ComputeRGBDOdometry). Returns (is_success,
    4x4 transformation, 6x6 information matrix) as host arrays."""
    with trace.span("odometry.rgbd"):
        return _rgbd_odometry(rgbd_source, rgbd_target,
                              pinhole_camera_intrinsic, odo_init, jacobian,
                              option)


def _rgbd_odometry(rgbd_source, rgbd_target, pinhole_camera_intrinsic,
                   odo_init, jacobian, option):
    option = option or OdometryOption()
    if (rgbd_source.color.width != rgbd_target.color.width or
            rgbd_source.color.height != rgbd_target.color.height):
        console.log_warning(
            "[RGBDOdometry] Two RGBD pairs should be same in size.")
        return False, np.eye(4, dtype=np.float32), \
            np.zeros((6, 6), np.float32)
    with trace.span("odometry.prepare"):
        pyr, K_p, T = _prepare(rgbd_source, rgbd_target,
                               pinhole_camera_intrinsic, odo_init, option)
    iters = option.iteration_number_per_pyramid_level
    levels = len(iters)
    for level in range(levels - 1, -1, -1):
        inputs = _level_inputs(pyr, K_p, level, T.device)
        n_iter = iters[levels - level - 1]
        with trace.span("odometry.level", level=level, iterations=n_iter):
            T, ok = core.level_odometry(*inputs, T, option.max_depth_diff,
                                        jacobian.jac_type, n_iter)
        if not bool(trace.to_host(ok)):       # the level's one read
            console.log_warning("[ComputeOdometry] no solution!")
            return False, np.eye(4, dtype=np.float32), \
                np.zeros((6, 6), np.float32)
    with trace.span("odometry.information"):
        info = _information(pyr, K_p, T, option)
    return True, trace.to_host(T).numpy(), trace.to_host(info).numpy()


def compute_weighted_rgbd_odometry(
    rgbd_source: RGBDImage,
    rgbd_target: RGBDImage,
    pinhole_camera_intrinsic,
    odo_init=None,
    prev_twist=None,
    jacobian: RGBDOdometryJacobian = RGBDOdometryJacobianFromHybridTerm(),
    option: OdometryOption = None,
) -> Tuple[bool, np.ndarray, np.ndarray, np.ndarray]:
    """t-distribution-weighted odometry with a twist prior (cupoch
    ComputeWeightedRGBDOdometry). Returns (is_success, 4x4
    transformation, the twist of the estimated velocity, 6x6
    information matrix) as host arrays."""
    option = option or OdometryOption()
    pyr, K_p, T = _prepare(rgbd_source, rgbd_target,
                           pinhole_camera_intrinsic, odo_init, option)
    dev = T.device
    prev_twist = torch.as_tensor(
        np.zeros(6, np.float32) if prev_twist is None
        else np.asarray(prev_twist, np.float32), device=dev)
    inv_sigma = torch.as_tensor(option.inv_sigma_mat_diag, device=dev)
    curr_vel = torch.eye(4, dtype=torch.float32, device=dev)
    sigma2 = option.sigma2_init
    iters = option.iteration_number_per_pyramid_level
    levels = len(iters)
    for level in range(levels - 1, -1, -1):
        T, curr_vel, sigma2 = core.level_odometry_weighted(
            *_level_inputs(pyr, K_p, level, dev), T, option.max_depth_diff,
            option.nu, sigma2, inv_sigma, prev_twist, curr_vel,
            jacobian.jac_type, iters[levels - level - 1])
    info = _information(pyr, K_p, T, option)
    return (True, T.cpu().numpy(), log_se3(curr_vel).cpu().numpy(),
            info.cpu().numpy())
