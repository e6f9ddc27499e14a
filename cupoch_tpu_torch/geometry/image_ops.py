"""Image functions over [H, W, C] float32 tensors (cupoch image.cu,
image_factory.cu).

Each filter is a sum of shifted copies of an edge-padded image, tap by
tap, zero taps included, so a NaN (invalid depth) reaches every pixel
whose window holds it, as in a convolution. The separable filters run
the vertical pass first, then the horizontal one.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# separable filter taps (cupoch image.cu Gaussian / Sobel constants)
GAUSSIAN_3 = np.asarray([0.25, 0.5, 0.25], np.float32)
GAUSSIAN_5 = np.asarray([1, 4, 6, 4, 1], np.float32) / 16.0
GAUSSIAN_7 = np.asarray([1, 6, 15, 20, 15, 6, 1], np.float32) / 64.0
SOBEL_EDGE = np.asarray([-1.0, 0.0, 1.0], np.float32)
SOBEL_SMOOTH = np.asarray([1.0, 2.0, 1.0], np.float32)
INTENSITY_WEIGHTS = (0.2990, 0.5870, 0.1140)


def _edge_pad(img: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """`img` [H, W, C] padded by ry rows and rx columns on each side with
    its edge values."""
    H, W = img.shape[0], img.shape[1]
    rows = torch.arange(-ry, H + ry, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-rx, W + rx, device=img.device).clamp(0, W - 1)
    return img[rows][:, cols]


def _taps(x: torch.Tensor, taps: np.ndarray, axis: int, n: int
          ) -> torch.Tensor:
    """sum_i taps[i] * x shifted by i along `axis`, `n` outputs long."""
    out = None
    for i, k in enumerate(taps):
        term = x.narrow(axis, i, n) * float(k)
        out = term if out is None else out + term
    return out


def _sep_conv2d(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray
                ) -> torch.Tensor:
    """Separable 2D correlation with edge-clamped padding (cupoch's
    clamped pixel addressing at the borders)."""
    H, W = img.shape[0], img.shape[1]
    x = _taps(_edge_pad(img, len(ky) // 2, len(kx) // 2), ky, 0, H)
    return _taps(x, kx, 1, W)


def filter_gaussian3(img):
    return _sep_conv2d(img, GAUSSIAN_3, GAUSSIAN_3)


def filter_gaussian5(img):
    return _sep_conv2d(img, GAUSSIAN_5, GAUSSIAN_5)


def filter_gaussian7(img):
    return _sep_conv2d(img, GAUSSIAN_7, GAUSSIAN_7)


def filter_sobel_dx(img):
    """Sobel horizontal gradient (cupoch image.cu Sobel3Dx)."""
    return _sep_conv2d(img, SOBEL_EDGE, SOBEL_SMOOTH)


def filter_sobel_dy(img):
    return _sep_conv2d(img, SOBEL_SMOOTH, SOBEL_EDGE)


def filter_bilateral(img: torch.Tensor, diameter: int, sigma_color,
                     sigma_space) -> torch.Tensor:
    """Brute-force bilateral filter over a (2r+1)^2 window, r =
    diameter // 2 (cupoch image.cu bilateral_filter_functor); the
    identity for a diameter below 2."""
    H, W = img.shape[0], img.shape[1]
    r = diameter // 2
    pad = _edge_pad(img, r, r)
    f32 = dict(dtype=torch.float32, device=img.device)
    sc = torch.tensor(sigma_color, **f32)
    ss = torch.tensor(sigma_space, **f32)
    inv_2sc2 = 1.0 / (2.0 * sc ** 2)
    inv_2ss2 = 1.0 / (2.0 * ss ** 2)
    acc = torch.zeros_like(img)
    wacc = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = pad[dy + r: dy + r + H, dx + r: dx + r + W]
            diff = shifted - img
            w = torch.exp(-(diff * diff) * inv_2sc2
                          - (dy * dy + dx * dx) * inv_2ss2)
            acc = acc + w * shifted
            wacc = wacc + w
    return acc / wacc.clamp(min=1e-12)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x box down-sampling: the mean of each 2x2 block (cupoch image.cu
    downsample_functor); an odd last row or column is dropped."""
    H, W, C = img.shape
    h2, w2 = H // 2, W // 2
    x = img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, C)
    return x.mean(dim=(1, 3))


def dilate(img: torch.Tensor, half_kernel_size: int = 1) -> torch.Tensor:
    """Binary dilation over a zero-padded window (cupoch image.cu
    dilate_functor): the window's maximum, and at least 0."""
    r = half_kernel_size
    H, W = img.shape[0], img.shape[1]
    pad = torch.nn.functional.pad(img, (0, 0, r, r, r, r))
    out = torch.zeros_like(img)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            out = torch.maximum(out, pad[dy: dy + H, dx: dx + W])
    return out


def flip_horizontal(img):
    return img.flip(1)


def flip_vertical(img):
    return img.flip(0)


def transpose(img):
    return img.transpose(0, 1).contiguous()


def linear_transform(img, scale, offset):
    """cupoch image.cu LinearTransform, in f32."""
    f32 = dict(dtype=torch.float32, device=img.device)
    return img * torch.tensor(scale, **f32) + torch.tensor(offset, **f32)


def clip_intensity(img, min_v, max_v):
    f32 = dict(dtype=torch.float32, device=img.device)
    return torch.minimum(torch.maximum(img, torch.tensor(min_v, **f32)),
                         torch.tensor(max_v, **f32))


def color_to_intensity(img: torch.Tensor) -> torch.Tensor:
    """RGB -> one float channel with cupoch's weights (image_factory.cu
    CreateFloatImage: 0.2990, 0.5870, 0.1140)."""
    w = torch.tensor(INTENSITY_WEIGHTS, dtype=torch.float32,
                     device=img.device)
    return (img * w).sum(-1, keepdim=True)


def float_value_at(img: torch.Tensor, u, v) -> torch.Tensor:
    """Bilinear sample of channel 0 at continuous pixel coordinates (u
    the column, v the row), with the neighbours clamped into the image
    (cupoch image.h FloatValueAt); batched over u and v of any shape."""
    H, W = img.shape[0], img.shape[1]
    f32 = dict(dtype=torch.float32, device=img.device)
    u = torch.as_tensor(u, **f32)
    v = torch.as_tensor(v, **f32)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    au = u - u0
    av = v - v0
    u0i = u0.to(torch.int64).clamp(0, W - 1)
    v0i = v0.to(torch.int64).clamp(0, H - 1)
    u1i = (u0i + 1).clamp(0, W - 1)
    v1i = (v0i + 1).clamp(0, H - 1)
    c = img[..., 0]
    p00, p01 = c[v0i, u0i], c[v0i, u1i]
    p10, p11 = c[v1i, u0i], c[v1i, u1i]
    return ((1 - av) * ((1 - au) * p00 + au * p01)
            + av * ((1 - au) * p10 + au * p11))


def pixel_grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(column, row) coordinates of every pixel, each [H, W] f32."""
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                         device=device),
                            torch.arange(W, dtype=torch.float32,
                                         device=device), indexing="ij")
    return uu, vv


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def depth_to_camera_distance_multiplier(width: int, height: int,
                                        intrinsic_matrix, device
                                        ) -> torch.Tensor:
    """Per-pixel factor from z-depth to the distance along the pixel's
    ray, [H, W, 1] (cupoch image_factory.cu
    CreateDepthToCameraDistanceMultiplierFloatImage)."""
    K = np.asarray(intrinsic_matrix, np.float32)
    fx, fy, cx, cy = (_f32(K[0, 0], device), _f32(K[1, 1], device),
                      _f32(K[0, 2], device), _f32(K[1, 2], device))
    uu, vv = pixel_grid(height, width, device)
    xx = (uu - cx) / fx
    yy = (vv - cy) / fy
    return torch.sqrt(xx * xx + yy * yy + 1.0)[..., None]


def depth_to_points(depth: torch.Tensor, intrinsic_matrix, extrinsic=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Back-project a depth image to points (cupoch pointcloud_factory.cu
    depth_to_pointcloud_functor): ([H*W, 3] points, [H*W] mask of finite
    positive depths), in the camera frame, or in the world frame of the
    world-to-camera `extrinsic`."""
    dev = depth.device
    K = torch.as_tensor(np.asarray(intrinsic_matrix, np.float32), device=dev)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d = depth[..., 0] if depth.ndim == 3 else depth
    H, W = d.shape
    uu, vv = pixel_grid(H, W, dev)
    x = (uu - cx) * d / fx
    y = (vv - cy) * d / fy
    pts = torch.stack([x, y, d], -1).reshape(-1, 3)
    mask = ((d > 0.0) & torch.isfinite(d)).reshape(-1)
    if extrinsic is not None:
        T = torch.as_tensor(np.asarray(extrinsic, np.float32), device=dev)
        pts = (pts - T[:3, 3]) @ T[:3, :3]      # R^T (p - t), as rows
    return pts, mask
