"""Image filters of cupoch's RGB-D path in plain PyTorch, on [H, W]
tensors: separable 3-tap filters as sums of shifted copies of an
edge-clamped image (the vertical pass first, NaN reaching every pixel
whose window holds it), the 2x2 mean down-sampling, and the intensity
of an RGB image (0.299, 0.587, 0.114)."""
from __future__ import annotations

import torch

GAUSS = (0.25, 0.5, 0.25)
EDGE = (-1.0, 0.0, 1.0)
SMOOTH = (1.0, 2.0, 1.0)


def _sep(x, kx, ky):
    H, W = x.shape
    rows = torch.arange(-1, H + 1, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=x.device).clamp(0, W - 1)
    p = x[rows][:, cols]
    v = None
    for i, k in enumerate(ky):
        term = p[i:i + H] * k
        v = term if v is None else v + term
    out = None
    for i, k in enumerate(kx):
        term = v[:, i:i + W] * k
        out = term if out is None else out + term
    return out


def gauss3(x):
    return _sep(x, GAUSS, GAUSS)


def sobel_dx(x):
    return _sep(x, EDGE, SMOOTH)


def sobel_dy(x):
    return _sep(x, SMOOTH, EDGE)


def down2(x):
    H, W = x.shape[0] // 2, x.shape[1] // 2
    return x[:2 * H, :2 * W].reshape(H, 2, W, 2, *x.shape[2:]).mean(
        dim=(1, 3))


def intensity(rgb_u8, dtype=torch.float32):
    f = rgb_u8.to(dtype) / 255.0
    w = torch.tensor((0.2990, 0.5870, 0.1140), dtype=dtype,
                     device=rgb_u8.device)
    return (f * w).sum(-1)


def pixel_grid(H, W, device, dtype=torch.float32):
    v, u = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device),
                          indexing="ij")
    return u, v
