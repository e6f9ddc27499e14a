"""Padding helpers for fixed-capacity tensors.

Variable-sized inputs are padded up to a *bucket* size (next power of
two, with a small floor) and carried with a validity mask, so the
shapes a kernel sees stay few and the JAX package's padded outputs
(`-1` / `inf` fill) compare one to one with the port's.
"""
from __future__ import annotations

import math

import torch

#: Sentinel index for invalid / padded entries of index tensors.
INVALID_INDEX = -1

_MIN_BUCKET = 8


def bucket_size(n: int, min_size: int = _MIN_BUCKET) -> int:
    """Round ``n`` up to the next power of two (>= min_size)."""
    if n <= min_size:
        return min_size
    return 1 << math.ceil(math.log2(n))


def pad_axis0(x: torch.Tensor, capacity: int, fill=0) -> torch.Tensor:
    """Pad ``x`` with ``fill`` along axis 0 up to ``capacity`` rows."""
    n = x.shape[0]
    if n == capacity:
        return x
    if n > capacity:
        raise ValueError(f"cannot pad {n} rows into capacity {capacity}")
    pad = torch.full((capacity - n,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], 0)


def valid_mask(count: int, capacity: int, device=None) -> torch.Tensor:
    """Boolean mask of shape [capacity], true for the first ``count``."""
    return torch.arange(capacity, device=device) < count


def compact_by_mask(x, mask):
    """Keep the rows of ``x`` where ``mask`` is true."""
    return x[torch.as_tensor(mask, device=x.device)]


def masked_min(x: torch.Tensor, mask: torch.Tensor, dim=None,
               big=float("inf")) -> torch.Tensor:
    v = torch.where(mask, x, big)
    return v.min() if dim is None else v.amin(dim)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim=None,
               small=float("-inf")) -> torch.Tensor:
    v = torch.where(mask, x, small)
    return v.max() if dim is None else v.amax(dim)


def masked_sum(x: torch.Tensor, mask: torch.Tensor, dim=None
               ) -> torch.Tensor:
    v = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                         device=x.device))
    return v.sum() if dim is None else v.sum(dim)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None
                ) -> torch.Tensor:
    s = masked_sum(x, mask, dim)
    c = mask.sum() if dim is None else mask.sum(dim)
    return s / c.clamp(min=1)


def moveaxis_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A [N] mask reshaped to broadcast against x of shape [N, ...]."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
