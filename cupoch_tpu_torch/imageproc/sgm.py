"""Semi-global stereo matching (cupoch imageproc/sgm.h:30-60, sgm.cpp,
which wrap libSGM).

The pipeline is integer from the census on, so its disparities are
exact: a 9x7 symmetric census into 31 bits of an int32, the Hamming
cost volume [H, W, D] in one gather, the path aggregations as scans
that carry [paths, T, D] slices (the six paths that scan rows run
together, reversed ones on mirrored row order; the two that scan
columns together), and winner-takes-all with the uniqueness and
left-right checks. The scans are sequential: at 640x480 about 1120
steps of a few dozen small launches each.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..geometry.image import Image
from ..utility import console
from ..utility.device import resolve_device

# a cost no path takes: the aggregated costs stay far below it
_BIG = 1 << 20


class SGMOption:
    """cupoch sgm.h:30-60 (libSGM's parameter set)."""

    DisparitySize64 = 64
    DisparitySize128 = 128
    DisparitySize256 = 256

    ScanPath4 = 0
    ScanPath8 = 1

    def __init__(self, width: int = 0, height: int = 0, p1: int = 10,
                 p2: int = 120, uniqueness: float = 0.95,
                 disp_size: int = DisparitySize128,
                 path_type: int = ScanPath8, min_disp: int = 0,
                 lr_max_diff: int = 1):
        self.width = int(width)
        self.height = int(height)
        self.p1 = int(p1)
        self.p2 = int(p2)
        self.uniqueness = float(uniqueness)
        self.disp_size = int(disp_size)
        self.path_type = int(path_type)
        self.min_disp = int(min_disp)
        self.lr_max_diff = int(lr_max_diff)


_CENSUS_W, _CENSUS_H = 9, 7   # 31 centre-symmetric pairs: one int32


def _census97(img: torch.Tensor) -> torch.Tensor:
    """Symmetric census of a float image [H, W] (libSGM
    census_transform.cu): bit i of the int32 result is I(p + o_i) >
    I(p - o_i) for the 31 centre-symmetric offset pairs of the 9x7
    window, the borders extended by their edge pixels."""
    rw, rh = _CENSUS_W // 2, _CENSUS_H // 2
    H, W = img.shape
    pad = F.pad(img[None, None], (rw, rw, rh, rh), mode="replicate")[0, 0]
    out = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    bit = 0
    for dy in range(-rh, rh + 1):
        for dx in range(-rw, rw + 1):
            if dy < 0 or (dy == 0 and dx <= 0):
                continue
            a = pad[rh + dy: rh + dy + H, rw + dx: rw + dx + W]
            b = pad[rh - dy: rh - dy + H, rw - dx: rw - dx + W]
            out |= (a > b).to(torch.int32) << bit
            bit += 1
    return out


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 values (31 bits), by SWAR with the
    byte counts summed by shifts (no product to overflow int32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def _cost_volume(cl: torch.Tensor, cr: torch.Tensor, disp_size: int,
                 min_disp: int) -> torch.Tensor:
    """[H, W, D] int32 Hamming distances between the left census and the
    right census rolled by each disparity d along the rows; a pixel with
    x < d (its match off the frame) costs 64."""
    H, W = cl.shape
    dev = cl.device
    d = torch.arange(min_disp, min_disp + disp_size, device=dev)
    x = torch.arange(W, device=dev)[:, None]
    shifted = cr[:, (x - d) % W]                        # [H, W, D]
    c = _popcount32(cl[..., None] ^ shifted)
    return torch.where(x >= d, c, 64)


def _scan_paths(cost: torch.Tensor, p1: int, p2: int,
                paths: Sequence[Tuple[bool, int]]) -> torch.Tensor:
    """The sum of the SGM aggregations along axis 0 of `cost` [S, T, D]
    of each path (reverse, shift) (libSGM path_aggregation.cu): a step
    adds a row's costs to the least of the carried row at the same
    disparity, at d +- 1 plus p1, and its least plus p2, less that
    least. A reversed path runs from the last row; `shift` (+-1, 0 for
    straight paths) rolls the carry one column a step, the column that
    wraps starting afresh at zero. The paths run together, one batched
    [paths, T, D] carry a step."""
    S, T, D = cost.shape
    dev = cost.device
    B = len(paths)
    step = torch.arange(S, device=dev)
    rows = torch.stack([S - 1 - step if rev else step for rev, _ in paths],
                       1)                                # [S, B]
    col = torch.arange(T, device=dev)
    src = torch.stack([(col - sh) % T for _, sh in paths])  # [B, T]
    keep = torch.ones((B, T, 1), dtype=torch.int32, device=dev)
    for b, (_, sh) in enumerate(paths):
        if sh:
            keep[b, 0 if sh > 0 else T - 1] = 0
    shifted = any(sh for _, sh in paths)
    src = src[:, :, None].expand(B, T, D)
    total = torch.zeros_like(cost)
    prev = torch.zeros((B, T, D), dtype=torch.int32, device=dev)
    for i in range(S):
        c = cost[rows[i]]                                # [B, T, D]
        prev_min = prev.amin(-1, keepdim=True)
        up = torch.cat([prev[..., :1] + _BIG, prev[..., :-1]], -1) + p1
        dn = torch.cat([prev[..., 1:], prev[..., -1:] + _BIG], -1) + p1
        best = torch.minimum(torch.minimum(prev, up),
                             torch.minimum(dn, prev_min + p2))
        out = c + best - prev_min
        total.index_add_(0, rows[i], out)
        prev = torch.gather(out, 1, src) * keep if shifted else out
    return total


def _aggregate_scan(cost: torch.Tensor, p1: int, p2: int, reverse: bool,
                    shift: int) -> torch.Tensor:
    """One path's aggregation along axis 0 of `cost` [S, T, D]."""
    return _scan_paths(cost, p1, p2, ((reverse, shift),))


def _aggregate(cost: torch.Tensor, p1: int, p2: int,
               num_paths: int) -> torch.Tensor:
    """The sum of the path aggregations (libSGM path_aggregation.cu): the
    vertical paths down and up, the diagonals for 8 paths (all six scan
    the rows), then the horizontal paths along the columns."""
    rows = [(False, 0), (True, 0)]
    if num_paths == 8:
        rows += [(False, 1), (False, -1), (True, 1), (True, -1)]
    total = _scan_paths(cost, p1, p2, rows)
    ct = cost.transpose(0, 1).contiguous()
    return total + _scan_paths(ct, p1, p2, ((False, 0), (True, 0))) \
        .transpose(0, 1)


def _select_disparity(S: torch.Tensor, uniqueness: float, min_disp: int,
                      lr_max_diff: int) -> torch.Tensor:
    """Winner-takes-all with the uniqueness and left-right checks
    (libSGM winner_takes_all.cu): the least-cost disparity (the first on
    ties), kept where every non-adjacent disparity's cost times
    `uniqueness` exceeds it and the right image's winner at the matched
    pixel lies within `lr_max_diff` (no check when negative); [H, W]
    int32, 0 where rejected."""
    H, W, D = S.shape
    dev = S.device
    best_d = torch.argmin(S, -1)
    best_c = S.amin(-1)
    d_idx = torch.arange(D, device=dev)
    adjacent = (d_idx - best_d[..., None]).abs() <= 1
    second = torch.where(adjacent, _BIG, S).amin(-1)
    unique_ok = second.to(torch.float32) * uniqueness \
        > best_c.to(torch.float32)
    # the right image's costs from the same volume: S_r[y, x, d] =
    # S[y, x + d, d]
    cols = torch.arange(W, device=dev)[:, None] + d_idx      # [W, D]
    S_right = torch.gather(S, 1, cols.clamp(max=W - 1)
                           .expand(H, W, D))
    right_d = torch.argmin(torch.where(cols < W, S_right, _BIG), -1)
    if lr_max_diff >= 0:
        xr = (torch.arange(W, device=dev) - best_d).clamp(0, W - 1)
        dr = torch.gather(right_d, 1, xr)
        valid = unique_ok & ((best_d - dr).abs() <= lr_max_diff)
    else:
        valid = unique_ok
    return torch.where(valid, best_d + min_disp, 0).to(torch.int32)


def compute_disparity(left: torch.Tensor, right: torch.Tensor, p1: int,
                      p2: int, uniqueness: float, disp_size: int,
                      num_paths: int, min_disp: int, lr_max_diff: int
                      ) -> torch.Tensor:
    """SGM on float images [H, W] on their device: census, cost volume,
    path aggregation, winner-takes-all. [H, W] int32 disparities."""
    cost = _cost_volume(_census97(left), _census97(right), disp_size,
                        min_disp)
    S = _aggregate(cost, int(p1), int(p2), num_paths)
    return _select_disparity(S, float(uniqueness), min_disp, lr_max_diff)


class SemiGlobalMatching:
    """cupoch sgm.h SemiGlobalMatching, sgm.cpp:46-62."""

    def __init__(self, option: Optional[SGMOption] = None):
        self.option = option or SGMOption()

    def process_frame(self, left, right) -> Image:
        """The disparity Image (uint8 [H, W, 1], 0 where no match) of a
        rectified grey pair (Images, tensors or arrays, [H, W] or [H, W,
        1]), on the left image's device (the card for an array)."""
        opt = self.option
        if opt.width == 0 or opt.height == 0:
            console.log_error("[SemiGlobalMatching::ProcessFrame] Invalid "
                              "SGM parameters.")
        li = getattr(left, "data", left)
        ri = getattr(right, "data", right)
        dev = li.device if isinstance(li, torch.Tensor) \
            else resolve_device(None)
        li = torch.as_tensor(li).to(dev, torch.float32)
        ri = torch.as_tensor(ri).to(dev, torch.float32)
        if li.ndim == 3:
            li = li[..., 0]
        if ri.ndim == 3:
            ri = ri[..., 0]
        if li.shape != ri.shape or tuple(li.shape) != (opt.height,
                                                       opt.width):
            console.log_error("[SemiGlobalMatching::ProcessFrame] "
                              "Unsupport image type.")
        disp = compute_disparity(
            li, ri, opt.p1, opt.p2, opt.uniqueness, opt.disp_size,
            8 if opt.path_type == SGMOption.ScanPath8 else 4,
            opt.min_disp, opt.lr_max_diff)
        dtype = torch.uint8 if opt.disp_size <= 256 else torch.uint16
        return Image(disp.to(dtype)[..., None], device=dev)
