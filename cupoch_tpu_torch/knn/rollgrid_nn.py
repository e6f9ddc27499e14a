"""Nearest-candidate reduce of the roll and cell grids (kernel 4): for
every binned query of every cell, the nearest of the cell's KC
neighbourhood candidates within r.

`nn_reduce` is the wrapper. On CUDA tensors it launches the
hand-written kernel `csrc/rollgrid_nn.cu` (which replaces the TPU
kernel `_nn_reduce_kernel`, cupoch_tpu/knn/rollgrid.py:215) and counts
the launch in `launches`; on CPU tensors it runs `nn_reduce_plain`, the
plain PyTorch version of the same function (the JAX package's
`_nn_reduce_xla`). There is no fallback from one to the other: a CUDA
tensor launches the kernel or raises.

Both compute, in f32 with every operation rounded on its own,
  d2[q, k] = (dx dx + dy dy) + dz dz,   d = q - c_k,
then bd2 = min over all k, and among the lanes with d2 <= bd2 and
d2 <= r^2 the smallest candidate index; ok = bd2 <= r^2 gives
(index, bd2), else (-1, inf). So the two agree bit for bit.

The kernel stages each row in ascending candidate-index order, real
lanes first, so a strict `<` keeps the smallest index of a tie; the
order comes from `lane_rank`, which every grid keeps beside its
candidates (`cand_rank`), computed once.
"""
from __future__ import annotations

import ctypes

import torch

from ..utility import nvcc

INVALID_INDEX = -1

#: kernel launches since the count was last set to 0
launches = 0

# bytes of one [cells, qcap, KC] f32 distance block `nn_reduce_plain`
# holds at once
_PLAIN_CHUNK_BYTES = 1 << 28
# lanes `lane_rank` sorts at once
_RANK_CHUNK_LANES = 1 << 24


def lane_rank(cand_idx: torch.Tensor) -> torch.Tensor:
    """[C, KC] int16: each lane's position when its row is ordered by
    candidate index, the real lanes (index >= 0) first in ascending
    index and the empty ones (-1) after them. Kernel 4 stages a row in
    this order; the plain version does not need it. Rows are sorted a
    chunk at a time, so the sort's temporaries stay near
    `_RANK_CHUNK_LANES` lanes (8 bytes each) whatever the grid's size."""
    C, KC = cand_idx.shape
    if KC >= 1 << 15:
        raise ValueError(f"lane_rank takes rows under 32768 lanes, not {KC}")
    rank = torch.empty((C, KC), dtype=torch.int16, device=cand_idx.device)
    pos = torch.arange(KC, dtype=torch.int16, device=cand_idx.device)
    step = max(1, _RANK_CHUNK_LANES // max(KC, 1))
    for c0 in range(0, C, step):
        ci = cand_idx[c0:c0 + step]
        key = torch.where(ci < 0, torch.iinfo(torch.int32).max, ci)
        order = torch.argsort(key, dim=1, stable=True)
        rank[c0:c0 + step].scatter_(1, order, pos.expand_as(order))
    return rank


def _check(q_soa, cand, cidx):
    C, three, qcap = q_soa.shape
    if q_soa.dtype != torch.float32 or cand.dtype != torch.float32 \
            or cidx.dtype != torch.int32:
        raise TypeError("nn reduce takes float32 q_soa and cand, int32 cidx")
    if three != 3 or cand.shape[:2] != (C, 3) \
            or cidx.shape != (C, cand.shape[2]):
        raise ValueError(f"shapes do not match: q_soa {tuple(q_soa.shape)}, "
                         f"cand {tuple(cand.shape)}, cidx "
                         f"{tuple(cidx.shape)}")
    if not (q_soa.device == cand.device == cidx.device):
        raise ValueError("q_soa, cand and cidx must share a device")
    if not (q_soa.is_contiguous() and cand.is_contiguous()
            and cidx.is_contiguous()):
        raise ValueError("nn reduce takes contiguous tensors")


def nn_reduce(q_soa: torch.Tensor, cand: torch.Tensor, cidx: torch.Tensor,
              r2, rank=None) -> tuple:
    """(idx [C, qcap] int32, -1 none; d2 [C, qcap] f32, inf none).

    q_soa [C, 3, qcap] f32 binned queries (empty slots hold 1e18 in
    every coordinate), cand [C, 3, KC] f32 candidates (empty: 3e18),
    cidx [C, KC] int32 candidate indices, r2 the f32 squared radius (a
    float or a 0-d tensor on the host), rank [C, KC] int16 the grid's
    `lane_rank(cidx)` (the kernel needs it; the plain version ignores
    it)."""
    global launches
    _check(q_soa, cand, cidx)
    r2 = float(torch.as_tensor(r2, dtype=torch.float32))
    if not r2 < 1e30:
        # the fills' squared distances (1e36 and up) must stay above r2
        raise ValueError(f"nn reduce needs r2 < 1e30, got {r2}")
    dev = q_soa.device
    if dev.type == "cpu":
        return nn_reduce_plain(q_soa, cand, cidx, r2)
    if dev.type != "cuda":
        raise ValueError(f"nn reduce runs on cuda or cpu, not {dev}")
    if rank is None or rank.dtype != torch.int16 \
            or rank.shape != cidx.shape or rank.device != dev \
            or not rank.is_contiguous():
        raise ValueError("the kernel needs the grid's lane rank: a "
                         "contiguous int16 tensor shaped as cidx, on its "
                         "device (lane_rank(cidx))")
    C, _, qcap = q_soa.shape
    fn = nvcc.load("rollgrid_nn").rollgrid_nn_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    idx = torch.empty((C, qcap), dtype=torch.int32, device=dev)
    d2 = torch.empty((C, qcap), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q_soa.data_ptr(), cand.data_ptr(), cidx.data_ptr(),
                 rank.data_ptr(), idx.data_ptr(), d2.data_ptr(), r2, C, qcap,
                 cand.shape[2], stream)
    if err != 0:
        raise RuntimeError(f"rollgrid_nn launch failed: CUDA error {err}")
    launches += 1
    return idx, d2


def occupancy(qcap: int, KC: int) -> tuple:
    """(blocks an SM holds at once, warps a block) of the kernel that
    `nn_reduce` launches at these shapes, as the CUDA runtime reports
    them on the current card."""
    fn = nvcc.load("rollgrid_nn").rollgrid_nn_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    blocks = fn(qcap, KC, ctypes.byref(warps))
    if blocks < 0:
        raise RuntimeError(f"rollgrid_nn occupancy: CUDA error {-blocks}")
    return blocks, warps.value


def nn_reduce_plain(q_soa: torch.Tensor, cand: torch.Tensor,
                    cidx: torch.Tensor, r2) -> tuple:
    """Plain PyTorch version of kernel 4, through chunks of cells so the
    [cells, qcap, KC] distances never exist for all cells at once."""
    C, _, qcap = q_soa.shape
    KC = cand.shape[2]
    r2 = float(torch.as_tensor(r2, dtype=torch.float32))
    idx = torch.empty((C, qcap), dtype=torch.int32, device=q_soa.device)
    d2o = torch.empty((C, qcap), dtype=torch.float32, device=q_soa.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, qcap * KC * 4))
    for c0 in range(0, C, step):
        q = q_soa[c0:c0 + step]
        c = cand[c0:c0 + step]
        dx = q[:, 0, :, None] - c[:, 0, None, :]
        dy = q[:, 1, :, None] - c[:, 1, None, :]
        dz = q[:, 2, :, None] - c[:, 2, None, :]
        d2 = dx * dx + dy * dy + dz * dz                # [n, qcap, KC]
        del dx, dy, dz
        bd2 = d2.min(-1).values
        sel = (d2 <= bd2[..., None]) & (d2 <= r2)
        del d2
        bidx = torch.where(sel, cidx[c0:c0 + step, None, :],
                           1 << 30).min(-1).values
        ok = bd2 <= r2
        idx[c0:c0 + step] = torch.where(ok, bidx, INVALID_INDEX)
        d2o[c0:c0 + step] = torch.where(ok, bd2, float("inf"))
    return idx, d2o
