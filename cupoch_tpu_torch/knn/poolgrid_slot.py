"""Slot pass of the pooled grid: for every pooled query, the candidate
slot of its cell's 27-neighbourhood with the least packed key.

`slot_pass` is the wrapper. On CUDA tensors it launches the
hand-written kernel `csrc/poolgrid_slot.cu` (which replaces the TPU
kernel `_make_slim_kernel`, cupoch_tpu/knn/poolgrid.py:724) and counts
the launch in `launches`; on CPU tensors it runs `slot_plain`, the
plain PyTorch version of the same arithmetic. There is no fallback
from one to the other: a CUDA tensor launches the kernel or raises.

Both score in f32, in one fixed order,
  s = ((cn + cx' ex) + cy' ey) + cz' ez,   key = (bits(s + off) & ~0xFFF) | k,
with every multiply and add rounded on its own, so the two agree bit
for bit.
"""
from __future__ import annotations

import ctypes

import torch

from ..utility import nvcc

SLOT_MASK = 0xFFF  # low 12 bits of the packed key carry the slot

# the kernel's limits: cells a supertile, pooled queries (16-bit lists)
MAX_TILE = 64
MAX_QP = 1 << 16

#: kernel launches since the count was last set to 0
launches = 0

# bytes of gathered score rows `slot_plain` holds at once
_PLAIN_CHUNK_BYTES = 1 << 28


def _check(grid, qpool: torch.Tensor, params: torch.Tensor):
    table = grid.table
    G, CH, QP = qpool.shape
    if qpool.dtype != torch.float32 or table.dtype != torch.float32 \
            or params.dtype != torch.float32:
        raise TypeError("slot pass takes float32 qpool, table and params")
    if CH < 7 or params.numel() < 14:
        raise ValueError(f"qpool needs >= 7 rows and params >= 14 values, "
                         f"got {CH} and {params.numel()}")
    if table.shape != (G * grid.tile, grid.kc, 4):
        raise ValueError(f"table {tuple(table.shape)} does not match "
                         f"{G} supertiles of {grid.tile} cells x "
                         f"{grid.kc} slots")
    if grid.kc > SLOT_MASK + 1:
        raise ValueError(f"kc {grid.kc} exceeds the 12-bit slot field")
    if grid.tile > MAX_TILE or QP > MAX_QP:
        raise ValueError(f"the slot pass takes at most {MAX_TILE} cells a "
                         f"supertile and {MAX_QP} pooled queries, got "
                         f"{grid.tile} and {QP}")
    if not (qpool.device == table.device == params.device):
        raise ValueError("qpool, table and params must share a device")
    if not (qpool.is_contiguous() and table.is_contiguous()
            and params.is_contiguous()):
        raise ValueError("slot pass takes contiguous tensors")


def slot_pass(grid, qpool: torch.Tensor, params: torch.Tensor
              ) -> torch.Tensor:
    """[G, QP] int32 winning slot per pooled query (0 for empty lanes).

    grid: PoolGrid (its `table` [G*T, KC, 4] f32, `tile`, `kc`);
    qpool: [G, CH, QP] f32; params: [NPARAMS] f32 (`make_params`)."""
    global launches
    _check(grid, qpool, params)
    dev = qpool.device
    if dev.type == "cpu":
        return slot_plain(grid, qpool, params)
    if dev.type != "cuda":
        raise ValueError(f"slot pass runs on cuda or cpu, not {dev}")
    G, CH, QP = qpool.shape
    table = grid.table
    if table.data_ptr() % 16:
        raise ValueError("score table must be 16-byte aligned")
    fn = nvcc.load("poolgrid_slot").poolgrid_slot_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((G, QP), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(params.data_ptr(), qpool.data_ptr(), table.data_ptr(),
                 out.data_ptr(), G, CH, QP, grid.tile, grid.kc, stream)
    if err != 0:
        raise RuntimeError(f"poolgrid_slot launch failed: CUDA error {err}")
    launches += 1
    return out


def occupancy(QP: int, KC: int) -> tuple:
    """(blocks an SM holds at once, warps a block) of the kernel that
    `slot_pass` launches at these shapes, as the CUDA runtime reports
    them on the current card."""
    fn = nvcc.load("poolgrid_slot").poolgrid_slot_occupancy
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    blocks = fn(QP, KC, ctypes.byref(warps))
    if blocks < 0:
        raise RuntimeError(f"poolgrid_slot occupancy: CUDA error {-blocks}")
    return blocks, warps.value


def slot_plain(grid, qpool: torch.Tensor, params: torch.Tensor
               ) -> torch.Tensor:
    """Plain PyTorch version of the slot kernel (mirrors the JAX
    package's `_slot_xla`, with f32 scores). Works through chunks of
    supertiles so the gathered [QP, KC, 4] rows never exist for all
    supertiles at once."""
    table = grid.table
    G, CH, QP = qpool.shape
    T, KC = grid.tile, grid.kc
    dev = qpool.device
    R = params[:9]
    t = params[9:12]
    off = params[13]
    slots = torch.arange(KC, dtype=torch.int32, device=dev)
    out = torch.empty((G, QP), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_CHUNK_BYTES // (QP * KC * 16))
    for g0 in range(0, G, step):
        q = qpool[g0:g0 + step]
        tag = q[:, 3]
        rows = torch.arange(g0, g0 + q.shape[0], device=dev)[:, None] * T \
            + tag.clamp(min=0).long()
        c = table[rows]                                  # [n, QP, KC, 4]
        qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
        ex = (R[0] * qx + R[1] * qy + R[2] * qz + t[0]) - q[:, 4]
        ey = (R[3] * qx + R[4] * qy + R[5] * qz + t[1]) - q[:, 5]
        ez = (R[6] * qx + R[7] * qy + R[8] * qz + t[2]) - q[:, 6]
        s = c[..., 3] + c[..., 0] * ex[..., None]
        s = s + c[..., 1] * ey[..., None]
        s = s + c[..., 2] * ez[..., None]
        key = ((s + off).view(torch.int32) & ~SLOT_MASK) | slots
        best = key.min(-1).values & SLOT_MASK
        out[g0:g0 + q.shape[0]] = torch.where(tag >= 0, best, 0)
    return out
