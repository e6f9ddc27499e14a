"""Truncated-Gaussian moments over the run grid: the FilterReg E-step.

For every binned query, with c' its cell-centred candidates within the
truncation radius r and e = exp(-d^2 / (2 sigma^2)):
m0 = sum e, m1 = sum e c' (3), m2 = sum e |c'|^2.

`gmm_pass` is the wrapper. On CUDA tensors it launches the hand-written
kernel `csrc/rungrid_gmm.cu` (which replaces the TPU kernel
`_make_gmm_kernel`, cupoch_tpu/knn/rungrid.py:1141) and counts the
launch in `launches`; on CPU tensors it runs `gmm_plain`, the plain
PyTorch version (the JAX package's `_gmm_moments_xla`). There is no
fallback from one to the other. `gmm_moments` shifts the centred
moments to the world frame after either.
"""
from __future__ import annotations

import ctypes

import torch

from ..utility import nvcc
from .rungrid import NPARAMS, WINDOW, RunGrid, cell_centers
from .rungrid_fused import MAX_KC, MAX_QCAP

#: kernel launches since the count was last set to 0
launches = 0

# bytes of one [cells, qcap, KC] f32 block `gmm_plain` holds
_PLAIN_CHUNK_BYTES = 1 << 28


def _check(grid: RunGrid, qsoa, qidx, params):
    cp, nq, qcap = qsoa.shape
    KC = grid.kc
    if qsoa.dtype != torch.float32 or grid.cand.dtype != torch.float32 \
            or grid.bounds.dtype != torch.float32 \
            or params.dtype != torch.float32:
        raise TypeError("gmm pass takes float32 qsoa, cand, bounds and "
                        "params")
    if qidx.dtype != torch.int32:
        raise TypeError("gmm pass takes int32 qidx")
    if nq < 3 or grid.cand.shape != (cp, 4, KC) \
            or qidx.shape != (cp, qcap) \
            or grid.bounds.shape != (cp, KC // WINDOW) \
            or params.shape != (NPARAMS,):
        raise ValueError(f"shapes do not match: qsoa {tuple(qsoa.shape)}, "
                         f"qidx {tuple(qidx.shape)}, cand "
                         f"{tuple(grid.cand.shape)}, params "
                         f"{tuple(params.shape)}")
    if KC % WINDOW or KC > MAX_KC or qcap > MAX_QCAP:
        raise ValueError(f"KC {KC} must be a multiple of {WINDOW} up to "
                         f"{MAX_KC}, qcap {qcap} at most {MAX_QCAP}")
    tensors = (qsoa, qidx, params, grid.cand, grid.bounds)
    if any(t.device != qsoa.device for t in tensors):
        raise ValueError("the grid, queries and params must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gmm pass takes contiguous tensors")


def gmm_pass(grid: RunGrid, qsoa, qidx, params):
    """Centred moments (m0, m1x, m1y, m1z, m2), each [Cp, qcap] f32, 0
    for empty query slots. params as `make_params` with r = truncation
    radius and params[17] = 1/(2 sigma^2)."""
    global launches
    _check(grid, qsoa, qidx, params)
    dev = qsoa.device
    if dev.type == "cpu":
        return gmm_plain(grid, qsoa, qidx, params)
    if dev.type != "cuda":
        raise ValueError(f"gmm pass runs on cuda or cpu, not {dev}")
    if grid.cand.data_ptr() % 16:
        raise ValueError("cand must be 16-byte aligned")
    cp, nq, qcap = qsoa.shape
    fn = nvcc.load("rungrid_gmm").rungrid_gmm_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((5, cp, qcap), dtype=torch.float32, device=dev)
    Gx, Gy, Gz = grid.dims
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(params.data_ptr(), qsoa.data_ptr(), qidx.data_ptr(),
                 grid.cand.data_ptr(), grid.bounds.data_ptr(),
                 out.data_ptr(), cp, nq, qcap, grid.kc, Gx, Gy, Gz, stream)
    if err != 0:
        raise RuntimeError(f"rungrid_gmm launch failed: CUDA error {err}")
    launches += 1
    return tuple(out.unbind(0))


def occupancy(qcap: int) -> tuple:
    """(blocks an SM holds at once, warps a block) of the kernel that
    `gmm_pass` launches at this qcap, as the CUDA runtime reports them
    on the current card."""
    fn = nvcc.load("rungrid_gmm").rungrid_gmm_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    blocks = fn(qcap, ctypes.byref(warps))
    if blocks < 0:
        raise RuntimeError(f"rungrid_gmm occupancy: CUDA error {-blocks}")
    return blocks, warps.value


def gmm_plain(grid: RunGrid, qsoa, qidx, params):
    """Plain PyTorch version of the moments pass (every lane, no window
    gating), through chunks of cells."""
    cp, nq, qcap = qsoa.shape
    KC = grid.kc
    R, t, r2, inv_2s2 = params[:9], params[9:12], params[12], params[17]
    centers = cell_centers(grid.dims, params[13:16], params[16], cp)
    out = torch.empty((5, cp, qcap), dtype=torch.float32, device=qsoa.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (qcap * KC * 4))
    for c0 in range(0, cp, step):
        q = qsoa[c0:c0 + step]
        c = grid.cand[c0:c0 + step]
        cen = centers[c0:c0 + step]
        qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
        ex = R[0] * qx + R[1] * qy + R[2] * qz + t[0] - cen[:, 0, None]
        ey = R[3] * qx + R[4] * qy + R[5] * qz + t[1] - cen[:, 1, None]
        ez = R[6] * qx + R[7] * qy + R[8] * qz + t[2] - cen[:, 2, None]
        qn = ex * ex + ey * ey + ez * ez
        d2 = c[:, 3, None, :] + ex[..., None] * c[:, 0, None, :]
        d2 = d2 + ey[..., None] * c[:, 1, None, :]
        d2 = d2 + ez[..., None] * c[:, 2, None, :] + qn[..., None]
        w = torch.where(d2 <= r2, torch.exp(-d2.clamp(min=0.0) * inv_2s2),
                        0.0)
        del d2
        w = w * (qidx[c0:c0 + step] >= 0)[..., None]
        out[0, c0:c0 + step] = w.sum(-1)
        for i in range(3):
            out[1 + i, c0:c0 + step] = (w * -0.5 * c[:, i, None, :]).sum(-1)
        out[4, c0:c0 + step] = (w * c[:, 3, None, :]).sum(-1)
    return tuple(out.unbind(0))


def gmm_moments(grid: RunGrid, qsoa, qidx, params):
    """Gaussian moments (m0 [Cp, qcap], M1 [Cp, qcap, 3] world, M2 world
    sum e |y|^2) of the target cloud at each (transformed) query."""
    m0, m1x, m1y, m1z, m2 = gmm_pass(grid, qsoa, qidx, params)
    # shift centered moments to world frame:
    # M1 = m1' + cc*m0 ; M2 = m2' + 2 cc.m1' + |cc|^2 m0
    cp = qsoa.shape[0]
    centers = cell_centers(grid.dims, params[13:16], params[16], cp)
    cx, cy, cz = centers[:, 0:1], centers[:, 1:2], centers[:, 2:3]
    M1 = torch.stack([m1x + cx * m0, m1y + cy * m0, m1z + cz * m0], -1)
    M2 = m2 + 2.0 * (cx * m1x + cy * m1y + cz * m1z) \
        + (cx * cx + cy * cy + cz * cz) * m0
    return m0, M1, M2
