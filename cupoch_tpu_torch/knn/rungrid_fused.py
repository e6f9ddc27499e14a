"""Fused pass over the run grid: every binned query's nearest candidate
within r, then either the correspondence pair (d2, -index) or the
reduced Gauss-Newton (or Kabsch) sums of the winners.

`fused_query` is the wrapper. On CUDA tensors it launches the
hand-written kernel `csrc/rungrid_fused.cu` (which replaces the TPU
kernel `_make_fused_kernel`, cupoch_tpu/knn/rungrid.py:603) and counts
the launch in `launches` under its mode; on CPU tensors it runs
`fused_plain`, the plain PyTorch version of the same function (the JAX
package's `_fused_query_xla`). There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.

Both score in f32 in one fixed order, every multiply and add rounded on
its own,
  t = ((R0 qx + R1 qy) + R2 qz) + t0,  e = t - cc,  qn = (ex ex + ey ey) + ez ez,
  v = ((cn + ex cx') + ey cy') + ez cz',
so the two pick the same winners and give the same d2 bit for bit. Ties
on the least v take the largest fetched word (per channel), as
`max(where(v <= m, src, fill))` does in the JAX mirror: in
correspondence mode the smallest original index.
"""
from __future__ import annotations

import ctypes

import torch

from ..utility import nvcc
from . import rungrid
from .rungrid import (
    EST_NONE, EST_PT2PT, EST_PT2PL, EST_SYM, INVALID_INDEX, N_SUMS,
    NPARAMS, RunGrid, _gn_terms, _unpack16, bin_queries, cell_centers,
    make_params, scatter_to_source,
)

#: kernel launches per mode since the counts were last set to 0
launches = {"corres": 0, "gn": 0}

MAX_KC = 4096
MAX_QCAP = 1024

# bytes of one [cells, qcap, KC] f32 score block `fused_plain` holds
_PLAIN_CHUNK_BYTES = 1 << 28

_INT_MIN = -(1 << 31)


def _n_query_rows(est: int, corres: bool) -> int:
    return 6 if est == EST_SYM and not corres else 3


def _check(grid: RunGrid, qsoa, qidx, params, est: int, corres: bool):
    cp, nq, qcap = qsoa.shape
    KC = grid.kc
    P = grid.attrp.shape[1]
    if qsoa.dtype != torch.float32 or grid.cand.dtype != torch.float32 \
            or params.dtype != torch.float32 \
            or grid.negidx.dtype != torch.float32 \
            or grid.bounds.dtype != torch.float32:
        raise TypeError("fused pass takes float32 qsoa, cand, negidx, "
                        "bounds and params")
    if qidx.dtype != torch.int32 or grid.attrp.dtype != torch.int32:
        raise TypeError("fused pass takes int32 qidx and attrp")
    if est not in (EST_NONE, EST_PT2PT, EST_PT2PL, EST_SYM):
        raise ValueError(f"fused pass: unknown estimator code {est}")
    if not corres and (est == EST_NONE or grid.est != est
                       or P != rungrid._n_packed(est)):
        raise ValueError(f"GN pass for estimator {est} needs a grid built "
                         f"for it (grid est {grid.est}, {P} packed words)")
    if nq < _n_query_rows(est, corres):
        raise ValueError(f"qsoa has {nq} rows, the pass reads "
                         f"{_n_query_rows(est, corres)}")
    if grid.cand.shape != (cp, 4, KC) or qidx.shape != (cp, qcap) \
            or grid.negidx.shape != (cp, KC) \
            or grid.attrp.shape != (cp, P, KC) \
            or grid.bounds.shape != (cp, KC // rungrid.WINDOW) \
            or params.shape != (NPARAMS,):
        raise ValueError(f"shapes do not match: qsoa {tuple(qsoa.shape)}, "
                         f"qidx {tuple(qidx.shape)}, cand "
                         f"{tuple(grid.cand.shape)}, attrp "
                         f"{tuple(grid.attrp.shape)}, params "
                         f"{tuple(params.shape)}")
    if KC % rungrid.WINDOW or KC > MAX_KC or qcap > MAX_QCAP:
        raise ValueError(f"KC {KC} must be a multiple of "
                         f"{rungrid.WINDOW} up to {MAX_KC}, qcap {qcap} "
                         f"at most {MAX_QCAP}")
    tensors = (qsoa, qidx, params, grid.cand, grid.attrp, grid.negidx,
               grid.bounds)
    if any(t.device != qsoa.device for t in tensors):
        raise ValueError("the grid, queries and params must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused pass takes contiguous tensors")


def fused_query(grid: RunGrid, qsoa, qidx, params, est: int,
                corres: bool):
    """One fused correspondence (+GN reduction) pass.

    qsoa [Cp, 3(+3 SYM), qcap] f32, qidx [Cp, qcap] int32, params
    [NPARAMS] f32 (`make_params`). Returns (d2 [Cp, qcap] (inf: none),
    negidx [Cp, qcap] (-index; 1: none)) when `corres`, else the
    [N_SUMS] summed GN (PT2PL, SYM) or Kabsch (PT2PT) terms."""
    _check(grid, qsoa, qidx, params, est, corres)
    dev = qsoa.device
    if dev.type == "cpu":
        return fused_plain(grid, qsoa, qidx, params, est, corres)
    if dev.type != "cuda":
        raise ValueError(f"fused pass runs on cuda or cpu, not {dev}")
    if grid.cand.data_ptr() % 16:
        raise ValueError("cand must be 16-byte aligned")
    cp, nq, qcap = qsoa.shape
    fn = nvcc.load("rungrid_fused").rungrid_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if corres:
        out0 = torch.empty((cp, qcap), dtype=torch.float32, device=dev)
        out1 = torch.empty((cp, qcap), dtype=torch.float32, device=dev)
        words = grid.negidx
    else:
        out0 = torch.empty((cp, N_SUMS), dtype=torch.float32, device=dev)
        out1 = out0
        words = grid.attrp
    Gx, Gy, Gz = grid.dims
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(params.data_ptr(), qsoa.data_ptr(), qidx.data_ptr(),
                 grid.cand.data_ptr(), words.data_ptr(),
                 grid.bounds.data_ptr(), out0.data_ptr(), out1.data_ptr(),
                 cp, nq, qcap, grid.kc, grid.attrp.shape[1], est,
                 int(corres), Gx, Gy, Gz, stream)
    if err != 0:
        raise RuntimeError(f"rungrid_fused launch failed: CUDA error {err}")
    launches["corres" if corres else "gn"] += 1
    if corres:
        return out0, out1
    return out0.sum(0)


def occupancy(qcap: int, P: int, est: int, corres: bool) -> tuple:
    """(blocks an SM holds at once, warps a block) of the kernel that
    `fused_query` launches for this mode at this qcap, as the CUDA
    runtime reports them on the current card."""
    fn = nvcc.load("rungrid_fused").rungrid_fused_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    blocks = fn(qcap, P, est, int(corres), ctypes.byref(warps))
    if blocks < 0:
        raise RuntimeError(f"rungrid_fused occupancy: CUDA error {-blocks}")
    return blocks, warps.value


def fused_plain(grid: RunGrid, qsoa, qidx, params, est: int,
                corres: bool):
    """Plain PyTorch version of the fused pass (mirrors the JAX
    package's `_fused_query_xla`: every lane scored, no window gating).
    Works through chunks of cells so the [cells, qcap, KC] scores
    never exist for all cells at once."""
    cp, nq, qcap = qsoa.shape
    KC = grid.kc
    P = grid.attrp.shape[1]
    dev = qsoa.device
    R, t, r2 = params[:9], params[9:12], params[12]
    centers = cell_centers(grid.dims, params[13:16], params[16], cp)
    if corres:
        d2_out = torch.empty((cp, qcap), dtype=torch.float32, device=dev)
        ni_out = torch.empty((cp, qcap), dtype=torch.float32, device=dev)
    else:
        sums = torch.zeros(N_SUMS, dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK_BYTES // (qcap * KC * 4))
    for c0 in range(0, cp, step):
        q = qsoa[c0:c0 + step]
        qi = qidx[c0:c0 + step]
        c = grid.cand[c0:c0 + step]
        cen = centers[c0:c0 + step]
        qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
        tx = R[0] * qx + R[1] * qy + R[2] * qz + t[0]
        ty = R[3] * qx + R[4] * qy + R[5] * qz + t[1]
        tz = R[6] * qx + R[7] * qy + R[8] * qz + t[2]
        ccx, ccy, ccz = cen[:, 0, None], cen[:, 1, None], cen[:, 2, None]
        ex, ey, ez = tx - ccx, ty - ccy, tz - ccz
        qn = ex * ex + ey * ey + ez * ez
        v = c[:, 3, None, :] + ex[..., None] * c[:, 0, None, :]
        v = v + ey[..., None] * c[:, 1, None, :]
        v = v + ez[..., None] * c[:, 2, None, :]
        m = v.min(-1).values
        d2 = m + qn
        ok = (qi >= 0) & (d2 <= r2)
        eq = v <= m[..., None]
        del v
        if corres:
            ni = grid.negidx[c0:c0 + step]
            fi = torch.where(eq, ni[:, None, :], float("-inf")).max(-1) \
                .values
            d2_out[c0:c0 + step] = torch.where(ok, d2.clamp(min=0.0),
                                               float("inf"))
            ni_out[c0:c0 + step] = torch.where(ok, fi,
                                               -float(INVALID_INDEX))
            continue
        a = grid.attrp[c0:c0 + step]
        fetched = []
        for ch in range(P):
            w = torch.where(eq, a[:, ch, None, :], _INT_MIN).max(-1).values
            for high in (False, True):
                f = 2 * ch + int(high)
                fetched.append(_unpack16(w, params[18 + 2 * f],
                                         params[19 + 2 * f], high))
        d2c = torch.where(ok, d2.clamp(min=0.0), 0.0)
        src_n = None
        if est == EST_SYM:
            s0, s1, s2 = q[:, 3], q[:, 4], q[:, 5]
            src_n = (R[0] * s0 + R[1] * s1 + R[2] * s2,
                     R[3] * s0 + R[4] * s1 + R[5] * s2,
                     R[6] * s0 + R[7] * s1 + R[8] * s2)
        terms = _gn_terms(est, fetched, tx, ty, tz, ex, ey, ez,
                          ccx, ccy, ccz, src_n, ok, d2c)
        sums[:len(terms)] += torch.stack([x.sum() for x in terms])
    if corres:
        return d2_out, ni_out
    return sums


def query_nn_rungrid(grid: RunGrid, queries, radius, qcap: int,
                     query_mask=None):
    """1-NN within `radius` for a flat [Q, 3] query set: (index [Q]
    int32 or -1, dist2 [Q], inf for none)."""
    Q = queries.shape[0]
    qsoa, qidx = bin_queries(queries, queries, grid.origin, grid.cell_size,
                             grid.dims, qcap, mask=query_mask)
    params = make_params(torch.eye(4),
                         torch.tensor(radius, dtype=torch.float32) ** 2,
                         grid)
    d2, nidx = fused_query(grid, qsoa, qidx, params, EST_NONE, True)
    idx = torch.where(torch.isfinite(d2), -nidx,
                      float(INVALID_INDEX)).to(torch.int32)
    return (scatter_to_source(qidx, idx, Q, INVALID_INDEX),
            scatter_to_source(qidx, d2, Q, float("inf")))
