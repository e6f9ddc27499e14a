"""Tiled brute-force nearest-neighbour search (counterpart of the JAX
package's `knn/bruteforce.py`; cupoch knn/kdtree_flann.h, bruteforce_nn.h).

`knn_search` and `hybrid_search` take pairwise squared distances as
|q|^2 + |p|^2 - 2 q.p with the cross term as one `torch.matmul` per
query tile, in full f32 (the package turns TF32 off at import). Outputs
follow the reference contract: dense [Q, k] index / squared-distance
tensors padded with -1 / +inf.

`nn_search` (1-NN) is the wrapper of the hand-written kernel
`csrc/bruteforce_nn.cu`, which replaces no TPU kernel (the JAX package
scores with one bf16 matrix product a tile). On CUDA tensors it
launches the kernel and counts the launch in `launches`; on CPU tensors
it runs `nn_search_plain`, the plain PyTorch version. There is no
fallback from one to the other: a CUDA tensor launches the kernel or
raises. Both score the exact distance
  d2 = (dx dx + dy dy) + dz dz,   d = q - p,
every operation rounded on its own, and keep the least d2 and, on a
tie, the least index, so the two agree bit for bit. The JAX package's
8+8+8-bit split of |p|^2 - 2 q.p may pick another winner on ties at
about 2^-24 relative; it recomputes the winner's distance in f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utility import nvcc, trace
from ..utility.shape import INVALID_INDEX

_DEFAULT_TILE = 1024

#: `nn_search` kernel launches since the count was last set to 0
launches = 0

# bytes of one of the two [T, N] f32 blocks `nn_search_plain` holds
_PLAIN_CHUNK_BYTES = 1 << 28


def _tiles(q: torch.Tensor, tile: int):
    return [q[i:i + tile] for i in range(0, max(q.shape[0], 1), tile)]


def _pairwise_dist2(q_tile: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[T, D] x [N, D] -> [T, N] squared distances, clamped at 0."""
    qn = (q_tile * q_tile).sum(-1, keepdim=True)
    dn = (data * data).sum(-1)
    d2 = qn + dn[None, :] - 2.0 * (q_tile @ data.T)
    return d2.clamp(min=0.0)


def knn_search(queries: torch.Tensor, data: torch.Tensor, k: int,
               data_mask: Optional[torch.Tensor] = None,
               tile: int = _DEFAULT_TILE
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN: (indices [Q, k] int32, dist2 [Q, k] f32), sorted by
    distance, -1 / inf past the valid data points."""
    N = data.shape[0]
    Q = queries.shape[0]
    k_eff = min(k, N)
    idxs, d2s = [], []
    for q in _tiles(queries, tile):
        d2 = _pairwise_dist2(q, data)
        if data_mask is not None:
            d2 = torch.where(data_mask[None, :], d2, float("inf"))
        v, i = torch.topk(d2, k_eff, dim=-1, largest=False, sorted=True)
        idxs.append(i.to(torch.int32))
        d2s.append(v)
    idx = torch.cat(idxs)[:Q]
    d2 = torch.cat(d2s)[:Q]
    if k_eff < k:
        idx = torch.cat([idx, idx.new_full((Q, k - k_eff), INVALID_INDEX)],
                        -1)
        d2 = torch.cat([d2, d2.new_full((Q, k - k_eff), float("inf"))], -1)
    idx = torch.where(torch.isfinite(d2), idx, INVALID_INDEX)
    return idx, d2


def hybrid_search(queries: torch.Tensor, data: torch.Tensor, radius,
                  max_nn: int, data_mask: Optional[torch.Tensor] = None,
                  tile: int = _DEFAULT_TILE):
    """Radius-bounded k-NN (cupoch SearchHybrid): (indices [Q, max_nn],
    dist2 [Q, max_nn], counts [Q] int32); slots beyond the radius are
    -1 / inf."""
    idx, d2 = knn_search(queries, data, max_nn, data_mask=data_mask,
                         tile=tile)
    r2 = torch.as_tensor(radius, dtype=torch.float32) ** 2
    within = d2 <= r2.to(d2.device)
    idx = torch.where(within, idx, INVALID_INDEX)
    d2 = torch.where(within, d2, float("inf"))
    return idx, d2, within.sum(-1).to(torch.int32)


def _counts(queries, data, n_queries, n_data):
    Q, N = queries.shape[0], data.shape[0]
    nq = Q if n_queries is None else int(n_queries)
    nd = N if n_data is None else int(n_data)
    if not (0 <= nq <= Q and 0 <= nd <= N):
        raise ValueError(f"prefix counts ({nq}, {nd}) outside the clouds' "
                         f"sizes ({Q}, {N})")
    return nq, nd


def _check(queries, data, data_mask):
    if queries.dtype != torch.float32 or data.dtype != torch.float32:
        raise TypeError("nn_search takes float32 queries and data")
    if queries.dim() != 2 or queries.shape[1] != 3 or data.dim() != 2 \
            or data.shape[1] != 3:
        raise ValueError(f"nn_search takes [Q, 3] and [N, 3] clouds, not "
                         f"{tuple(queries.shape)} and {tuple(data.shape)}")
    if max(queries.shape[0], data.shape[0]) > 1 << 30:
        raise ValueError("nn_search takes clouds of at most 2^30 points")
    if queries.device != data.device:
        raise ValueError("queries and data must share a device")
    if data_mask is not None and (
            data_mask.dtype != torch.bool
            or data_mask.shape != (data.shape[0],)
            or data_mask.device != data.device):
        raise ValueError("data_mask must be a bool [N] tensor on the data's "
                         "device")
    if not (queries.is_contiguous() and data.is_contiguous() and (
            data_mask is None or data_mask.is_contiguous())):
        raise ValueError("nn_search takes contiguous tensors")


def nn_search(queries: torch.Tensor, data: torch.Tensor,
              data_mask: Optional[torch.Tensor] = None, tile: int = 4096,
              n_queries: Optional[int] = None, n_data: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN: (index [Q] int32, dist2 [Q] f32), the least exact squared
    distance over the unmasked data points and, on a tie, the least
    index; (-1, inf) where no data point is unmasked.

    `n_queries` and `n_data` (host integers) are prefix counts: only the
    first `n_queries` queries and the first `n_data` data points are
    scored, the other queries get (-1, inf). A padded cloud passes its
    count, so the padding costs nothing. `tile` is taken for the JAX
    package's signature and not read: the kernel tiles on its own, the
    plain version by `_PLAIN_CHUNK_BYTES`."""
    global launches
    _check(queries, data, data_mask)
    nq, nd = _counts(queries, data, n_queries, n_data)
    trace.count("bruteforce.pairs", nq * nd)
    dev = queries.device
    if dev.type == "cpu":
        return nn_search_plain(queries, data, data_mask, nq, nd)
    if dev.type != "cuda":
        raise ValueError(f"nn_search runs on cuda or cpu, not {dev}")
    Q = queries.shape[0]
    lib = nvcc.load("bruteforce_nn")
    size = lib.bruteforce_nn_scratch_bytes
    size.argtypes = [ctypes.c_int] * 2
    size.restype = ctypes.c_longlong
    fn = lib.bruteforce_nn_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = torch.empty(size(Q, nd), dtype=torch.uint8, device=dev)
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    d2 = torch.empty(Q, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(queries.data_ptr(), data.data_ptr(),
                 None if data_mask is None else data_mask.data_ptr(),
                 scratch.data_ptr(), idx.data_ptr(), d2.data_ptr(), Q, nq,
                 nd, stream)
    if err != 0:
        raise RuntimeError(f"bruteforce_nn launch failed: CUDA error {err}")
    launches += 1
    return idx, d2


def nn_search_plain(queries: torch.Tensor, data: torch.Tensor,
                    data_mask: Optional[torch.Tensor] = None,
                    n_queries: Optional[int] = None,
                    n_data: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `nn_search`'s kernel, on any device: the
    same arithmetic and tie rule, as many queries at a time as keep the
    chunk's [T, N] distances within `_PLAIN_CHUNK_BYTES`."""
    nq, nd = _counts(queries, data, n_queries, n_data)
    Q, dev = queries.shape[0], queries.device
    idx = torch.full((Q,), INVALID_INDEX, dtype=torch.int32, device=dev)
    d2o = torch.full((Q,), float("inf"), dtype=torch.float32, device=dev)
    if nq == 0 or nd == 0:
        return idx, d2o
    p = data[:nd]
    # NaN never wins the kernel's strict `<`, nor does +inf; only a
    # non-finite coordinate can make a NaN
    finite = bool(torch.isfinite(queries[:nq]).all()
                  & torch.isfinite(p).all())
    pt = p.T.contiguous()                   # [3, nd]
    if data_mask is not None:
        # as the kernel stages them: a masked point scores +inf or NaN
        pt = torch.where(data_mask[:nd], pt, float("inf"))
    step = max(1, min(nq, _PLAIN_CHUNK_BYTES // (4 * nd)))
    d2 = torch.empty((step, nd), dtype=torch.float32, device=dev)
    dc = torch.empty_like(d2)
    for q0 in range(0, nq, step):
        q = queries[q0:min(q0 + step, nq)]
        t = q.shape[0]
        a, b = d2[:t], dc[:t]
        torch.sub(q[:, 0:1], pt[0], out=a)
        a.mul_(a)
        for c in (1, 2):
            torch.sub(q[:, c:c + 1], pt[c], out=b)
            a.add_(b.mul_(b))               # (dx dx + dy dy) + dz dz
        if not finite:
            a.nan_to_num_(nan=float("inf"), posinf=float("inf"))
        best, first = a.min(-1)             # the first index of a tie
        ok = best < float("inf")
        idx[q0:q0 + t] = torch.where(ok, first.to(torch.int32),
                                     INVALID_INDEX)
        d2o[q0:q0 + t] = torch.where(ok, best, float("inf"))
    return idx, d2o
