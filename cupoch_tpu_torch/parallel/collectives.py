"""A 1-D mesh of ranks and its collectives: the port's counterpart of a
one-axis `jax.sharding.Mesh` and of `psum`, `pmin`, `pmax` and
`ppermute` inside `shard_map`, with `all_gather` and broadcasts.

A `Mesh` holds a `torch.distributed` process group, this process's rank
in it, the group's size and the device the rank computes on. The
backend is the group's, which the caller chose when it created the
group: nothing here starts a group or picks a backend. At size 1 every
collective is the identity and no group is needed (gloo cannot send to
its own rank), as `ppermute` over `[(0, 0)]` is in JAX.

NCCL takes tensors on the card. Gloo's collectives take host tensors:
where the group is gloo and a tensor lies on the card, its payload goes
through a host copy, and `staged` / `staged_bytes` count those
collectives and the bytes of this rank's payload, so that a caller can
report them (ranks that share one card run so).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..utility.device import resolve_device


def _default_group():
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


class Mesh:
    """One axis of ranks.

    axis: the axis name (`POINTS_AXIS`, `EDGE_AXIS`, `BLOCK_AXIS`);
    group: the process group, default the initialised world (None and no
    initialised world: a mesh of one rank); device: where this rank
    computes (None: the current card)."""

    def __init__(self, axis: str, group=None, device=None):
        self.axis = axis
        self.group = _default_group() if group is None else group
        if self.group is None:
            self.size, self.rank, self.backend = 1, 0, None
        else:
            self.size = dist.get_world_size(self.group)
            self.rank = dist.get_rank(self.group)
            if self.rank < 0:
                raise ValueError("this process is not a member of the group")
            self.backend = str(dist.get_backend(self.group))
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        #: collectives whose payload went through the host, and its bytes
        self.staged = 0
        self.staged_bytes = 0

    def __repr__(self) -> str:
        return (f"Mesh({self.axis!r}, rank {self.rank} of {self.size}, "
                f"{self.backend or 'no group'}, {self.device})")

    def _global(self, group_rank: int) -> int:
        return dist.get_global_rank(self.group, group_rank)

    def _payload(self, t: torch.Tensor):
        """(the tensor a collective may overwrite, whether it is a host
        copy of a card tensor)."""
        if self.backend == "gloo" and t.is_cuda:
            self.staged += 1
            self.staged_bytes += t.numel() * t.element_size()
            return t.detach().cpu(), True
        return t.detach().clone(memory_format=torch.contiguous_format), \
            False

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return t
        buf, staged = self._payload(t)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device) if staged else buf

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks; every rank gets the same result."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def ppermute(self, t: torch.Tensor) -> torch.Tensor:
        """One step round the ring: send `t` to rank + 1, return what
        rank - 1 sent (JAX's `ppermute` with perm i -> i + 1)."""
        if self.size == 1:
            return t
        send, staged = self._payload(t)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send,
                          self._global((self.rank + 1) % self.size),
                          self.group),
               dist.P2POp(dist.irecv, recv,
                          self._global((self.rank - 1) % self.size),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(t.device) if staged else recv

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes) concatenated along axis 0 in
        rank order."""
        if self.size == 1:
            return t
        send, staged = self._payload(t)
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send, group=self.group)
        out = torch.cat(parts, 0)
        return out.to(t.device) if staged else out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank; the others pass a tensor of its
        shape and dtype, whose values are not read."""
        if self.size == 1:
            return t
        buf, staged = self._payload(t)
        dist.broadcast(buf, src=self._global(src), group=self.group)
        return buf.to(t.device) if staged else buf

    def broadcast_object(self, obj=None, src: int = 0):
        """Rank `src`'s picklable `obj` on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self._global(src),
                                   group=self.group)
        return box[0]


def shard_rows(n: int, mesh: Optional[Mesh]):
    """(padded row count, rows a rank, this rank's first row) for `n`
    rows split over the mesh in blocks of a multiple of 8."""
    d = 1 if mesh is None else mesh.size
    n_pad = -(-n // (8 * d)) * (8 * d)
    n_local = n_pad // d
    return n_pad, n_local, (0 if mesh is None else mesh.rank) * n_local
