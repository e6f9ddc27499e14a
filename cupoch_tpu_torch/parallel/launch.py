"""Start D ranks on this machine and collect what each returns.

`start_ranks(jobs, n_ranks, backend=...)` spawns `n_ranks` processes
(`torch.multiprocessing`, start method "spawn"), which meet through a
`file://` rendezvous in a temporary directory (a fixed TCP port would
clash between concurrent callers) and join one process group of the
backend the caller names. Each rank then runs every job in order as
`job.fn(*job.args, mesh=mesh, **job.kwargs)`, with `mesh` a `Mesh` over
the world, at RANK_THREADS intra-op threads, and keeps per job
its result converted to numpy, its wall seconds, the kernel launches
it made (the wrappers' counters live per process) and the payloads its
mesh staged through the host. `handle.join()` returns them, one list per rank.

A rank computes on `device`: "cuda" is card `rank % device_count`, so
NCCL ranks take one card each (NCCL cannot put two ranks on one card)
and gloo ranks on a one-card machine share it; "cpu" runs the plain
versions. Nothing here swaps one backend for another.

Job functions must be importable by the children: functions of this
package or of `chip_smoke.py`. An exception in any rank ends every rank
and raises from `join`.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

# the port's counters live in one place; the ranks read them here
from ..utility.trace import launch_counts, reset_launch_counts

#: a collective that waits longer than this fails the rank (a rank that
#: took another branch would otherwise hang its peers)
COLLECTIVE_TIMEOUT_S = 600
#: intra-op threads a rank: D ranks share the host's cores, and the
#: ranks' many small ops spend their time in a larger thread pool
RANK_THREADS = 1


class Job(NamedTuple):
    fn: Callable
    args: tuple = ()
    kwargs: Optional[dict] = None


def loaded_packages(mesh=None) -> List[str]:
    """The top-level packages imported in this process (a job: `mesh`
    is not used)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)})


def to_numpy(x: Any) -> Any:
    """Tensors in a nest of tuples, lists, dicts and NamedTuples as
    numpy arrays; everything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


def rank_device(rank: int, device: str) -> torch.device:
    if device == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def _rank_main(rank, n_ranks, backend, device, init_file, out_dir, jobs):
    torch.set_num_threads(RANK_THREADS)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="file://" + init_file, rank=rank,
        world_size=n_ranks,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        # every rank has joined before any job can fail: a rank that
        # raised and exited while a peer was still connecting would turn
        # the peer's error into the one reported
        dist.barrier()
        from .sharded import make_point_mesh
        out = []
        for job in jobs:
            mesh = make_point_mesh(n_ranks, device=dev)
            reset_launch_counts()
            t0 = time.perf_counter()
            res = job.fn(*job.args, mesh=mesh, **(job.kwargs or {}))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out.append({"result": to_numpy(res),
                        "seconds": time.perf_counter() - t0,
                        "launches": launch_counts(),
                        "staged": mesh.staged,
                        "staged_bytes": mesh.staged_bytes})
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks started by `start_ranks`; `join` waits for them."""

    def __init__(self, ctx, tmpdir: str, n_ranks: int):
        self._ctx = ctx
        self._tmpdir = tmpdir
        self.n_ranks = n_ranks

    def join(self) -> List[List[dict]]:
        """Per rank, per job: {"result", "seconds", "launches", "staged",
        "staged_bytes"}. Raises if any rank raised or died."""
        try:
            while not self._ctx.join():
                pass
            out = []
            for r in range(self.n_ranks):
                with open(os.path.join(self._tmpdir, f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            shutil.rmtree(self._tmpdir, ignore_errors=True)


def start_ranks(jobs, n_ranks: int, *, backend: str,
                device: str = "cuda") -> Ranks:
    """Spawn `n_ranks` ranks of `backend` ("nccl" or "gloo") that run
    `jobs` (a list of `Job`) on `device` ("cuda" or "cpu"). Returns at
    once; `.join()` the result."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the ranks on the CPU")
        if backend == "nccl" and torch.cuda.device_count() < n_ranks:
            raise ValueError(
                f"NCCL takes one card a rank: {n_ranks} ranks, "
                f"{torch.cuda.device_count()} cards")
    elif backend == "nccl":
        raise ValueError("NCCL ranks run on cards; device must be 'cuda'")
    jobs = [j if isinstance(j, Job) else Job(*j) for j in jobs]
    tmpdir = tempfile.mkdtemp(prefix="cupoch_ranks_")
    try:
        ctx = tmp.start_processes(
            _rank_main,
            args=(n_ranks, backend, device,
                  os.path.join(tmpdir, "rendezvous"), tmpdir, jobs),
            nprocs=n_ranks, join=False, start_method="spawn")
    except BaseException:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    return Ranks(ctx, tmpdir, n_ranks)


def run_ranks(jobs, n_ranks: int, *, backend: str,
              device: str = "cuda") -> List[List[dict]]:
    """`start_ranks(...).join()`."""
    return start_ranks(jobs, n_ranks, backend=backend, device=device).join()
