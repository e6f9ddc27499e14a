"""Multi-rank scaling benchmark (the JAX package's `bench/scaling.py`).

`run_scaling` measures the point-sharded run-grid ICP loop
(`parallel.sharded_registration_icp`: kernel 2 on each rank's shard,
one psum of 32 floats an iteration) on the first c ranks of a mesh for
c = 1, 2, 4, ..., weak-scaling: a constant number of source points a
rank against a fixed 262 144-point target. `collective_split` runs the
same per-shard loop with and without its collectives. Both are called
on every rank of the mesh (`parallel.launch` spawns the ranks) and
return rank 0's numbers on every rank.

Every row says how many of the mesh's ranks compute on rank 0's card
(`ranks_on_card`: gloo ranks on a machine with fewer cards than ranks
share one; 0 on the CPU). Where that is more than 1, the times measure
the ranks' contention for one card and the host-staged collectives,
not a multi-card machine. In `run_scaling` it counts every rank of the
mesh, also those that wait while a smaller count is timed. Processes
outside the mesh are not counted: a caller that runs other work on
the card at the same time says so.

Run: ``python -m cupoch_tpu_torch.bench.scaling [--ranks D]
[--backend nccl|gloo] [--points N] [--split]``.
"""
from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

TARGET_POINTS = 262144


def _ranks_on_card(mesh) -> int:
    """The mesh's ranks on rank 0's card (ranks take the cards in turn);
    0 on the CPU."""
    if mesh.device.type != "cuda":
        return 0
    return -(-mesh.size // torch.cuda.device_count())


def _slowest(mesh, seconds: float) -> float:
    """The largest of the ranks' `seconds`."""
    return float(mesh.pmax(torch.tensor(seconds, device=mesh.device)))


def _target(rng):
    tgt = rng.uniform(size=(TARGET_POINTS, 3)).astype(np.float32)
    tn = rng.normal(size=(TARGET_POINTS, 3)).astype(np.float32)
    tn /= np.linalg.norm(tn, axis=1, keepdims=True)
    return tgt, tn


def run_scaling(points_per_device: int = 131072, reps: int = 2,
                max_iteration: int = 8, mesh=None) -> List[dict]:
    """One row per rank count c (1, 2, 4, ... up to the mesh's size):
    the best of `reps` runs' seconds (grid build and loop, the slowest
    rank's), points a second and the efficiency against c = 1."""
    import torch.distributed as dist

    from ..parallel import make_point_mesh, sharded_registration_icp

    world = make_point_mesh() if mesh is None else mesh
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= world.size]
    rng = np.random.default_rng(0)
    tgt, tgt_normals = _target(rng)
    ang = 0.01
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    rows = []
    base_tput = None
    for c in counts:
        # weak scaling: constant work a rank; the source samples the
        # target with a rigid offset
        N = points_per_device * c
        sel = rng.integers(0, TARGET_POINTS, N)
        src = (tgt[sel] - np.float32([0.005, -0.004, 0.002])) @ R
        if world.size == 1:
            sub = world
        else:
            group = dist.new_group(list(range(c)))
            if world.rank >= c:
                continue
            sub = make_point_mesh(c, device=world.device, group=group)
        best = float("inf")
        for _ in range(reps):
            T, fit, rmse, it, dt = sharded_registration_icp(
                src, tgt, tgt_normals, 0.03, sub,
                max_iteration=max_iteration)
            best = min(best, _slowest(sub, dt))
        tput = N / best
        if base_tput is None:
            base_tput = tput
        rows.append({
            "devices": c, "points": N, "seconds": best,
            "points_per_s": tput, "efficiency": tput / (base_tput * c),
            "fitness": fit, "rmse": rmse, "iterations": it,
            "backend": sub.backend, "device": str(sub.device),
            "ranks_on_card": _ranks_on_card(world),
            "staged_collectives": sub.staged})
    return world.broadcast_object(rows if world.rank == 0 else None)


def collective_split(n_devices: Optional[int] = None,
                     points_per_device: int = 16384,
                     max_iteration: int = 6, reps: int = 3,
                     mesh=None) -> dict:
    """The same per-shard run-grid loop with its collectives (the
    production path) and without (each rank solves its shard alone), on
    the same grid; the best of `reps` of each, the slowest rank's. Their
    difference is what the collectives cost."""
    from ..knn import rungrid
    from ..parallel import make_point_mesh
    from ..parallel.collectives import shard_rows
    from ..registration import fused_icp
    from ..registration.estimation import TransformationEstimationType

    mesh = make_point_mesh(n_devices) if mesh is None else mesh
    D, dev = mesh.size, mesh.device
    rng = np.random.default_rng(0)
    M = 65536
    tgt = rng.uniform(size=(M, 3)).astype(np.float32)
    tn = rng.normal(size=(M, 3)).astype(np.float32)
    tn /= np.linalg.norm(tn, axis=1, keepdims=True)
    N = points_per_device * D
    sel = rng.integers(0, M, N)
    src = tgt[sel] - np.float32([0.004, -0.003, 0.002])

    est = TransformationEstimationType.PointToPlane
    tgt_d = torch.as_tensor(tgt, device=dev)
    attrs, est_code = fused_icp.make_target_attrs(
        est, tgt_d, torch.as_tensor(tn, device=dev))
    plan = rungrid.plan_rungrid(tgt_d, 0.03, margin=0.25, query_points=src,
                                nch=int(attrs.shape[1]))
    grid = rungrid.make_rungrid(
        tgt_d, attrs, plan["origin"], plan["cell_size"], plan["dims"],
        plan["cap"], est=est_code, kc=plan["kc"])
    _, n_local, lo = shard_rows(N, mesh)
    src_d = torch.as_tensor(src[lo:lo + n_local], device=dev)
    mask = torch.ones(n_local, dtype=torch.bool, device=dev)

    def run(m):
        out = fused_icp.icp_core_rungrid(
            src_d, mask, torch.zeros_like(src_d), grid, torch.eye(4), 0.03,
            plan["rebin_margin"], 1e-6, 1e-6, plan["qcap"], est,
            max_iteration, mesh=m)
        float(out[2])

    res = {}
    for name, m in (("with_collectives", mesh),
                    ("without_collectives", None)):
        run(m)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run(m)
            best = min(best, time.perf_counter() - t0)
        res[name + "_s"] = _slowest(mesh, best)
    tw = res["with_collectives_s"]
    to = res["without_collectives_s"]
    res.update(
        devices=D, points_per_device=points_per_device,
        collective_frac=max(0.0, tw - to) / tw,
        host_cores=os.cpu_count(),
        contention_bound=min(1.0, (os.cpu_count() or 1) / D),
        backend=mesh.backend, device=str(dev),
        ranks_on_card=_ranks_on_card(mesh))
    return mesh.broadcast_object(res if mesh.rank == 0 else None)


def main(argv=None):
    import argparse

    from ..parallel import launch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: the cards on this machine)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl: one card a rank; gloo: ranks may share "
                         "a card")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--points", type=int, default=131072,
                    help="points a rank (weak scaling)")
    ap.add_argument("--iters", type=int, default=8,
                    help="ICP iterations a measurement")
    ap.add_argument("--split", action="store_true",
                    help="also report the collective / compute split")
    args = ap.parse_args(argv)
    ranks = args.ranks or max(1, torch.cuda.device_count())
    jobs = [launch.Job(run_scaling, (args.points,),
                       {"max_iteration": args.iters})]
    if args.split:
        jobs.append(launch.Job(collective_split))
    out = launch.run_ranks(jobs, ranks, backend=args.backend,
                           device=args.device)
    for row in out[0][0]["result"]:
        print(json.dumps(row))
    if args.split:
        print(json.dumps(out[0][1]["result"]))


if __name__ == "__main__":
    main()
