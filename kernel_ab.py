"""A/B timing of the four kernels on one GPU: the sources under
cupoch_tpu_torch/csrc against an earlier design's, on the inputs
chip_smoke.py checks them on.

Run from the root of the repository, on a machine with an NVIDIA Hopper
card and the CUDA toolkit, with the earlier sources in a directory that
.gitignore lists (`ab_old/`):

    mkdir -p ab_old
    for f in poolgrid_slot.cu rungrid_fused.cu rungrid_gmm.cu \
            rollgrid_nn.cu rungrid_common.cuh; do
        git show <commit>:cupoch_tpu_torch/csrc/$f > ab_old/$f
    done
    python3 kernel_ab.py --old ab_old

It builds the earlier sources beside the current ones (one nvcc a
source, all at once) and, as chip_smoke.py makes the inputs: kernel 1 at
the headline in Gauss-Newton and exact mode, kernel 2 in correspondence
mode at the evaluate plan and in Gauss-Newton mode (point-to-point,
point-to-plane, symmetric) at the fallback plan, kernel 3 at the
FilterReg plan and kernel 4 at the roll (identity, true pose) and cell
plans. At each it holds both designs against the plain PyTorch versions
with chip_smoke.py's limits (kernel 1: slots >= 99.9% equal, every score
gap within a key quantum; kernel 2: winners >= 99.9% equal with d2
within 1 ulp, GN counts equal, sums within 1e-4 of their group, pose
updates within 1e-5; kernel 3 within rtol 2e-5, atol 1e-5; kernel 4 bit
for bit), runs chip_smoke.py's built edge cases on the current kernels,
then times both designs in turns old, new, new, old (each the median of
20 launches between CUDA events). The current design must hold every
limit; the earlier one's results are reported. It prints a line a shape
and one JSON line with every time and the card's name and power limit,
and writes that line to chiprun_out/kernel_ab.json. An earlier kernel 4
whose launch takes no lane rank is called without one.
"""
import argparse
import ctypes
import json
import os
import subprocess

import chip_smoke as cs

NAMES = ("poolgrid_slot", "rungrid_fused", "rungrid_gmm", "rollgrid_nn")


def _build_old(nvcc, src_dir):
    """The earlier sources' libraries, one nvcc each, started together."""
    out = os.path.join(src_dir, "_build")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in NAMES:
        lib = os.path.join(out, f"lib{name}.so")
        cmd = [nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", lib,
               os.path.join(src_dir, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    return procs


def _loaded(procs):
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def _old_slot(torch, lib, grid, qpool, params):
    """Kernel 1 from the earlier library (the same launch signature)."""
    fn = lib.poolgrid_slot_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    G, CH, QP = qpool.shape
    out = torch.empty((G, QP), dtype=torch.int32, device=qpool.device)
    err = fn(params.data_ptr(), qpool.data_ptr(), grid.table.data_ptr(),
             out.data_ptr(), G, CH, QP, grid.tile, grid.kc,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier poolgrid_slot launch: CUDA error {err}")
    return out


def _old_fused(torch, lib, grid, qsoa, qidx, params, est, corres):
    """Kernel 2 from the earlier library (the same launch signature): the
    correspondences, or the GN sums on the CPU."""
    fn = lib.rungrid_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cp, nq, qcap = qsoa.shape
    dev = qsoa.device
    if corres:
        out0 = torch.empty((cp, qcap), dtype=torch.float32, device=dev)
        out1 = torch.empty((cp, qcap), dtype=torch.float32, device=dev)
    else:
        out0 = out1 = torch.empty((cp, 32), dtype=torch.float32, device=dev)
    Gx, Gy, Gz = grid.dims
    err = fn(params.data_ptr(), qsoa.data_ptr(), qidx.data_ptr(),
             grid.cand.data_ptr(), (grid.negidx if corres
                                    else grid.attrp).data_ptr(),
             grid.bounds.data_ptr(), out0.data_ptr(), out1.data_ptr(), cp,
             nq, qcap, grid.kc, grid.attrp.shape[1], est, int(corres), Gx,
             Gy, Gz, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier rungrid_fused launch: CUDA error {err}")
    return (out0, out1) if corres else out0.sum(0)


def _holds(check):
    """(True, check()) when the limits hold, else (False, the message)."""
    try:
        return True, check()
    except AssertionError as exc:
        return False, str(exc)


def _old_gmm(torch, lib, grid, qsoa, qidx, params):
    """Kernel 3 from the earlier library (the same launch signature)."""
    fn = lib.rungrid_gmm_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cp, nq, qcap = qsoa.shape
    out = torch.empty((5, cp, qcap), dtype=torch.float32, device=qsoa.device)
    Gx, Gy, Gz = grid.dims
    err = fn(params.data_ptr(), qsoa.data_ptr(), qidx.data_ptr(),
             grid.cand.data_ptr(), grid.bounds.data_ptr(), out.data_ptr(),
             cp, nq, qcap, grid.kc, Gx, Gy, Gz,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier rungrid_gmm launch: CUDA error {err}")
    return tuple(out.unbind(0))


def _old_nn(torch, lib, takes_rank, q_soa, grid, r2):
    """Kernel 4 from the earlier library, with the lane rank if its
    launch takes one."""
    fn = lib.rollgrid_nn_launch
    ins = [grid.cand_rank] if takes_rank else []
    fn.argtypes = [ctypes.c_void_p] * (5 + len(ins)) + [ctypes.c_float] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    C, _, qcap = q_soa.shape
    idx = torch.empty((C, qcap), dtype=torch.int32, device=q_soa.device)
    d2 = torch.empty((C, qcap), dtype=torch.float32, device=q_soa.device)
    err = fn(q_soa.data_ptr(), grid.cand.data_ptr(),
             grid.cand_idx.data_ptr(), *(t.data_ptr() for t in ins),
             idx.data_ptr(), d2.data_ptr(), float(r2), C, qcap,
             grid.cand.shape[2], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier rollgrid_nn launch: CUDA error {err}")
    return idx, d2


def _record(torch, shape, fns, reps, extra):
    """Times fns {"old", "new"} in turns old, new, new, old."""
    times = {"old": [], "new": []}
    for k in ("old", "new", "new", "old"):
        times[k].append(cs._time_ms(torch, fns[k], reps))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    rec = {"shape": shape, "old_ms": times["old"], "new_ms": times["new"],
           "ratio": mean["new"] / mean["old"], **extra}
    print(f"ab[{shape}]: old {times['old'][0]:.4f} / {times['old'][1]:.4f} "
          f"ms, new {times['new'][0]:.4f} / {times['new'][1]:.4f} ms, "
          f"new/old {rec['ratio']:.3f}; {extra}")
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier poolgrid_slot.cu, "
                         "rungrid_fused.cu, rungrid_gmm.cu, rollgrid_nn.cu "
                         "and rungrid_common.cuh")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is False; "
                         "this run needs an NVIDIA GPU")
    from cupoch_tpu_torch.knn import (poolgrid, poolgrid_slot, rollgrid_nn,
                                      rungrid, rungrid_fused, rungrid_gmm)
    from cupoch_tpu_torch.registration import fused_icp
    from cupoch_tpu_torch.registration.estimation import (
        TransformationEstimationType as ET,
    )
    from cupoch_tpu_torch.utility import nvcc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    procs = _build_old(nvcc, args.old)
    nvcc.build_all(list(NAMES))
    old = _loaded(procs)
    with open(os.path.join(args.old, "rollgrid_nn.cu")) as fh:
        src = fh.read()
    old_takes_rank = "rank" in src[src.index("rollgrid_nn_launch("):
                                   src.index("{", src.index(
                                       "rollgrid_nn_launch("))]
    dev = torch.device("cuda")
    reps = cs.TIMED_LAUNCHES
    recs = []

    # kernel 1 at the headline, in GN and exact mode; its built cases
    hp = cs.headline_pool(np, torch, poolgrid, fused_icp, ET.PointToPlane,
                          dev)
    grid = hp["build"]()
    for mode, qpool, params in cs.slot_inputs(np, torch, poolgrid, hp, grid):
        want = poolgrid_slot.slot_plain(grid, qpool, params)
        same, gap = cs.slot_gap(torch, grid, qpool, params,
                                poolgrid_slot.slot_pass(grid, qpool, params),
                                want, mode)
        ok_old, old_gap = _holds(lambda: cs.slot_gap(
            torch, grid, qpool, params, _old_slot(
                torch, old["poolgrid_slot"], grid, qpool, params), want,
            mode))
        del want
        recs.append(_record(torch, f"slot {mode}", {
            "old": lambda: _old_slot(torch, old["poolgrid_slot"], grid,
                                     qpool, params),
            "new": lambda: poolgrid_slot.slot_pass(grid, qpool, params)},
            reps, {"equal_new": same, "max_gap_new": gap,
                   "old_within_limits": ok_old, "old": old_gap}))
        del qpool, params
    del grid
    cs.check_slot_edges(torch, poolgrid, poolgrid_slot, np, dev)

    # kernel 2 at the evaluate plan (corres) and the fallback plan (GN);
    # its built cases
    _, egrid, qsoa, qidx, params = cs.evaluate_input(np, torch, rungrid, hp)
    d2p, nip = rungrid_fused.fused_plain(egrid, qsoa, qidx, params, 0, True)
    same, gap = cs.fused_corres_gap(torch, *rungrid_fused.fused_query(
        egrid, qsoa, qidx, params, 0, True), d2p, nip, qidx)
    ok_old, old_gap = _holds(lambda: cs.fused_corres_gap(
        torch, *_old_fused(torch, old["rungrid_fused"], egrid, qsoa, qidx,
                           params, 0, True), d2p, nip, qidx))
    recs.append(_record(torch, "fused corres evaluate", {
        "old": lambda: _old_fused(torch, old["rungrid_fused"], egrid, qsoa,
                                  qidx, params, 0, True),
        "new": lambda: rungrid_fused.fused_query(egrid, qsoa, qidx, params,
                                                 0, True)},
        reps, {"equal_new": same, "max_gap_new": gap,
               "old_within_limits": ok_old, "old": old_gap}))
    del egrid, qsoa, qidx, params, d2p, nip
    fb = cs.fallback_cloud(np, torch, poolgrid, rungrid, hp["est_code"], dev)
    del hp
    mask = torch.ones(cs.N_POINTS, dtype=torch.bool, device=dev)
    for est_type, fgrid, qsoa, qidx, params in cs.fallback_inputs(
            torch, rungrid, fused_icp, ET, fb, mask):
        est = fgrid.est
        sp = rungrid_fused.fused_plain(fgrid, qsoa, qidx, params, est,
                                       False).cpu()
        rel, d_pose = cs.fused_gn_gap(fused_icp, est_type, rungrid_fused
                                      .fused_query(fgrid, qsoa, qidx, params,
                                                   est, False).cpu(), sp)
        ok_old, old_gap = _holds(lambda: cs.fused_gn_gap(
            fused_icp, est_type, _old_fused(
                torch, old["rungrid_fused"], fgrid, qsoa, qidx, params, est,
                False).cpu(), sp))
        recs.append(_record(torch, f"fused gn {est_type.name}", {
            "old": lambda: _old_fused(torch, old["rungrid_fused"], fgrid,
                                      qsoa, qidx, params, est, False),
            "new": lambda: rungrid_fused.fused_query(fgrid, qsoa, qidx,
                                                     params, est, False)},
            reps, {"rel_new": rel, "pose_new": d_pose,
                   "old_within_limits": ok_old, "old": old_gap}))
        del fgrid, qsoa, qidx, params
    del fb
    cs.check_fused_edges(np, torch, rungrid, rungrid_fused, dev)

    # kernel 3 at the FilterReg plan, and the near-equal |e| case
    rsrc, rtgt, sigma0, _ = cs._filterreg_pair(np, cs.N_POINTS)
    case = cs.gmm_case(np, torch, rungrid, rsrc, rtgt, sigma0, dev)
    want = rungrid_gmm.gmm_plain(*case)
    gap_new = cs.gmm_gap(torch, rungrid_gmm.gmm_pass(*case), want)
    ok_old, gap_old = _holds(lambda: cs.gmm_gap(
        torch, _old_gmm(torch, old["rungrid_gmm"], *case), want))
    del want
    tie = cs.gmm_tie_case(np, torch, rungrid, dev)
    tie_want = rungrid_gmm.gmm_plain(*tie)
    tie_new = cs.gmm_gap(torch, rungrid_gmm.gmm_pass(*tie), tie_want,
                         "gmm kernel, near-equal |e|")
    tie_ok_old, tie_old = _holds(lambda: cs.gmm_gap(
        torch, _old_gmm(torch, old["rungrid_gmm"], *tie), tie_want))
    recs.append(_record(torch, "gmm filterreg", {
        "old": lambda: _old_gmm(torch, old["rungrid_gmm"], *case),
        "new": lambda: rungrid_gmm.gmm_pass(*case)}, reps, {
        "max_gap_new": gap_new, "old_within_limits": ok_old,
        "max_gap_old": gap_old, "near_equal_gap_new": tie_new,
        "near_equal_old_within_limits": tie_ok_old,
        "near_equal_gap_old": tie_old}))
    del case

    # kernel 4 at the roll plan (identity, true pose) and the cell plan
    ftgt, _, fsrc, fT = cs._headline_clouds(np, cs.N_POINTS,
                                            side=cs.FALLBACK_SIDE)
    for mode, q_soa, grid, radius in cs.nn_cases(np, torch, ftgt, fsrc, fT,
                                                 dev):
        r2 = torch.tensor(radius, dtype=torch.float32) ** 2
        ip, dp = rollgrid_nn.nn_reduce_plain(q_soa, grid.cand, grid.cand_idx,
                                             r2)
        ik, dk = rollgrid_nn.nn_reduce(q_soa, grid.cand, grid.cand_idx, r2,
                                       grid.cand_rank)
        io, do = _old_nn(torch, old["rollgrid_nn"], old_takes_rank, q_soa,
                         grid, r2)
        if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
            raise AssertionError(f"{mode}: the kernel differs from "
                                 f"nn_reduce_plain")
        recs.append(_record(torch, f"nn {mode}", {
            "old": lambda: _old_nn(torch, old["rollgrid_nn"], old_takes_rank,
                                   q_soa, grid, r2),
            "new": lambda: rollgrid_nn.nn_reduce(
                q_soa, grid.cand, grid.cand_idx, r2, grid.cand_rank)},
            reps, {"bit_exact_new": True, "bit_exact_old":
                   torch.equal(io, ip) and torch.equal(do, dp)}))
        del q_soa, grid
    line = json.dumps({"card": card, "ab": recs})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as fh:
        fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
