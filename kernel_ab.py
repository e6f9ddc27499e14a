"""A/B timing of kernels 3 and 4 on one GPU: the sources under
cupoch_tpu_torch/csrc against an earlier design's, on the inputs
chip_smoke.py checks them on.

Run from the root of the repository, on a machine with an NVIDIA Hopper
card and the CUDA toolkit, with the earlier sources in a directory that
.gitignore lists (`ab_old/`):

    mkdir -p ab_old
    for f in rungrid_gmm.cu rollgrid_nn.cu rungrid_common.cuh; do
        git show <commit>:cupoch_tpu_torch/csrc/$f > ab_old/$f
    done
    python3 kernel_ab.py --old ab_old

It builds the earlier sources beside the current ones (one nvcc a
source, all at once) and, at kernel 3's FilterReg plan and kernel 4's
roll (identity, true pose) and cell plans, as chip_smoke.py makes them:
holds both designs against the plain PyTorch versions with
chip_smoke.py's limits (kernel 3 within rtol 2e-5, atol 1e-5, also on
chip_smoke.py's near-equal |e| case; kernel 4 bit for bit), then times
them in turns old, new, new, old (each the median of 20 launches between
CUDA events). The current design must hold every limit; the earlier
one's results are reported. It prints a line a shape and one JSON line
with every time and the card's name and power limit, and writes that
line to chiprun_out/kernel_ab.json. An earlier kernel 4 whose launch
takes no lane rank is called without one.
"""
import argparse
import ctypes
import json
import os
import subprocess

import chip_smoke as cs

NAMES = ("rungrid_gmm", "rollgrid_nn")


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


def _within(torch, got, want):
    """(within the limits, largest gap) of moments against gmm_plain."""
    try:
        return True, cs.gmm_gap(torch, got, want)
    except AssertionError:
        return False, max(float((a - b).abs().max())
                          for a, b in zip(got, want))


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
                    help="directory with the earlier rungrid_gmm.cu, "
                         "rollgrid_nn.cu and rungrid_common.cuh")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is False; "
                         "this run needs an NVIDIA GPU")
    from cupoch_tpu_torch.knn import rollgrid_nn, rungrid, rungrid_gmm
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

    # kernel 3 at the FilterReg plan, and the near-equal |e| case
    rsrc, rtgt, sigma0, _ = cs._filterreg_pair(np, cs.N_POINTS)
    case = cs.gmm_case(np, torch, rungrid, rsrc, rtgt, sigma0, dev)
    want = rungrid_gmm.gmm_plain(*case)
    gap_new = cs.gmm_gap(torch, rungrid_gmm.gmm_pass(*case), want)
    ok_old, gap_old = _within(torch, _old_gmm(torch, old["rungrid_gmm"],
                                              *case), want)
    del want
    tie = cs.gmm_tie_case(np, torch, rungrid, dev)
    tie_want = rungrid_gmm.gmm_plain(*tie)
    tie_new = cs.gmm_gap(torch, rungrid_gmm.gmm_pass(*tie), tie_want,
                         "gmm kernel, near-equal |e|")
    tie_ok_old, tie_old = _within(
        torch, _old_gmm(torch, old["rungrid_gmm"], *tie), tie_want)
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
