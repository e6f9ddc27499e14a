"""Smoke run of the PyTorch/CUDA port (cupoch_tpu_torch) on one GPU.

Run from the root of the repository, on a machine with an NVIDIA
Hopper card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card's name and power limit, as nvidia-smi prints them;
  2. build: compiles every kernel under cupoch_tpu_torch/csrc with nvcc;
  3. kernel: at the headline grid and pool (1M points in [0,2]^3,
     radius 0.05), the slot kernel against its plain PyTorch version in
     the Gauss-Newton configuration (identity pose) and in the exact
     configuration (the true pose), with times and the roofline bound;
  4. main path: the port's public `registration_icp` (point-to-plane,
     20 iterations, relative tolerance 1e-6) on that cloud and a
     rotated copy, held to the true pose; the launch count must equal
     iterations + 1; then the grid build and the ICP loop on a prebuilt
     grid are timed and profiled (device time by kernel and the
     device's busy share), and small registrations on the card (a volume
     cloud on a dense grid, a surface cloud on a compact grid) are held
     against the same calls on the CPU (the plain path);
  5. one JSON line of per-kernel numbers, then the result line.

Any failure raises and exits non-zero. Without a card it exits
non-zero before printing a result; it never falls back to the CPU.
"""
import json
import statistics
import subprocess
import time

# the H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_POINTS = 1_000_000
RADIUS = 0.05
ITERS = 20
REL_TOL = 1e-6
POSE_TOL = 1e-3
AGREE_MIN = 0.999
TIMED_LAUNCHES = 20


def _headline_clouds(np, n):
    """bench.py's headline cloud: n uniform points in [0,2]^3 with unit
    normals, and the source it rotates by 0.02 rad about z and shifts;
    returns (tgt, normals, src, true pose)."""
    rng = np.random.default_rng(0)
    tgt = rng.uniform(size=(n, 3)).astype(np.float32) * 2.0
    tn = rng.normal(size=(n, 3)).astype(np.float32)
    tn /= np.linalg.norm(tn, axis=1, keepdims=True)
    ang = 0.02
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.float32([0.01, -0.02, 0.005])
    src = (tgt - t) @ R
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return tgt, tn, src, T


def _surface_pair(np, n=40_000):
    """A wavy sheet (a sparse-occupancy surface scan, as in
    tests/test_poolgrid_compact.py) and a shifted copy: (src, tgt)."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 2.0, size=(n, 2)).astype(np.float32)
    z = 0.25 * np.sin(3.0 * xy[:, 0]) * np.cos(2.0 * xy[:, 1]) \
        + 0.02 * rng.normal(size=n).astype(np.float32)
    tgt = np.concatenate([xy, z[:, None].astype(np.float32)], -1)
    return tgt + np.float32([0.004, -0.003, 0.002]), tgt


def _time_ms(torch, fn, reps):
    """Median milliseconds of `fn` over `reps` runs, each between two
    CUDA events, after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _scores(torch, grid, qpool, params, slot):
    """f32 score of `slot` for every pooled query, in the kernel's order,
    and the key quantum at that score."""
    G, CH, QP = qpool.shape
    tag = qpool[:, 3].clamp(min=0).long()
    rows = torch.arange(G, device=qpool.device)[:, None] * grid.tile + tag
    c = grid.table[rows, slot.long()]                     # [G, QP, 4]
    R, t, off = params[:9], params[9:12], params[13]
    qx, qy, qz = qpool[:, 0], qpool[:, 1], qpool[:, 2]
    ex = (R[0] * qx + R[1] * qy + R[2] * qz + t[0]) - qpool[:, 4]
    ey = (R[3] * qx + R[4] * qy + R[5] * qz + t[1]) - qpool[:, 5]
    ez = (R[6] * qx + R[7] * qy + R[8] * qz + t[2]) - qpool[:, 6]
    s = ((c[..., 3] + c[..., 0] * ex) + c[..., 1] * ey) + c[..., 2] * ez
    base = (s + off).view(torch.int32) & ~0xFFF
    quantum = (base + 0x1000).view(torch.float32) - base.view(torch.float32)
    return s, quantum


def check_slot_kernel(torch, poolgrid, poolgrid_slot, grid, qpool, params,
                      mode):
    """Kernel against slot_plain on the same inputs; returns its record."""
    got = poolgrid_slot.slot_pass(grid, qpool, params)
    want = poolgrid_slot.slot_plain(grid, qpool, params)
    torch.cuda.synchronize()
    valid = qpool[:, 3] >= 0
    n_valid = int(valid.sum())
    same = float(((got == want) & valid).sum()) / max(n_valid, 1)
    sk, quantum = _scores(torch, grid, qpool, params, got)
    sp, _ = _scores(torch, grid, qpool, params, want)
    err = torch.where(valid, (sk - sp).abs(), 0.0)
    max_err = float(err.max())
    worst = float((err - torch.where(valid, quantum, 0.0)).max())
    if same < AGREE_MIN or worst > 0:
        raise AssertionError(
            f"slot kernel ({mode}) disagrees with slot_plain: {same:.6f} "
            f"equal, max score gap {max_err} vs the key quantum")
    kernel_ms = _time_ms(
        torch, lambda: poolgrid_slot.slot_pass(grid, qpool, params),
        TIMED_LAUNCHES)
    plain_ms = _time_ms(
        torch, lambda: poolgrid_slot.slot_plain(grid, qpool, params), 3)
    # least time for the same work: every table row this grid holds
    # (its actual rows, compact or dense), the seven query rows read,
    # the slots written; and 7 f32 operations per (valid query, real
    # candidate slot)
    G, CH, QP = qpool.shape
    n_bytes = grid.table.numel() * 4 + 7 * G * QP * 4 + G * QP * 4
    n_ops = n_valid * 27 * grid.cap * 7
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    rec = {"mode": mode, "equal": same, "max_abs_err": max_err,
           "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes, "ops": n_ops, "valid_queries": n_valid}
    print(f"kernel[{mode}]: slots equal on {same:.6f} of {n_valid} valid "
          f"queries, max score gap {max_err}; kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, bound {rec['bound_ms']:.4f} ms by "
          f"{rec['bound_by']} ({n_bytes / 1e9:.3f} GB, "
          f"{n_ops / 1e9:.2f} G ops); library_ms null: no single "
          f"PyTorch call computes a per-cell packed-key argmin over a "
          f"gathered candidate row")
    return rec


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs an NVIDIA GPU")
    import cupoch_tpu_torch as ctt
    from cupoch_tpu_torch.knn import poolgrid, poolgrid_slot
    from cupoch_tpu_torch.registration import fused_icp
    from cupoch_tpu_torch.registration.estimation import (
        TransformationEstimationType,
    )
    from cupoch_tpu_torch.utility import nvcc

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    libs = nvcc.build_all()
    build_s = time.perf_counter() - t0
    for name in libs:
        ptxas = [ln.strip() for ln in nvcc.build_logs.get(name, "")
                 .splitlines() if "Used" in ln or "spill" in ln]
        print(f"build: {name} in {build_s:.2f} s (all sources at once); "
              f"ptxas: {' | '.join(ptxas) or 'cached'}")

    # 3. kernel against its plain version at the headline shapes
    tgt, tn, src, T_true = _headline_clouds(np, N_POINTS)
    est = TransformationEstimationType.PointToPlane
    tgt_d = torch.as_tensor(tgt, device=dev)
    tn_d = torch.as_tensor(tn, device=dev)
    src_d = torch.as_tensor(src, device=dev)
    mask = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    attrs, est_code = fused_icp.make_target_attrs(est, tgt_d, tn_d)
    plan = poolgrid.plan_poolgrid(tgt, RADIUS, query_points=src,
                                  est=est_code)

    def build():
        return poolgrid.make_poolgrid(
            tgt_d, attrs, plan["origin"], plan["cell_size"], plan["dims"],
            plan["cap"], plan["kc"], est=est_code, tile=plan["tile"],
            mask=mask, active_cells=plan["active_cells"])

    grid = build()
    print(f"plan: dims {plan['dims']} cap {plan['cap']} kc {plan['kc']} "
          f"qp {plan['qp']} tile {plan['tile']} supertiles {grid.n_tiles} "
          f"compact {plan['active_cells'] is not None}; table "
          f"{tuple(grid.table.shape)}")
    r2 = torch.tensor(RADIUS, dtype=torch.float32) ** 2
    records = []
    for mode, T in (("gn", np.eye(4, dtype=np.float32)), ("exact", T_true)):
        T = torch.as_tensor(T)
        qpool, _, _ = poolgrid.bin_queries_pool(
            src_d, T, grid.origin, grid.cell_size, grid.dims, plan["qp"],
            grid.tile, mask=mask, cell_map=grid.cell_map,
            n_rank_pad=grid.n_tiles * grid.tile)
        params = poolgrid.make_params(T, r2, grid)
        records.append(check_slot_kernel(torch, poolgrid, poolgrid_slot,
                                         grid, qpool, params, mode))
    del qpool, params

    # 4. the main path, through the public entry
    source = ctt.geometry.PointCloud(src_d)
    target = ctt.geometry.PointCloud(tgt_d)
    target.normals = tn_d
    crit = ctt.registration.ICPConvergenceCriteria(REL_TOL, REL_TOL, ITERS)
    pt2pl = ctt.registration.TransformationEstimationPointToPlane()
    torch.cuda.synchronize()
    poolgrid_slot.launches = 0
    t0 = time.perf_counter()
    res = ctt.registration.registration_icp(source, target, RADIUS,
                                            estimation=pt2pl, criteria=crit)
    reg_s = time.perf_counter() - t0
    launches = poolgrid_slot.launches
    pose_err = float(np.abs(res.transformation - T_true).max())
    print(f"main path: registration_icp pt2pl {N_POINTS} points: fitness "
          f"{res.fitness:.6f} rmse {res.inlier_rmse:.6e} iterations "
          f"{res.iterations} pose error {pose_err:.3e} slot launches "
          f"{launches} dropped target {res.n_dropped_target} queries "
          f"{res.n_dropped_queries}; {reg_s:.3f} s with the host plan")
    if not np.isfinite(res.transformation).all() or pose_err > POSE_TOL:
        raise AssertionError(f"pose error {pose_err} > {POSE_TOL}")
    if res.fitness < 0.99:
        raise AssertionError(f"fitness {res.fitness} < 0.99")
    if launches != res.iterations + 1:
        raise AssertionError(f"{launches} slot launches for "
                             f"{res.iterations} iterations + 1")

    # tracking regime (one prebuilt grid, bench.py's frame = build +
    # loop with the plan made once)
    def loop(g):
        out = fused_icp.icp_core_pool(
            src_d, mask, torch.zeros((N_POINTS, 0), device=dev), g,
            torch.eye(4), RADIUS, plan["rebin_margin"], REL_TOL, REL_TOL,
            plan["qp"], est, ITERS)
        torch.cuda.synchronize()
        return out

    def timed(fn, reps=3):
        best, out = float("inf"), None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best, out

    del grid
    build_s, grid = timed(build)
    loop_s, out = timed(lambda: loop(grid))
    it = out[4]
    frame_s = build_s + loop_s
    print(f"timing: secs_per_frame {frame_s:.4f} grid_build_s "
          f"{build_s:.4f} icp_loop_s {loop_s:.4f} pass_ms "
          f"{loop_s / max(it, 1) * 1e3:.3f} iterations {it} on {card}")
    profile(torch, lambda: loop(grid), loop_s)

    # small inputs: the card's result against the port's CPU path (the
    # plain slot version), on a volume cloud (dense grid) and on a
    # surface cloud (compact grid)
    sheet_src, sheet = _surface_pair(np)
    if poolgrid.plan_poolgrid(sheet, RADIUS, query_points=sheet_src)[
            "active_cells"] is None:
        raise AssertionError("the surface cloud did not compact its grid")
    m = 24000
    pt2pt = ctt.registration.TransformationEstimationPointToPoint()
    for case, s_np, t_np, n_np, est_obj in (
            ("volume", src[:m], tgt[:m], tn[:m], pt2pl),
            ("surface", sheet_src, sheet, None, pt2pt)):
        out = {}
        for name in ("cuda", "cpu"):
            s_pc = ctt.geometry.PointCloud(s_np, device=name)
            t_pc = ctt.geometry.PointCloud(t_np, device=name)
            t_pc.normals = n_np
            out[name] = ctt.registration.registration_icp(
                s_pc, t_pc, RADIUS, estimation=est_obj, criteria=crit)
        a, b = out["cuda"], out["cpu"]
        d_pose = float(np.abs(a.transformation - b.transformation).max())
        same_corr = \
            a.correspondence_set.shape == b.correspondence_set.shape \
            and bool((a.correspondence_set == b.correspondence_set).mean()
                     >= 0.999)
        print(f"small input ({case}, {len(s_np)} points): cuda vs cpu "
              f"pose gap {d_pose:.3e}, fitness {a.fitness:.6f} vs "
              f"{b.fitness:.6f}, correspondences "
              f"{'agree' if same_corr else 'differ'}")
        if d_pose > 1e-4 or abs(a.fitness - b.fitness) > 1e-3 \
                or not same_corr or a.fitness < 0.98:
            raise AssertionError(f"card and CPU paths disagree on the "
                                 f"{case} input")

    # 5. per-kernel numbers, then the result
    gn, exact = records   # one f32 kernel: both modes time alike
    print(json.dumps({"kernels": [{
        "name": "poolgrid_slot",
        "route": "cuda",
        "source": "cupoch_tpu_torch/csrc/poolgrid_slot.cu",
        "replaces": "cupoch_tpu/knn/poolgrid.py:724",
        "launches": launches,
        "max_abs_err": max(gn["max_abs_err"], exact["max_abs_err"]),
        "ms": gn["ms"],
        "plain_ms": gn["plain_ms"],
        "bound_ms": gn["bound_ms"],
        "bound_by": gn["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def profile(torch, fn, loop_s):
    """Device time by kernel over one ICP loop (kernels only, not the
    operators that launch them), and the device's busy share of the
    unprofiled loop's wall time `loop_s`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts):
        fn()                                   # profiler warm-up
    with tprofile(activities=acts) as prof:
        fn()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=lambda e: -dev_us(e))
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    if not rows:
        print("profile: the profiler saw no device time: not measured")
        return
    top = "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in rows[:10])
    print(f"profile: kernels {busy_ms:.3f} ms over a {loop_s * 1e3:.3f} ms "
          f"loop, busy share {busy_ms / (loop_s * 1e3):.3f}; top: {top}")


if __name__ == "__main__":
    main()
