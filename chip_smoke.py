"""Smoke run of the PyTorch/CUDA port (cupoch_tpu_torch) on one GPU.

Run from the root of the repository, on a machine with an NVIDIA
Hopper card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card's name and power limit, as nvidia-smi prints them;
  2. build: compiles every kernel under cupoch_tpu_torch/csrc with nvcc,
     one process per source, all at once;
  3. kernels, each against its plain PyTorch version on the same inputs,
     with times, the roofline bound, the occupancy, the ptxas registers
     and a computed issue ceiling:
     - the pooled-grid slot kernel at the headline grid (1M points in
       [0,2]^3, radius 0.05), in the Gauss-Newton configuration
       (identity pose) and in the exact one (the true pose), and on
       built edge cases (`slot_edge_case`: a cell of 100 queries, cells
       of 1-33, equal keys, a row without a real slot, tag -1 lanes);
     - the run-grid fused kernel in correspondence mode at the plan
       `evaluate_registration` makes for the headline pair, and in
       Gauss-Newton mode for point-to-point, point-to-plane and
       symmetric at the plan of the run-grid ICP fallback (1M points in
       [0,1.4]^3, whose pool plan is rejected), with the lanes it scans
       beside those its queries need; both modes on built edge cases
       (`fused_edge_case`: exact ties across windows, threads and within
       a thread, near-equal |e| at a gate, a cell larger than a pass,
       rows without a lane or a query);
     - the run-grid Gaussian-moment kernel at the FilterReg plan (the
       geometry of tests/test_filterreg.py scaled to 1M points), and on
       two queries of one cell whose |e| differ in their last bits, with
       a lane that only the farther one reaches;
     - the roll/cell-grid reduce (kernel 4) at the roll plan of the
       [0,1.4]^3 cloud (identity and true pose) and at the cell plan of
       a 500k-point wavy sheet, with the time of the nearest library
       composite (`torch.cdist` + min), and each grid's build time and
       memory with its lane rank's share;
  4. paths, each through the public entry with every launch count set
     to 0 just before it and read just after:
     - `registration_icp` (point-to-plane, 20 iterations, relative
       tolerance 1e-6) on the headline pair, held to the true pose
       (slot launches = iterations + 1); then the grid build and the
       loop on a prebuilt grid are timed and profiled (device time by
       kernel, the device's busy share);
     - `evaluate_registration` on the headline pair at the true pose
       (one correspondence launch), and at the ICP result's pose against
       that result's correspondences;
     - `registration_icp` on the [0,1.4]^3 cloud: the run-grid fallback
       (Gauss-Newton launches = iterations, one correspondence launch),
       then its loop on a prebuilt grid timed and profiled;
     - `registration_filterreg` on the scaled FilterReg pair (moment
       launches = its E-steps), then the call timed and profiled;
     - Colored ICP and GICP: `registration_colored_icp` (roll grid) and
       `registration_generalized_icp` from points alone (normals
       estimated at 1M points; roll grid) on the [0,1.4]^3 cloud, both
       on the headline pair (pooled grid), and Colored ICP on the sheet
       (cell grid); kernel-4 launches = iterations + 1 on the roll and
       cell paths; the roll-grid loop timed and profiled on a prebuilt
       grid;
     - small inputs, the card against the port's CPU path (the plain
       versions): pooled ICP on a volume and a surface cloud, brute-force
       ICP, `evaluate_registration` on both branches, the run-grid
       fallback, grid FilterReg, Colored ICP and GICP on the brute-force,
       roll and cell branches, the brute-force fallback of a target every
       grid plan rejects, and the hash-grid branch;
     - 4g. global registration (`global_registration`): a built room
       scene of 1M points a cloud (`scene_pair`: floor, wavy wall, six
       floating objects, 2 mm noise, 0.5% outliers; the source sampled
       apart and moved 0.6 rad and 0.54 m), through voxel
       down-sampling, normals, statistical outlier removal, RANSAC
       plane, DBSCAN, FPFH, Fast Global Registration and point-to-plane
       ICP on the full clouds, one cold and three warm runs with each
       step's ms, held to the plane, the clusters, FGR's and the refined
       pose, and the launches of the branches taken; then the same
       pipeline up to FGR on 10k points on the card against the CPU
       path;
     - 4k. RGB-D odometry and KinectFusion (`rgbd_phase`): a rendered
       room (`render_room`: a floor, three walls and three boxes with a
       smooth colour texture) seen at 640x480 with PrimeSense
       intrinsics from a camera 0.4 m up looking down 15 deg, along 20
       frames of a known trajectory, 1 cm and 0.3 deg a frame, as a
       sensor gives it (uint8 colour, uint16 depth in mm): hybrid,
       colour and weighted odometry on every consecutive pair, held to
       the true motion; `KinfuPipeline` at
       KinfuOption's defaults (4 levels, a 512^3 volume over 8 m with
       RGB8 colour, sdf_trunc 0.05, 20 ICP iterations a level) but an
       ICP threshold of 0.1, held to the trajectory, its last raycast
       to the true depth and its marching-cubes mesh to the scene's
       surfaces; each warm frame's stage split, the ICP branch of each
       level, peak memory and one profiled frame; one more frame at the
       default threshold 0.5; KinFu over 5 frames from a level camera,
       its raycast's share within 1 cm printed with no limit; then two
       frames through KinFu at 64x48 and odometry at 640x480 on the
       card against the CPU path;
     - 4r. robotics (`robotics_phase`): the same room mapped into an
       OccupancyGrid at cupoch's defaults (0.05 m, 512^3) from phase
       4k's 20 depth frames and from 50 scans of a simulated Hokuyo
       UTM-30LX (1081 steps over 270 deg, exact ray hits) through the
       scan-shadow filter, each insert timed with its DDA steps; the
       distance field at 512^3 held to a host float64 brute force on 10k
       voxels; Pos3DPlanner at its defaults on a 0.05 m lattice of the
       room's free box, 10k seeded edges' cut state held to a float64
       segment-box test, its path held to scipy's Dijkstra, to the
       inflated occupied boxes and to the distance field; a 6-joint arm
       (UR5's link offsets) in 512 seeded configurations held to a
       float64 containment oracle, one link swept at 0.02 m against the
       occupied voxels on the bucket route, held to a host dense oracle;
       no kernel launches; then every module at 64^3 on the card against
       the CPU, identical;
     - 4s. reconstruct and save (`reconstruct_phase`): phase 4k's 20
       frames fused into a ScalableTSDFVolume at Open3D's RGB-D
       integration settings (voxel 4/512 m, sdf_trunc 0.04, RGB8), its
       cloud and mesh held to the room; the mesh's cleanups, Taubin
       smoothing, normals, 1M uniform samples (held to the room) and the
       self-intersection test on the bucket route (held to a host dense
       oracle on 2000 seeded triangles); SGM at libSGM's
       defaults on a rendered rectified pair at a 0.05 m baseline, held
       to the true disparity and its cloud to the room; the mesh, the
       cloud and the samples written and read back as PLY, OBJ with a
       PNG texture, STL, PCD (binary and LZF-compressed, the C decoder
       held to the plain one) and a VoxelGrid PLY, binary files bit for
       bit; the ATE benchmark on the 20 frames written as PNG in the
       RGB-D test data's layout, its poses held to odometry on the same
       frames in memory; no kernel launches; then the card against the
       CPU on small inputs, and files written from card tensors
       byte-equal to those from CPU tensors;
     - 4v. visualization and the harness (`vis_phase`): the five
       colour maps on 1M seeded values on the card, held to the CPU's;
       a ViewControl fitted on the card to phase 4s's mesh and the 1M
       headline cloud (held to the host min / max), its pinhole round
       trip, a 4-key-view trajectory interpolated into its frames, the
       trajectory and a RenderOption through JSON files; the HTML export
       of the mesh and the cloud coloured by height from card tensors,
       its decoded arrays held to the CPU copies bit for bit and the
       export from CPU copies byte-equal; a PNG render refused without
       matplotlib; `bench.harness` on its synthetic 120k cloud (the
       reference's eleven ops; kernel-1 launches from its pooled
       `registration_icp`), then its CLI on a 50k-point binary PCD with
       a `torch.profiler` trace that lists kernel 1;
     - 4m. several ranks (`multi_phase`), each sub-step at D = 1 (this
       process), 2 and 4 (`parallel.launch` ranks: NCCL, one a card,
       where the machine has D cards, else gloo ranks sharing the card,
       their collectives staged through the host; each printed with its
       backend and staged payloads): the collectives against their
       definitions; `ring_sharded_registration_icp` on the headline
       pair (held to the true pose and to `registration_icp`, kernel-1
       launches a rank = D x (iterations + 1), the bytes the ring moves
       a pass; kernel 1 on rank 1's first-round shard against
       slot_plain); `sharded_registration_icp` on the fallback cloud
       (held to the run-grid fallback, kernel-2 launches a rank =
       iterations GN + 1 correspondence; kernel 2 on rank 0's shard
       against fused_plain); `global_optimization` on a sphere2500-sized
       graph (ATE, node 0, sharded against D = 1, ms an iteration, peak
       memory); `bundle_adjustment` at the size of BAL's Trafalgar
       problem (RMSE, sharded against D = 1 after scale alignment);
       `RGBDSlam` over phase 4k's 20 frames, whole and with a save and
       restore at frame 10 (trajectory held to the truth, restored state
       equal, ranks' graphs equal); `bench.scaling` (printed only); then
       every path at the test sizes on the card's 2 ranks against 2 CPU
       gloo ranks;
  5. one JSON line of per-kernel numbers, then the result line.

Any failure raises and exits non-zero. Without a card it exits
non-zero before printing a result; it never falls back to the CPU.
"""
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time

# the H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# issue: 4 warp-instructions a clock an SM, each for 32 threads
ISSUE_PER_CLOCK_SM = 4 * 32
# instructions a (query, lane) visit in the hot loops, counted from the
# sources: kernel 3: 7 for d2, the r^2 cut, the clamp, the scale, the
# exp, zeroing a weight past r, 5 moment sums; kernel 4: 8 rounded
# operations, the compare and 2 selects
K3_INSTR_PER_VISIT = 17
K4_INSTR_PER_VISIT = 11
# kernel 1: 3 FMUL and 4 FADD rounded apart, the LOP3 that packs the key,
# the IMNMX that keeps the least; kernel 2: 6 for the score, the strict
# `<`, the tie flag (2) and two selects of (score, lane), and half a
# shared-memory read
K1_INSTR_PER_VISIT = 9
K2_INSTR_PER_VISIT = 12
# the brute-force 1-NN kernel (csrc/bruteforce_nn.cu): 3 FSUB, 3 FMUL
# and 2 FADD rounded apart (8 f32 operations a pair, none fused), the
# strict `<` and two selects
BF_INSTR_PER_PAIR = 11
BF_OPS_PER_PAIR = 8
# KinFu's levels the brute-force kernel is held at: 1 (320x240, the
# largest brute-force level) and 3 (80x60, few query blocks: the points
# are split over many)
BF_LEVELS = (1, 3)
# the raycast kernel (csrc/tsdf_raycast.cu) is held at KinFu's four level
# shapes on its 512^3 volume, integrated from the trajectory's first
# RAYCAST_FRAMES frames and seen from the next frame's pose; its bound
# counts the bytes a ray needs: 4 B a march step, 20 B of its set-up
# (direction, entry and exit time), for a march hit the refinement's 6
# samples of 8 corners of tsdf and weight, for a final hit the
# gradient's 6 samples of 8 tsdf corners and 12 B of colour, and 40 B
# of outputs
RAYCAST_LEVELS = (0, 1, 2, 3)
RAYCAST_FRAMES = 3
RAYCAST_RAY_BYTES = 20 + 40
RAYCAST_REFINE_BYTES = 6 * 8 * 8
RAYCAST_HIT_BYTES = 6 * 8 * 4 + 12

N_POINTS = 1_000_000
RADIUS = 0.05
ITERS = 20
REL_TOL = 1e-6
POSE_TOL = 1e-3
AGREE_MIN = 0.999
TIMED_LAUNCHES = 20
FALLBACK_SIDE = 1.4          # [0,1.4]^3: the pool plan needs a cap > 128
GN_REL_TOL = 1e-4            # kernel vs plain GN sums, per group
# the run grid's d2 is the f32 expansion |c|^2 - 2 e.c + |e|^2 with c, e
# up to 1.5 cells from the cell centre: its rounding is a few ulp of
# (1.5 cell)^2, about 1e-8 at the evaluate plan's 0.05 cells, which is
# sqrt(1e-8) = 1e-4 in distance at worst and about 2e-5 in the rmse of
# a perfect alignment
EVAL_D2_NOISE = 1e-8
EVAL_RMSE_MAX = 5e-5
GMM_RTOL, GMM_ATOL = 2e-5, 1e-5
NO_LIBRARY = ("no single PyTorch call computes a sorted-lane masked argmin "
              "with a packed-attribute fetch, or these truncated moments")
BF_LIBRARY = ("torch.cdist + argmin over the valid points in tiles of "
              "8192 queries, which rounds differently and has no mask")
BF_LIBRARY_TILE = 8192
NO_LIBRARY_NN = ("no single PyTorch call computes a masked argmin with the "
                 "smallest-target-index tie rule; composite_ms times "
                 "torch.cdist + min over the same blocks, which rounds "
                 "differently and has no r^2 mask")
# the wavy sheet of the cell-grid runs (the surface of _surface_pair over
# [0,3]^2 with 2 mm of noise): its pool and roll plans are rejected
SHEET_POINTS = 500_000
SHEET_RADIUS = 0.008
SHEET_SHIFT = (0.004, -0.003, 0.002)
QUERY_FILL = 1.0e18          # an empty query slot of the roll/cell grids


def _rot_z(np, ang):
    return np.asarray([[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)


def _headline_clouds(np, n, side=2.0, seed=0):
    """bench.py's headline cloud: n uniform points in [0,side]^3 with
    unit normals, and the source it rotates by 0.02 rad about z and
    shifts; returns (tgt, normals, src, true pose)."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(size=(n, 3)).astype(np.float32) * np.float32(side)
    tn = rng.normal(size=(n, 3)).astype(np.float32)
    tn /= np.linalg.norm(tn, axis=1, keepdims=True)
    R = _rot_z(np, 0.02)
    t = np.float32([0.01, -0.02, 0.005])
    src = (tgt - t) @ R
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return tgt, tn, src, T


def _filterreg_pair(np, n, seed=2):
    """tests/test_filterreg.py's grid case (3000 points in [0,1]^3,
    sigma_initial 0.08, shift (0.02, -0.015, 0.01)) with n points in
    [0,1]^3, every length scaled by (3000/n)^(1/3) so the cell
    occupancy stays the same: (src, tgt, sigma_initial, true pose)."""
    s = (3000 / n) ** (1.0 / 3.0)
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(size=(n, 3)).astype(np.float32)
    t = np.float32([0.02, -0.015, 0.01]) * np.float32(s)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    return tgt - t, tgt, 0.08 * s, T


def _surface_pair(np, n=40_000):
    """A wavy sheet (a sparse-occupancy surface scan, as in
    tests/test_poolgrid_compact.py) and a shifted copy: (src, tgt)."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 2.0, size=(n, 2)).astype(np.float32)
    z = 0.25 * np.sin(3.0 * xy[:, 0]) * np.cos(2.0 * xy[:, 1]) \
        + 0.02 * rng.normal(size=n).astype(np.float32)
    tgt = np.concatenate([xy, z[:, None].astype(np.float32)], -1)
    return tgt + np.float32([0.004, -0.003, 0.002]), tgt


def _color_field(np, pts):
    """0.5 + 0.4 sin(4x) cos(3y) on all three channels."""
    c = 0.5 + 0.4 * np.sin(4.0 * pts[:, :1]) * np.cos(3.0 * pts[:, 1:2])
    return np.repeat(c, 3, axis=1).astype(np.float32)


def _sheet(np, n=SHEET_POINTS, side=3.0, seed=1):
    """n points on _surface_pair's surface z = 0.25 sin(3x) cos(2y) over
    [0,side]^2 with N(0, 2 mm) noise, and the surface's unit normals:
    (points, normals)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, side, size=(n, 2)).astype(np.float32)
    x, y = xy[:, 0], xy[:, 1]
    z = 0.25 * np.sin(3.0 * x) * np.cos(2.0 * y) \
        + 0.002 * rng.normal(size=n).astype(np.float32)
    fx = 0.75 * np.cos(3.0 * x) * np.cos(2.0 * y)
    fy = -0.5 * np.sin(3.0 * x) * np.sin(2.0 * y)
    nv = np.column_stack([-fx, -fy, np.ones_like(fx)])
    nv /= np.linalg.norm(nv, axis=1, keepdims=True)
    return (np.column_stack([xy, z]).astype(np.float32),
            nv.astype(np.float32))


# the global-registration scene (phase 4g): a room corner in metres, a
# floor over [0,4]^2, a wavy wall and six objects that float at least
# 0.15 m above the floor and stand at least 0.3 m apart: (kind, centre,
# size) with size the box's edges, the sphere's radius or the cylinder's
# (radius, height)
SCENE_OBJECTS = (
    ("box", (0.8, 0.8, 0.30), (0.40, 0.30, 0.25)),
    ("box", (2.0, 0.9, 0.40), (0.60, 0.20, 0.35)),
    ("box", (3.2, 1.0, 0.45), (0.25, 0.25, 0.50)),
    ("sphere", (0.9, 2.4, 0.45), 0.25),
    ("cylinder", (2.1, 2.4, 0.45), (0.15, 0.50)),
    ("box", (3.2, 2.5, 0.40), (0.50, 0.40, 0.15)),
)
SCENE_WALL_HEIGHT = 1.5
SCENE_NOISE = 0.002          # m, Gaussian on each coordinate
SCENE_OUTLIERS = 0.005       # share of uniform outliers in the room box
SCENE_AXIS = (1.0, 2.0, 3.0)
SCENE_ANGLE = 0.6            # rad, about SCENE_AXIS
SCENE_SHIFT = (0.4, -0.3, 0.2)


def _wall_y(np, x):
    return 3.9 + 0.08 * np.sin(2.5 * x)


def _scene_parts(np):
    """(area, sampler) per surface: the floor, the wall, the objects;
    a sampler maps (rng, count) to [count, 3] points on its surface."""
    def floor(rng, m):
        return np.column_stack([rng.uniform(0, 4, (m, 2)), np.zeros(m)])

    def wall(rng, m):
        x = rng.uniform(0, 4, m)
        return np.column_stack([x, _wall_y(np, x),
                                rng.uniform(0, SCENE_WALL_HEIGHT, m)])

    def box(c, e):
        e = np.asarray(e)
        faces = [(a, sgn) for a in range(3) for sgn in (-1, 1)]
        areas = np.asarray([np.prod(np.delete(e, a)) for a, _ in faces])

        def sample(rng, m):
            f = rng.choice(len(faces), m, p=areas / areas.sum())
            p = rng.uniform(-0.5, 0.5, (m, 3)) * e
            for i, (a, sgn) in enumerate(faces):
                p[f == i, a] = sgn * e[a] / 2
            return p + c
        return float(areas.sum()), sample

    def sphere(c, r):
        def sample(rng, m):
            v = rng.normal(size=(m, 3))
            return c + r * v / np.linalg.norm(v, axis=1, keepdims=True)
        return 4 * np.pi * r * r, sample

    def cylinder(c, rh):
        r, h = rh
        side, cap = 2 * np.pi * r * h, np.pi * r * r

        def sample(rng, m):
            part = rng.choice(3, m, p=np.asarray([side, cap, cap])
                              / (side + 2 * cap))
            ang = rng.uniform(0, 2 * np.pi, m)
            rad = np.where(part == 0, r, r * np.sqrt(rng.uniform(0, 1, m)))
            z = np.where(part == 0, rng.uniform(-h / 2, h / 2, m),
                         np.where(part == 1, -h / 2, h / 2))
            return c + np.column_stack([rad * np.cos(ang),
                                        rad * np.sin(ang), z])
        return side + 2 * cap, sample

    make = {"box": box, "sphere": sphere, "cylinder": cylinder}
    parts = [(16.0, floor), (4.04 * SCENE_WALL_HEIGHT, wall)]
    return parts + [make[k](np.asarray(c), sz) for k, c, sz in
                    SCENE_OBJECTS]


def global_scene(np, n, seed):
    """n points [n, 3] f32 sampled from the scene's surfaces in
    proportion to their areas, with SCENE_NOISE of noise, SCENE_OUTLIERS
    of them uniform in the room's box."""
    rng = np.random.default_rng(seed)
    parts = _scene_parts(np)
    n_out = int(round(SCENE_OUTLIERS * n))
    areas = np.asarray([a for a, _ in parts])
    counts = rng.multinomial(n - n_out, areas / areas.sum())
    pts = [smp(rng, m) for (_, smp), m in zip(parts, counts)]
    pts.append(rng.uniform(0, 1, (n_out, 3))
               * np.asarray([4.0, 4.0, SCENE_WALL_HEIGHT]))
    pts = np.concatenate(pts) + rng.normal(size=(n, 3)) * SCENE_NOISE
    return pts[rng.permutation(n)].astype(np.float32)


def scene_motion(np):
    """(the motion applied to the source, the true pose T with
    T @ source = target): SCENE_ANGLE about SCENE_AXIS and
    SCENE_SHIFT."""
    axis = np.asarray(SCENE_AXIS) / np.linalg.norm(SCENE_AXIS)
    K = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0]])
    M = np.eye(4)
    M[:3, :3] = np.eye(3) + np.sin(SCENE_ANGLE) * K \
        + (1 - np.cos(SCENE_ANGLE)) * K @ K
    M[:3, 3] = SCENE_SHIFT
    return M, np.linalg.inv(M).astype(np.float32)


def scene_pair(np, n, seeds=(11, 12)):
    """Target and source sampled independently from the scene (two
    seeds), the source then moved by `scene_motion`: (target, source,
    true pose)."""
    tgt = global_scene(np, n, seeds[0])
    src = global_scene(np, n, seeds[1])
    M, T_true = scene_motion(np)
    src = (src.astype(np.float64) @ M[:3, :3].T + M[:3, 3]).astype(
        np.float32)
    return tgt, src, T_true


def object_boxes(np, margin=0.08):
    """[6, 2, 3] (low, high) corners of each object's box widened by
    `margin`: the room within which its points lie."""
    out = []
    for kind, c, sz in SCENE_OBJECTS:
        c = np.asarray(c)
        half = {"box": lambda: np.asarray(sz) / 2,
                "sphere": lambda: np.full(3, sz),
                "cylinder": lambda: np.asarray([sz[0], sz[0], sz[1] / 2])
                }[kind]() + margin
        out.append((c - half, c + half))
    return np.asarray(out)


GLOBAL_POINTS = 1_000_000
GLOBAL_SMALL_POINTS = 10_000
GLOBAL_VOXEL = 0.02          # v: Open3D's global-registration tutorial
GLOBAL_WARM_RUNS = 3
GLOBAL_PHASE_S = 60.0
PLANE_MAX_DEG = 1.0
PLANE_FLOOR_SHARE = 0.90
FGR_MAX_RAD = 0.05           # and 2v at the source's centroid
REFINE_MIN_FITNESS = 0.95    # the scene allows about 0.99 (PERF.md)
STRAY_CLUSTER_SHARE = 0.005


def fpfh_moved_pairs(np, fa, fb, weight):
    """Rows of two [N, 33] histograms, each either equal within 1e-4
    relative (`close`), or differing by one pair's `weight` [N] moved
    from one bin to another in one or more of the three 11-bin blocks
    (`moved`): a pair whose `atan2` or `floor` rounds across a bin edge
    in one computation only, or whose source / target swap
    (|angle1| < |angle2|) falls the other way on a near-tie, which
    mirrors its f2 bin and may move its f0 and f1 bins. Returns
    (close, moved)."""
    diff = fb - fa
    tol = 1e-4 * np.maximum(np.abs(fa).max(-1, keepdims=True), 1.0)
    close = (np.abs(diff) <= tol).all(-1)
    moved = np.zeros(len(fa), bool)
    for i in np.nonzero(~close)[0]:
        d = diff[i].reshape(3, 11)
        ok = True
        for blk in d:
            big = np.nonzero(np.abs(blk) > tol[i, 0])[0]
            if big.size == 0:
                continue
            ok &= (big.size == 2 and abs(blk[big].sum()) <= tol[i, 0]
                   and bool(np.allclose(np.abs(blk[big]), weight[i],
                                        rtol=1e-4)))
        moved[i] = ok
    return close, moved


def run_global_pipeline(torch, ctt, src, tgt, v, device, counts=None,
                        refine=True):
    """The global-registration pipeline through the public entries, on
    `device` (pipeline_demo.py's point-cloud steps, then Open3D's
    global-registration tutorial at voxel v; with `refine`, its ICP
    refinement on the full clouds): returns (outputs, ms per step).
    With `counts`, the outputs hold the launches made inside FGR."""
    reg, knn = ctt.registration, ctt.knn
    cuda = torch.device(device).type == "cuda"
    ms, out = {}, {}

    def step(name, fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if cuda:
            torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return r

    s_full = ctt.geometry.PointCloud(torch.as_tensor(src), device=device)
    t_full = ctt.geometry.PointCloud(torch.as_tensor(tgt), device=device)
    sd, td = step("1 voxel_down_sample", lambda: (
        s_full.voxel_down_sample(v), t_full.voxel_down_sample(v)))
    out["voxels"] = (len(sd), len(td))
    hyb = knn.KDTreeSearchParamHybrid
    step("2 estimate_normals", lambda: (
        sd.estimate_normals(hyb(2 * v, 30)),
        td.estimate_normals(hyb(2 * v, 30))))
    (sd, _), (td, _) = step("3 remove_statistical_outliers", lambda: (
        sd.remove_statistical_outliers(20, 2.0),
        td.remove_statistical_outliers(20, 2.0)))
    out["down"] = (sd, td)
    out["plane"], out["inliers"] = step(
        "4 segment_plane", lambda: td.segment_plane(0.05, 3, 50))
    rest = step("5a select_by_index",
                lambda: td.select_by_index(out["inliers"], invert=True))
    out["rest"] = rest
    out["labels"] = step("5b cluster_dbscan",
                         lambda: rest.cluster_dbscan(0.05, 10))
    fs, ft = step("6 compute_fpfh_feature", lambda: (
        reg.compute_fpfh_feature(sd, hyb(5 * v, 100)),
        reg.compute_fpfh_feature(td, hyb(5 * v, 100))))
    out["features"] = (fs, ft)
    before = counts() if counts else None
    out["fgr"] = step("7 fast_global_registration", lambda: (
        reg.fast_global_registration(
            sd, td, fs, ft, reg.FastGlobalRegistrationOption(
                maximum_correspondence_distance=0.5 * v))))
    if counts:
        after = counts()
        out["fgr_launches"] = {k: after[k] - before[k] for k in after}
    out["full"] = (s_full, t_full)
    if not refine:
        return out, ms
    step("8a estimate_normals (full target)",
         lambda: t_full.estimate_normals(hyb(2 * v, 30)))
    out["icp"] = step("8b registration_icp", lambda: reg.registration_icp(
        s_full, t_full, 0.4 * v, out["fgr"].transformation,
        reg.TransformationEstimationPointToPlane(),
        reg.ICPConvergenceCriteria(1e-6, 1e-6, 30)))
    return out, ms


def icp_branch(np, source, target, max_dist, init):
    """The branch `registration_icp` takes for point-to-plane on these
    clouds: "brute force", "pooled", "run", "roll", "cell" or "hash"
    (its planners, in its order)."""
    from cupoch_tpu_torch.knn import cellgrid, poolgrid, rollgrid, rungrid
    from cupoch_tpu_torch.registration import registration as regmod

    if len(target) <= regmod._GRID_THRESHOLD:
        return "brute force"
    tgt = target.points.cpu().numpy()
    src = source.points.cpu().numpy() @ init[:3, :3].T + init[:3, 3]
    if poolgrid.plan_poolgrid(tgt, max_dist, query_points=src,
                              est=2) is not None:
        return "pooled"
    if rungrid.plan_rungrid(tgt, max_dist, query_points=src,
                            nch=4) is not None:
        return "run"
    if rollgrid.plan_rollgrid(tgt, max_dist) is not None:
        return "roll"
    if cellgrid.plan_cellgrid(tgt, max_dist) is not None:
        return "cell"
    return "brute force" if len(target) <= regmod._BRUTE_FALLBACK_MAX \
        else "hash"


def pose_errors(np, T, T_true, centroid):
    """(rotation angle of T against T_true in rad, how far T moves
    `centroid` from where T_true puts it, the largest translation
    column gap), in f64."""
    T, T_true = T.astype(np.float64), T_true.astype(np.float64)
    R = T[:3, :3] @ T_true[:3, :3].T
    rad = float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
    c = np.asarray(centroid, np.float64)
    moved = float(np.linalg.norm((T[:3, :3] - T_true[:3, :3]) @ c
                                 + T[:3, 3] - T_true[:3, 3]))
    return rad, moved, float(np.abs(T[:3, 3] - T_true[:3, 3]).max())


def check_global(np, out, T_true, v):
    """The limits of the global-registration phase on one run's outputs;
    raises on a miss. Returns a line of what was found."""
    plane = out["plane"]
    deg = float(np.degrees(np.arccos(min(1.0, abs(plane[2])
                                         / np.linalg.norm(plane[:3])))))
    td = out["down"][1]
    z = td.points[:, 2].cpu().numpy()
    floor = np.abs(z) <= 0.01                  # the floor's voxels
    inl = np.zeros(len(td), bool)
    inl[out["inliers"]] = True
    share = float(inl[floor].mean())
    if deg > PLANE_MAX_DEG or share < PLANE_FLOOR_SHARE:
        raise AssertionError(f"plane {plane}: {deg:.3f} deg from z, "
                             f"{share:.4f} of the floor's voxels")
    # the six objects: six distinct clusters, each holding its box's
    # points and no point outside it; the wall one more cluster; any
    # other cluster a stray fragment
    labels, pr = out["labels"], out["rest"].points.cpu().numpy()
    found = []
    for lo, hi in object_boxes(np):
        inb = ((pr >= lo) & (pr <= hi)).all(1)
        lab = labels[inb & (labels >= 0)]
        top = np.bincount(lab).argmax() if lab.size else -1
        if top < 0 or (lab == top).mean() < 0.99 \
                or not inb[labels == top].all():
            raise AssertionError(f"object box {lo}-{hi} is not one "
                                 f"cluster of its own")
        found.append(int(top))
    if len(set(found)) != 6:
        raise AssertionError(f"objects share clusters: {found}")
    sizes = np.bincount(labels[labels >= 0])
    others = np.setdiff1d(np.nonzero(sizes)[0], found)
    wall = others[np.argmax(sizes[others])] if others.size else -1
    # the wall's cluster: its points on the wall's surface (within 2 cm,
    # ten times the noise) but for outliers that joined it as border
    # points
    wall_pts = pr[labels == wall]
    on_wall = np.abs(wall_pts[:, 1] - _wall_y(np, wall_pts[:, 0])) <= 0.02
    if wall < 0 or on_wall.mean() < 0.99:
        raise AssertionError("the wall is not one cluster")
    stray = sizes[np.setdiff1d(others, [wall])].sum() / max(sizes.sum(), 1)
    if stray > STRAY_CLUSTER_SHARE:
        raise AssertionError(f"stray clusters hold {stray:.4f} of the "
                             f"clustered points")
    # FGR: the rotation error, and how far the pose moves the source's
    # centroid from where the true pose puts it (the translation column
    # is the displacement of the room's corner, 2.9 m from the scene's
    # centre, where each 0.01 rad of rotation error alone can move it
    # 2.9 cm)
    f_rad, f_c, f_t = pose_errors(np, out["fgr"].transformation, T_true,
                                  out["full"][0].points.mean(0).cpu()
                                  .numpy())
    Tf = out["fgr"].transformation
    if not np.isfinite(Tf).all() or f_rad > FGR_MAX_RAD or f_c > 2 * v:
        raise AssertionError(f"FGR pose {f_rad:.4f} rad off, the "
                             f"centroid {f_c:.4f} m off")
    icp = out["icp"]
    err = float(np.abs(icp.transformation - T_true).max())
    if not np.isfinite(icp.transformation).all() or err > POSE_TOL \
            or icp.fitness < REFINE_MIN_FITNESS:
        raise AssertionError(f"refined pose error {err}, fitness "
                             f"{icp.fitness}")
    return (f"plane {deg:.4f} deg from z, inliers {len(out['inliers'])} "
            f"({share:.4f} of {int(floor.sum())} floor voxels); "
            f"{int((sizes > 0).sum())} clusters (objects {found}, wall "
            f"{int(wall)}, stray share {stray:.5f}); FGR fitness "
            f"{out['fgr'].fitness:.4f} rotation {f_rad:.5f} rad centroid "
            f"{f_c:.5f} m (translation column {f_t:.5f} m); refined "
            f"fitness {icp.fitness:.6f} "
            f"rmse {icp.inlier_rmse:.6e} iterations {icp.iterations} pose "
            f"error {err:.3e}")


def global_registration(np, torch, ctt, reset_counts, counts, path_counts,
                        card):
    """Phase 4g: the global-registration pipeline at GLOBAL_POINTS a
    cloud (one cold run, then GLOBAL_WARM_RUNS warm ones, each step's
    ms), its limits and launch counts, then the card against the CPU on
    GLOBAL_SMALL_POINTS."""
    from cupoch_tpu_torch.knn import rungrid

    t_phase = time.perf_counter()
    v = GLOBAL_VOXEL
    tgt, src, T_true = scene_pair(np, GLOBAL_POINTS)
    marks = [("scene", time.perf_counter())]
    torch.cuda.synchronize()
    reset_counts()
    out, cold = run_global_pipeline(torch, ctt, src, tgt, v, "cuda", counts)
    path_counts["global registration"] = c = counts()
    marks.append(("cold run", time.perf_counter()))
    sd, td = out["down"]
    fs, ft = out["features"]
    # FGR's inputs and pose, for fgr_host_check.py (the JAX package's
    # FGR on the same clouds and features, on a host with JAX)
    os.makedirs("chiprun_out", exist_ok=True)
    np.savez_compressed(
        "chiprun_out/global_down.npz", src=sd.points.cpu().numpy(),
        tgt=td.points.cpu().numpy(), fs=fs.data.cpu().numpy(),
        ft=ft.data.cpu().numpy(), fgr=out["fgr"].transformation,
        src_centroid=out["full"][0].points.mean(0).cpu().numpy())
    line = check_global(np, out, T_true, v)
    # FGR ends in evaluate_registration: one correspondence launch of
    # kernel 2 when the run plan accepts the down-sampled target at
    # 0.5v, else one of the brute-force kernel
    eplan = rungrid.plan_rungrid(td.points.cpu().numpy(), 0.5 * v,
                                 margin=0.0, nch=0)
    want_fgr = "fused_corres" if eplan is not None else "bruteforce_nn"
    fl = out["fgr_launches"]
    if fl[want_fgr] != 1 or sum(fl.values()) != 1:
        raise AssertionError(f"FGR launches {fl}, expected one "
                             f"{want_fgr} launch")
    s_full, t_full = out["full"]
    branch = icp_branch(np, s_full, t_full, 0.4 * v,
                        out["fgr"].transformation)
    it = out["icp"].iterations
    icp_c = {k: c[k] - fl[k] for k in c}
    kernel = {"pooled": "slot", "roll": "nn", "cell": "nn",
              "brute force": "bruteforce_nn"}.get(branch)
    if kernel:
        _expect("global registration, refinement", icp_c, it, kernel)
    elif branch == "run":
        if icp_c != {**{k: 0 for k in c}, "fused_gn": it,
                     "fused_corres": 1}:
            raise AssertionError(f"refinement launches {icp_c}")
    elif any(icp_c.values()):
        raise AssertionError(f"refinement launches {icp_c} on {branch}")
    print(f"path: global registration, {GLOBAL_POINTS} points a cloud, "
          f"voxel {v}: down-sampled {out['voxels']} -> {len(sd)}, "
          f"{len(td)} after outlier removal; FPFH {fs.dimension()} x "
          f"{fs.num()}, {ft.num()}; {line}; FGR launches {fl} (the run "
          f"plan at 0.5v {'accepts' if eplan else 'rejects'} the target: "
          f"{'kernel 2' if eplan else 'the brute-force kernel'}); "
          f"refinement on the "
          f"{branch} branch, launches {icp_c}; path launches {c}")
    marks.append(("checks", time.perf_counter()))
    warm = []
    for _ in range(GLOBAL_WARM_RUNS):
        o, ms = run_global_pipeline(torch, ctt, src, tgt, v, "cuda")
        check_global(np, o, T_true, v)
        warm.append(ms)
    steps = "; ".join(
        f"{k} {cold[k]:.2f} / {statistics.median(w[k] for w in warm):.2f}"
        for k in cold)
    total_w = statistics.median(sum(w.values()) for w in warm)
    print(f"timing: global registration ms, cold / median of "
          f"{GLOBAL_WARM_RUNS} warm: {steps}; total {sum(cold.values()):.2f}"
          f" / {total_w:.2f} on {card}")
    marks.append(("warm runs and checks", time.perf_counter()))
    profile(torch, "global registration pipeline, one warm run",
            lambda: run_global_pipeline(torch, ctt, src, tgt, v, "cuda"),
            total_w / 1e3, warm_up=False)
    del out, o
    marks.append(("profiled run", time.perf_counter()))
    global_small(np, torch, ctt, v)
    marks.append(("small check", time.perf_counter()))
    phase_s = time.perf_counter() - t_phase
    last = t_phase
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - last:.1f}")
        last = t
    print(f"phase 4g: {phase_s:.1f} s ({', '.join(parts)})")
    if phase_s > GLOBAL_PHASE_S:
        raise AssertionError(f"phase 4g took {phase_s:.1f} s")


def global_small(np, torch, ctt, v, dev="cuda"):
    """The pipeline up to FGR on a GLOBAL_SMALL_POINTS version of the
    scene on the card and on the port's CPU path (at this size every
    neighbour search, FGR's scoring included, takes brute force; at 20k
    points the voxel clouds pad past 20k and take the run grid, and the
    CPU path's brute-force steps grow with the square of the size):
    equal
    voxel counts; then each later step on the card takes the CPU
    path's input of that step, so a tie broken differently upstream
    does not carry on: FPFH over the same neighbours (the card's)
    equal within the tests' tolerance (`fpfh_moved_pairs`), FGR poses
    within 1e-4 (the same draws), equal DBSCAN labels."""
    from cupoch_tpu_torch.registration import feature as tfeat

    reg, knn = ctt.registration, ctt.knn
    tgt, src, _ = scene_pair(np, GLOBAL_SMALL_POINTS)
    t0 = time.perf_counter()
    cpu, _ = run_global_pipeline(torch, ctt, src, tgt, v, "cpu",
                                 refine=False)
    cpu_s = time.perf_counter() - t0
    gpu, _ = run_global_pipeline(torch, ctt, src, tgt, v, dev,
                                 refine=False)
    if gpu["voxels"] != cpu["voxels"]:
        raise AssertionError(f"voxel counts {gpu['voxels']} on the card, "
                             f"{cpu['voxels']} on the CPU")
    sd, td = cpu["down"]
    sd_g, td_g = sd.to(dev), td.to(dev)
    hyb = knn.KDTreeSearchParamHybrid(5 * v, 100)
    moved_share, own_gap = 0.0, 0.0
    for c_pc, g_pc, f_cpu in ((sd, sd_g, cpu["features"][0]),
                              (td, td_g, cpu["features"][1])):
        # both devices' histograms over the card's neighbours: each
        # device's brute-force d2 (an expansion, rounded to about 4e-6 at
        # these coordinates) would weigh a 2 cm neighbour's 1 / d2 1%
        # apart
        own = reg.compute_fpfh_feature(g_pc, hyb).data.T.cpu().numpy()
        own_gap = max(own_gap, float(np.abs(own - f_cpu.data.T.numpy())
                                     .max() / f_cpu.data.abs().max()))
        idx, d2 = knn.search_neighbors(g_pc.points, g_pc.points, hyb)
        spfh_g = tfeat._spfh(g_pc.points, g_pc.normals, idx)
        f_gpu = tfeat._fpfh(spfh_g, idx, d2).cpu().numpy()
        spfh_g = spfh_g.cpu().numpy()
        idx, d2 = idx.cpu(), d2.cpu()
        spfh_c = tfeat._spfh(c_pc.points, c_pc.normals, idx)
        f_cpu = tfeat._fpfh(spfh_c, idx, d2).numpy()
        spfh_c = spfh_c.numpy()
        idx = idx.numpy()
        cnt = (idx >= 0).sum(-1)
        close, moved = fpfh_moved_pairs(np, spfh_c, spfh_g,
                                        100.0 / np.maximum(cnt - 1.0, 1.0))
        reached = moved | (moved[np.where(idx >= 0, idx, 0)]
                           & (idx >= 0)).any(-1)
        gap = np.abs(f_gpu - f_cpu)[~reached]
        tol = 1e-4 * np.abs(f_cpu).max() + 1e-4 * np.abs(f_cpu[~reached])
        odd = np.nonzero(~(close | moved))[0]
        if odd.size or (gap > tol).any():
            i = odd[0] if odd.size else None
            raise AssertionError(
                f"FPFH on the card and the CPU disagree: {odd.size} SPFH "
                f"rows neither equal nor one moved pair"
                + (f" (row {i}: {np.round(spfh_g[i] - spfh_c[i], 5)}, "
                   f"weight {100.0 / max(cnt[i] - 1.0, 1.0):.5f})"
                   if i is not None else "")
                + f"; {int((gap > tol).any(-1).sum())} unreached FPFH rows "
                f"beyond 1e-4, the largest gap {gap.max():.3e}")
        moved_share = max(moved_share, float(moved.mean()))
    fs, ft = cpu["features"]
    fgr_g = reg.fast_global_registration(
        sd_g, td_g, reg.Feature(fs.data.to(dev)),
        reg.Feature(ft.data.to(dev)), reg.FastGlobalRegistrationOption(
            maximum_correspondence_distance=0.5 * v))
    d_fgr = float(np.abs(fgr_g.transformation
                         - cpu["fgr"].transformation).max())
    labels_g = cpu["rest"].to(dev).cluster_dbscan(0.05, 10)
    d_e2e = float(np.abs(gpu["fgr"].transformation
                         - cpu["fgr"].transformation).max())
    print(f"small input (global registration, {GLOBAL_SMALL_POINTS} points "
          f"a cloud): voxels {gpu['voxels']} on both; FPFH moved-pair rows "
          f"{moved_share:.5f} (over each device's own neighbours the bins "
          f"differ by up to {own_gap:.3e} of the largest); FGR pose "
          f"gap {d_fgr:.3e}; DBSCAN labels "
          f"equal {bool(np.array_equal(labels_g, cpu['labels']))}; end to "
          f"end on each device, FGR pose gap {d_e2e:.3e}; the CPU path "
          f"took {cpu_s:.1f} s")
    if d_fgr > 1e-4 or not np.array_equal(labels_g, cpu["labels"]):
        raise AssertionError("the card and the CPU disagree on the "
                             "global-registration pipeline")


# the RGB-D scene (phase 4k): a room in metres (x right, y down, z
# forward): the floor y = 0.8, the back wall z = 2.8 and the side walls
# x = -1.5 and x = 1.6 as (axis, value), and three boxes on the floor as
# (low, high) corners; a smooth colour texture of world position on
# every surface. The first camera stands ROOM_CAMERA_HEIGHT above the
# room's origin and looks down by ROOM_CAMERA_PITCH_DEG, as a handheld
# scan of objects on a floor does (a level camera sees the box tops and
# the floor's far part under 5-20 deg, where the projective TSDF keeps
# few observed voxels below a surface: PERF.md §6)
ROOM_PLANES = ((1, 0.8), (2, 2.8), (0, -1.5), (0, 1.6))
ROOM_BOXES = (((-1.0, 0.3, 1.8), (-0.5, 0.8, 2.3)),
              ((0.2, 0.2, 2.0), (0.8, 0.8, 2.5)),
              ((-0.25, 0.5, 1.2), (0.25, 0.8, 1.6)))
ROOM_CAMERA_HEIGHT = 0.4
ROOM_CAMERA_PITCH_DEG = 15.0
RGBD_FRAMES = 20
# the camera's motion a frame: 1 cm and 0.3 deg about a tilted axis
RGBD_STEP_SHIFT = (0.005, -0.003, 0.0083)
RGBD_STEP_AXIS = (0.3, 1.0, 0.2)
RGBD_STEP_DEG = 0.3
RGBD_DEPTH_SCALE = 1000.0     # the sensor's uint16 depth in mm
ODO_T_MAX = 5e-3              # hybrid odometry, a pair: translation (m)
ODO_R_MAX = 5e-3              # and ||R_err - I||_F
ODO_WEIGHTED_T_MAX = 1e-2
KINFU_DISTANCE = 0.1          # examples/kinfu_demo.py's ICP threshold
KINFU_RMSE_MAX = 0.01         # trajectory translation RMSE (m)
KINFU_ROT_MAX_DEG = 0.5
RAYCAST_TOL = 0.01            # final raycast depth against the scene
RAYCAST_SHARE_MIN = 0.95
MESH_TOL = 0.016              # about one 8/512 m voxel
MESH_SHARE_MIN = 0.99
KINFU_PROFILED_FRAME = 10
LEVEL_FRAMES = 5              # KinFu from a level camera, printed only
KINFU_PHASE_S = 120.0


# the robotics phase (4r): a 6-joint arm with UR5's published link
# offsets (ur_description's ur5 URDF: shoulder 0.089159 m up, upper arm
# 0.425 m, forearm 0.39225 m, wrists 0.13585 / 0.1197 / 0.093 / 0.09465 /
# 0.0823 m) and box, cylinder and sphere collision shapes, standing on the
# room's floor
ARM_LINKS = (
    ("base_link", '<cylinder radius="0.075" length="0.09"/>',
     '0 0 0.045', '0 0 0'),
    ("shoulder_link", '<cylinder radius="0.06" length="0.15"/>',
     '0 0 0', '0 0 0'),
    ("upper_arm_link", '<box size="0.09 0.09 0.425"/>',
     '0 0 0.2125', '0 0 0'),
    ("forearm_link", '<box size="0.07 0.07 0.392"/>', '0 0 0.196', '0 0 0'),
    ("wrist_1_link", '<cylinder radius="0.04" length="0.12"/>',
     '0 0 0', '1.570796 0 0'),
    ("wrist_2_link", '<cylinder radius="0.04" length="0.12"/>',
     '0 0 0', '0 0 0'),
    ("wrist_3_link", '<sphere radius="0.045"/>', '0 0.05 0', '0 0 0'),
)
ARM_JOINTS = (   # (origin xyz, origin rpy, axis) of joint_0 .. joint_5
    ("0 0 0.089159", "0 0 0", "0 0 1"),
    ("0 0.13585 0", "0 1.570796 0", "0 1 0"),
    ("0 -0.1197 0.425", "0 0 0", "0 1 0"),
    ("0 0 0.39225", "0 1.570796 0", "0 1 0"),
    ("0 0.093 0", "0 0 0", "0 0 1"),
    ("0 0 0.09465", "0 0 0", "0 1 0"),
)


def _arm_urdf():
    links = []
    for name, geom, xyz, rpy in ARM_LINKS:
        shape = (f'<origin xyz="{xyz}" rpy="{rpy}"/><geometry>{geom}'
                 f'</geometry>')
        links.append(f'  <link name="{name}"><collision>{shape}</collision>'
                     f'<visual>{shape}</visual></link>')
    links.append('  <link name="tool0"/>')
    joints = []
    for k, (xyz, rpy, axis) in enumerate(ARM_JOINTS):
        joints.append(
            f'  <joint name="joint_{k}" type="revolute"><parent link='
            f'"{ARM_LINKS[k][0]}"/><child link="{ARM_LINKS[k + 1][0]}"/>'
            f'<origin xyz="{xyz}" rpy="{rpy}"/><axis xyz="{axis}"/></joint>')
    joints.append('  <joint name="tool_joint" type="fixed"><parent link='
                  '"wrist_3_link"/><child link="tool0"/><origin '
                  'xyz="0 0.0823 0"/></joint>')
    return '<robot name="arm">\n' + "\n".join(links + joints) \
        + "\n</robot>\n"


ARM_URDF = _arm_urdf()
ARM_BASE_XYZ = (0.55, 0.8, 1.45)    # on the floor, by box 3, room frame


def arm_base(np):
    """The arm base's pose in the room (y down): its z axis up."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    T[:3, 3] = ARM_BASE_XYZ
    return T


def room_view(np, pitch_deg=ROOM_CAMERA_PITCH_DEG,
              height=ROOM_CAMERA_HEIGHT):
    """The first camera's camera-to-room pose, `height` above the room's
    origin and looking down by `pitch_deg`, in f64."""
    a = np.radians(pitch_deg)
    P = np.eye(4)
    P[1:3, 1:3] = [[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]]
    P[1, 3] = -height
    return P


def rgbd_pose(np, k):
    """Camera-to-world pose of frame k in the first camera's frame (the
    world of KinFu's estimates): k steps of RGBD_STEP_DEG about
    RGBD_STEP_AXIS and RGBD_STEP_SHIFT, in f64."""
    axis = np.asarray(RGBD_STEP_AXIS) / np.linalg.norm(RGBD_STEP_AXIS)
    K = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0]])
    a = np.radians(RGBD_STEP_DEG)
    step = np.eye(4)
    step[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    step[:3, 3] = RGBD_STEP_SHIFT
    return np.linalg.matrix_power(step, k)


def room_texture(np, p):
    """uint8 RGB of world points p [..., 3]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rgb = np.stack([
        0.5 + 0.2 * np.sin(6.0 * x + 2.0 * z) * np.cos(5.0 * y)
        + 0.15 * np.sin(3.0 * z - 4.0 * x),
        0.5 + 0.2 * np.cos(5.5 * y - 3.0 * x) * np.sin(4.5 * z)
        + 0.1 * np.sin(7.0 * x),
        0.5 + 0.25 * np.sin(4.0 * x + 6.0 * y + 3.0 * z)], -1)
    return np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


def render_room(np, pose, width, height, fx, fy, cx, cy):
    """The room seen from camera-to-world `pose` through a pinhole
    camera, at each pixel's centre: (RGB uint8 [H, W, 3], z-depth f32
    [H, W] in metres, 0 where a ray meets nothing)."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    R, o = pose[:3, :3], pose[:3, 3]
    d = d_cam @ R.T                    # a ray's parameter is its z-depth
    best = np.full((height, width), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis, value in ROOM_PLANES:
            t = (value - o[axis]) / d[..., axis]
            best = np.where((t > 0) & (t < best), t, best)
        for lo, hi in ROOM_BOXES:
            t1 = (np.asarray(lo) - o) / d
            t2 = (np.asarray(hi) - o) / d
            t_in = np.nanmax(np.minimum(t1, t2), -1)
            t_out = np.nanmin(np.maximum(t1, t2), -1)
            hit = (t_out >= t_in) & (t_in > 0) & (t_in < best)
            best = np.where(hit, t_in, best)
    found = np.isfinite(best)
    t = np.where(found, best, 0.0)
    rgb = room_texture(np, o + d * t[..., None])
    rgb[~found] = 0
    return rgb, t.astype(np.float32)


def rendered_surface(np, k, level):
    """The room's surface as frame k of `rgbd_pose`'s trajectory sees it
    through the PrimeSense camera at KinFu's pyramid level `level`
    (640x480 halved `level` times), in the first camera's frame: [n, 3]
    f32, a point a pixel that meets the room."""
    s = 0.5 ** level
    w, h, f, cx, cy = int(640 * s), int(480 * s), 525.0 * s, 319.5 * s, \
        239.5 * s
    pose = rgbd_pose(np, k)
    _, depth = render_room(np, room_view(np) @ pose, w, h, f, f, cx, cy)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    z = depth.astype(np.float64)
    pts = np.stack([(u - cx) / f * z, (v - cy) / f * z, z], -1)
    pts = pts[depth > 0] @ pose[:3, :3].T + pose[:3, 3]
    return pts.astype(np.float32)


def room_distance(np, p):
    """Distance of points p [N, 3] in the first camera's frame to the
    nearest surface of the room (its planes and its boxes' faces), in
    f64."""
    P0 = room_view(np)
    p = np.asarray(p, np.float64) @ P0[:3, :3].T + P0[:3, 3]
    dist = np.full(p.shape[0], np.inf)
    for axis, value in ROOM_PLANES:
        dist = np.minimum(dist, np.abs(p[:, axis] - value))
    for lo, hi in ROOM_BOXES:
        lo, hi = np.asarray(lo), np.asarray(hi)
        outside = np.linalg.norm(np.maximum(np.maximum(lo - p, p - hi), 0.0),
                                 axis=-1)
        inside = np.minimum(p - lo, hi - p).min(-1)
        dist = np.minimum(dist, np.where(inside > 0, inside, outside))
    return dist


def room_depth(np, pose, intrinsic, view=None):
    """(RGB, z-depth) of the room seen from `pose` in the frame of the
    first camera, whose camera-to-room pose is `view` (None:
    `room_view`)."""
    fx, fy = intrinsic.get_focal_length()
    cx, cy = intrinsic.get_principal_point()
    view = room_view(np) if view is None else view
    return render_room(np, view @ pose, intrinsic.width, intrinsic.height,
                       fx, fy, cx, cy)


def room_frame(np, ctt, k, intrinsic, device, view=None):
    """Frame k of the trajectory from the first camera `view` as the
    sensor gives it, RGB uint8 and depth uint16 in mm: the colour and
    depth Images on `device`."""
    rgb, depth = room_depth(np, rgbd_pose(np, k), intrinsic, view)
    mm = np.round(depth * RGBD_DEPTH_SCALE).astype(np.uint16)
    Image = ctt.geometry.Image
    return Image(rgb, device=device), Image(mm, device=device)


def write_rgbd_sequence(np, ctt, root, intrinsic, frames):
    """Frames 0 .. frames-1 of the trajectory written under `root` in
    the layout of cupoch's RGB-D test data: `camera_primesense.json`,
    `rgbd/color/%06d.png` (uint8 RGB), `rgbd/depth/%06d.png` (uint16
    mm) and `rgbd/trajectory.log` of the true camera-to-world poses.
    Returns ([(RGB, depth mm)] as written, the true poses)."""
    io = ctt.io
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(root, "rgbd", sub), exist_ok=True)
    io.write_pinhole_camera_intrinsic(
        os.path.join(root, "camera_primesense.json"), intrinsic)
    out, poses = [], []
    for k in range(frames):
        rgb, depth = room_depth(np, rgbd_pose(np, k), intrinsic)
        mm = np.round(depth * RGBD_DEPTH_SCALE).astype(np.uint16)
        for sub, arr in (("color", rgb), ("depth", mm)):
            io.write_image(os.path.join(root, "rgbd", sub, f"{k:06d}.png"),
                           arr)
        out.append((rgb, mm))
        poses.append(rgbd_pose(np, k).astype(np.float32))
    io.write_trajectory_log(os.path.join(root, "rgbd", "trajectory.log"),
                            poses)
    return out, poses


def odometry_pair_error(np, T_est, T_true):
    """(translation error in m, ||R_err - I||_F) of T_est against
    T_true."""
    E = np.linalg.inv(np.asarray(T_true, np.float64)) \
        @ np.asarray(T_est, np.float64)
    return (float(np.linalg.norm(E[:3, 3])),
            float(np.linalg.norm(E[:3, :3] - np.eye(3))))


class KinfuClock:
    """Times KinFu's stages inside `process_frame`, each between two
    synchronizations of the card: the pipeline's surface measurement,
    each pyramid level's `registration_icp` (with its iterations and the
    kernel launches it made), the volume's integrate and each level's
    raycast (with the steps its march took). `frames` holds a list of
    (stage, level, ms, extra) a timed frame; `icp_args` each level's
    last ICP inputs. A context manager;
    while `active` is False, calls pass through untimed."""

    def __init__(self, torch, pipe, counts):
        import importlib

        self.torch, self.pipe, self.counts = torch, pipe, counts
        self.kmod = importlib.import_module("cupoch_tpu_torch.kinfu.kinfu")
        self.frames, self.icp_args, self.active = [], {}, True
        self._pyramid = []

    def _wrap(self, name, fn, level_of):
        def timed(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            before = self.counts()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            level, extra = level_of(args), {}
            if name == "surface measurement":
                self._pyramid = out[2]
            elif name == "raycast":
                extra = {"steps": self.pipe.volume.last_march_steps}
            elif name == "icp":
                after = self.counts()
                self.icp_args[level] = args[:4]
                extra = {"iterations": out.iterations, "launches": {
                    k: after[k] - before[k] for k in after
                    if after[k] != before[k]}}
            self.frames[-1].append((name, level, ms, extra))
            return out
        return timed

    def __enter__(self):
        pipe, vol = self.pipe, self.pipe.volume
        widths = [pipe.intrinsic.scale(0.5 ** i).width
                  for i in range(pipe.option.num_pyramid_levels)]
        self._icp = self.kmod.registration_icp
        self.kmod.registration_icp = self._wrap(
            "icp", self._icp, lambda a: next(
                i for i, p in enumerate(self._pyramid) if p is a[0]))
        pipe.surface_measurement = self._wrap(
            "surface measurement", pipe.surface_measurement, lambda a: None)
        vol.integrate = self._wrap("integrate", vol.integrate,
                                   lambda a: None)
        vol.raycast = self._wrap("raycast", vol.raycast,
                                 lambda a: widths.index(a[0].width))
        return self

    def frame(self, fn):
        """fn() (one process_frame), its stages timed when active."""
        if self.active:
            self.frames.append([])
        return fn()

    def __exit__(self, *exc):
        self.kmod.registration_icp = self._icp
        del self.pipe.surface_measurement
        del self.pipe.volume.integrate, self.pipe.volume.raycast
        return False


def stage_split(frames):
    """Median ms of each (stage, level) over `frames`, in the order of
    the first frame."""
    keys = [(s, lv) for s, lv, _, _ in frames[0]]
    return {k: statistics.median(ms for f in frames for s, lv, ms, _ in f
                                 if (s, lv) == k) for k in keys}


def _split_line(split):
    names = {"surface measurement": "surface measurement",
             "icp": "ICP level", "integrate": "integrate",
             "raycast": "raycast level"}
    return "; ".join(f"{names[s]}{'' if lv is None else f' {lv}'} "
                     f"{ms:.2f}" for (s, lv), ms in split.items())


def odometry_paths(np, torch, ctt, intr, frames, card):
    """Hybrid, colour and weighted RGB-D odometry over every consecutive
    pair of the trajectory, held to the pair's true motion; returns a
    line of their ms."""
    odo = ctt.odometry
    rgbd = [ctt.geometry.RGBDImage.create_from_color_and_depth(c, d)
            for c, d in frames]
    variants = (
        ("hybrid", lambda s, t: odo.compute_rgbd_odometry(s, t, intr)),
        ("colour", lambda s, t: odo.compute_rgbd_odometry(
            s, t, intr, jacobian=odo.RGBDOdometryJacobianFromColorTerm())),
        ("weighted", lambda s, t: odo.compute_weighted_rgbd_odometry(
            s, t, intr)))
    timing = []
    for name, fn in variants:
        ms, t_err, r_err = [], [], []
        for i in range(len(rgbd) - 1):
            T_true = np.linalg.inv(rgbd_pose(np, i + 1)) @ rgbd_pose(np, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(rgbd[i], rgbd[i + 1])
            ms.append((time.perf_counter() - t0) * 1e3)
            ok, T, info = out[0], out[1], out[-1]
            te, re = odometry_pair_error(np, T, T_true)
            t_err.append(te)
            r_err.append(re)
            min_eig = float(np.linalg.eigvalsh(info.astype(np.float64))
                            .min())
            if not ok or not np.isfinite(T).all() or min_eig <= 0.0:
                raise AssertionError(f"odometry {name}, pair {i}: success "
                                     f"{ok}, information eigenvalue "
                                     f"{min_eig}")
        print(f"path: RGB-D odometry ({name}), {len(ms)} pairs at "
              f"{intr.width}x{intr.height}: translation error max "
              f"{max(t_err):.3e} mean {np.mean(t_err):.3e} m, "
              f"||R_err - I||_F max {max(r_err):.3e}; information "
              f"matrices positive definite")
        if name == "hybrid" and (max(t_err) > ODO_T_MAX
                                 or max(r_err) > ODO_R_MAX):
            raise AssertionError("hybrid odometry missed its bounds")
        if name == "weighted" and max(t_err) > ODO_WEIGHTED_T_MAX:
            raise AssertionError("weighted odometry missed its bound")
        timing.append(f"{name} {ms[0]:.1f} / "
                      f"{statistics.median(ms[1:]):.1f}")
    return (f"timing: RGB-D odometry ms a pair, cold / median of "
            f"{len(rgbd) - 2} warm: {'; '.join(timing)} on {card}")


def model_depth(np, pipe, intr):
    """z-depth [H, W] of the pipeline's model raycast from its pose, NaN
    where no ray hits."""
    pose = pipe.cur_pose.astype(np.float64)
    extrinsic = np.linalg.inv(pipe.cur_pose).astype(np.float32)
    pts = pipe.volume.raycast(intr, extrinsic, pipe.option.sdf_trunc,
                              project_valid_depth_only=False) \
        .points.cpu().numpy().astype(np.float64)
    return (pts @ np.linalg.inv(pose)[:3, :3].T + np.linalg.inv(pose)[:3, 3]
            )[:, 2].reshape(intr.height, intr.width)


def depth_share(np, z, truth, cutoff):
    """Share of the pixels whose true depth lies in (0, cutoff] where z
    is within RAYCAST_TOL of it."""
    inside = (truth > 0) & (truth <= cutoff)
    close = np.isfinite(z) & (np.abs(z - truth) <= RAYCAST_TOL)
    return float(close[inside].mean())


def kinfu_checks(np, torch, pipe, poses, intr):
    """The trajectory, the final raycast and the mesh against the
    scene; raises on a miss. Returns (a line of what was found, the
    mesh's extraction ms)."""
    t_err = [float(np.linalg.norm(P[:3, 3] - rgbd_pose(np, k)[:3, 3]))
             for k, P in enumerate(poses)]
    r_deg = []
    for k, P in enumerate(poses):
        R = P[:3, :3].astype(np.float64) @ rgbd_pose(np, k)[:3, :3].T
        r_deg.append(float(np.degrees(np.arccos(np.clip(
            (np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))))
    rmse = float(np.sqrt(np.mean(np.square(t_err))))
    if rmse > KINFU_RMSE_MAX or max(r_deg) > KINFU_ROT_MAX_DEG:
        raise AssertionError(f"KinFu trajectory: translation RMSE {rmse}, "
                             f"rotation error {max(r_deg)} deg")
    # the model seen from the last estimated pose, as the pipeline sees
    # it for the next frame, against the last frame's true depth; and,
    # to tell tracking from reconstruction, against the scene seen from
    # the estimated pose
    pose = pipe.cur_pose.astype(np.float64)
    z = model_depth(np, pipe, intr)
    truth = {name: room_depth(np, P, intr)[1]
             for name, P in (("true", rgbd_pose(np, len(poses) - 1)),
                             ("estimated", pose))}
    share = {name: depth_share(np, z, t, pipe.option.depth_cutoff)
             for name, t in truth.items()}
    inside = (truth["true"] > 0) & (truth["true"]
                                    <= pipe.option.depth_cutoff)
    hits = float(np.isfinite(z)[inside].mean())
    os.makedirs("chiprun_out", exist_ok=True)
    np.savez_compressed("chiprun_out/kinfu_raycast.npz", raycast=z,
                        true_pose=truth["true"],
                        estimated_pose=truth["estimated"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = pipe.extract_triangle_mesh()
    torch.cuda.synchronize()
    mesh_ms = (time.perf_counter() - t0) * 1e3
    verts = mesh.vertices.cpu().numpy()
    near = float((room_distance(np, verts) <= MESH_TOL).mean()) \
        if len(verts) else 0.0
    line = (f"trajectory translation RMSE {rmse:.3e} m (max "
            f"{max(t_err):.3e}), rotation error max {max(r_deg):.4f} deg; "
            f"final raycast: hits on {hits:.5f} of {int(inside.sum())} "
            f"pixels, within {RAYCAST_TOL} m of the true depth on "
            f"{share['true']:.5f} (of the scene seen from the estimated "
            f"pose on {share['estimated']:.5f}); mesh {len(verts)} vertices "
            f"{int(mesh.triangles.shape[0])} triangles, {near:.5f} within "
            f"{MESH_TOL} m of the scene")
    if share["true"] < RAYCAST_SHARE_MIN or not len(verts) \
            or near < MESH_SHARE_MIN:
        raise AssertionError(f"KinFu reconstruction missed its bounds: "
                             f"{line}")
    return line, mesh_ms


def kinfu_level_view(np, ctt, pipe, intr, dev="cuda"):
    """KinFu from an empty volume over LEVEL_FRAMES frames of the
    trajectory seen from a level camera at the room's origin, whose
    grazing views of the floor and the box tops the projective TSDF
    observes poorly (PERF.md §7): a line with the share of its last
    raycast within RAYCAST_TOL of the true depth, which no limit holds
    (RAYCAST_SHARE_MIN holds the tilted view)."""
    view = room_view(np, 0.0, 0.0)
    pipe.reset()
    pipe.option.distance_threshold = KINFU_DISTANCE
    tracked = 0
    for k in range(LEVEL_FRAMES):
        c, d = room_frame(np, ctt, k, intr, dev, view)
        tracked += bool(pipe.process_frame(
            ctt.geometry.RGBDImage.create_from_color_and_depth(
                c, d, convert_rgb_to_intensity=False)))
    truth = room_depth(np, rgbd_pose(np, LEVEL_FRAMES - 1), intr, view)[1]
    share = depth_share(np, model_depth(np, pipe, intr), truth,
                        pipe.option.depth_cutoff)
    return (f"KinFu level view (no limit), {LEVEL_FRAMES} frames from a "
            f"level camera at the room's origin: {tracked} tracked; the "
            f"last raycast within {RAYCAST_TOL} m of the true depth on "
            f"{share:.5f} of the pixels (the tilted view is held to "
            f"{RAYCAST_SHARE_MIN})")


def kinfu_branches(np, clock):
    """The branch each level's last ICP call took."""
    return {lv: icp_branch(np, src, tgt, thr, init)
            for lv, (src, tgt, thr, init) in sorted(clock.icp_args.items())}


def kinfu_config(ctt):
    """(PrimeSense intrinsics at 640x480, the default KinfuOption with
    the ICP threshold KINFU_DISTANCE: 4 levels, a 512^3 volume over 8 m
    with RGB8 colour, sdf_trunc 0.05, 20 ICP iterations a level)."""
    cam = ctt.camera
    return (cam.PinholeCameraIntrinsic(
        cam.PinholeCameraIntrinsicParameters.PrimeSenseDefault),
        ctt.kinfu.KinfuOption(distance_threshold=KINFU_DISTANCE))


def rgbd_phase(np, torch, ctt, reset_counts, counts, path_counts, card,
               dev="cuda"):
    """Phase 4k: RGB-D odometry and KinectFusion on the room seen
    through `kinfu_config`, along RGBD_FRAMES frames of a known
    trajectory; the stage split, the mesh, peak memory and the busy
    share of one profiled frame; one frame at KinfuOption's default
    threshold 0.5; then the card against the CPU on small frames."""
    t_phase = time.perf_counter()
    marks = []
    # KinFu filters the colour pyramid channel by channel, which the
    # image filter logs a warning for on every level of every frame
    console = ctt.utility.console
    verbosity = console.get_verbosity_level()
    console.set_verbosity_level(console.VerbosityLevel.Error)
    intr, opt = kinfu_config(ctt)
    frames = [room_frame(np, ctt, k, intr, dev) for k in range(RGBD_FRAMES)]
    marks.append(("scene", time.perf_counter()))
    print(odometry_paths(np, torch, ctt, intr, frames, card))
    marks.append(("odometry", time.perf_counter()))

    pipe = ctt.kinfu.KinfuPipeline(intr, opt, device=dev)
    kin = [ctt.geometry.RGBDImage.create_from_color_and_depth(
        c, d, convert_rgb_to_intensity=False) for c, d in frames]
    state_gb = sum(t.numel() * t.element_size() for t in (
        pipe.volume.tsdf, pipe.volume.weight, pipe.volume.color)) / 1e9
    poses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9 - state_gb
    reset_counts()
    with KinfuClock(torch, pipe, counts) as clock:
        for k, frame in enumerate(kin):
            clock.active = k != KINFU_PROFILED_FRAME
            if not clock.active:
                profile(torch, f"KinFu frame {k}, {intr.width}x"
                        f"{intr.height}, {opt.tsdf_resolution}^3",
                        lambda: pipe.process_frame(frame),
                        statistics.median(walls[2:]) / 1e3, warm_up=False)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if not clock.frame(lambda: pipe.process_frame(frame)):
                    raise AssertionError(f"KinFu lost frame {k}")
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            poses.append(pipe.cur_pose.copy())
        path_counts["kinfu"] = c = counts()
        peak_frames = torch.cuda.max_memory_allocated() / 1e9
        marks.append(("KinFu frames", time.perf_counter()))
        clock.active = False
        line, mesh_ms = kinfu_checks(np, torch, pipe, poses, intr)
        peak_mesh = torch.cuda.max_memory_allocated() / 1e9
        branches = kinfu_branches(np, clock)
        last = {lv: e for s, lv, _, e in clock.frames[-1] if s == "icp"}
        steps = {}
        for f in clock.frames:
            for s, lv, _, e in f:
                if s == "raycast":
                    steps.setdefault(lv, []).append(e["steps"])
        max_steps = int(np.ceil(opt.tsdf_length * np.sqrt(3.0)
                                / (0.5 * opt.sdf_trunc))) + 1
        print(f"path: KinFu, {RGBD_FRAMES} frames at {intr.width}x"
              f"{intr.height}, a {opt.tsdf_resolution}^3 volume over "
              f"{opt.tsdf_length} m ({state_gb:.3f} GB of tsdf, weight and "
              f"colour), ICP threshold {opt.distance_threshold}, "
              f"iterations {opt.icp_iterations}: every frame tracked; "
              f"{line}; last frame's ICP levels: " + "; ".join(
                  f"{lv} {branches[lv]} ({len(clock.icp_args[lv][1])} "
                  f"target points, {last[lv]['iterations']} iterations, "
                  f"launches {last[lv]['launches']})" for lv in branches)
              + f"; path launches {c}; raycast march steps a level "
              f"(of {max_steps}) min / median / max over the timed frames: "
              + "; ".join(f"{lv} {min(v)} / {statistics.median(v)} / "
                          f"{max(v)}" for lv, v in steps.items()))
        for lv, br in branches.items():
            it = last[lv]["iterations"]
            kernel = {"pooled": "slot", "roll": "nn", "cell": "nn",
                      "brute force": "bruteforce_nn"}.get(br)
            want = {kernel: it + 1} if kernel else \
                {"fused_gn": it, "fused_corres": 1} if br == "run" else {}
            if last[lv]["launches"] != want:
                raise AssertionError(f"KinFu level {lv} on the {br} branch "
                                     f"made launches {last[lv]['launches']}")
        warm = clock.frames[2:]
        print(f"timing: KinFu ms a warm frame (median of {len(warm)}): "
              f"{_split_line(stage_split(warm))}; frame wall "
              f"{statistics.median(walls[2:]):.2f} (frame 0 "
              f"{walls[0]:.2f}, frame 1 {walls[1]:.2f}); mesh extraction "
              f"{mesh_ms:.2f}; peak memory {peak_frames - held:.3f} GB "
              f"over the frames, {peak_mesh - held:.3f} GB with the mesh "
              f"(besides {held:.3f} GB that earlier phases hold) on "
              f"{card}")
        marks.append(("checks and mesh", time.perf_counter()))

        # one more frame at KinfuOption's default threshold
        opt.distance_threshold = 0.5
        clock.active = True
        c20, d20 = room_frame(np, ctt, RGBD_FRAMES, intr, dev)
        f20 = ctt.geometry.RGBDImage.create_from_color_and_depth(
            c20, d20, convert_rgb_to_intensity=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = clock.frame(lambda: pipe.process_frame(f20))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        err = float(np.linalg.norm(pipe.cur_pose[:3, 3]
                                   - rgbd_pose(np, RGBD_FRAMES)[:3, 3]))
        branches = kinfu_branches(np, clock)
        icp = {lv: e for s, lv, _, e in clock.frames[-1] if s == "icp"}
        print(f"timing: KinFu frame {RGBD_FRAMES} at the default ICP "
              f"threshold 0.5: tracked {ok}, translation error {err:.3e} "
              f"m; {_split_line(stage_split(clock.frames[-1:]))}; "
              f"frame wall {wall:.2f} ms; ICP branches " + "; ".join(
                  f"{lv} {branches[lv]} ({icp[lv]['iterations']} "
                  f"iterations, launches {icp[lv]['launches']})"
                  for lv in branches))
    marks.append(("threshold 0.5 frame", time.perf_counter()))
    print(kinfu_level_view(np, ctt, pipe, intr, dev))
    del pipe, clock, kin, frames
    marks.append(("level view", time.perf_counter()))
    rgbd_small(np, torch, ctt, intr, dev)
    console.set_verbosity_level(verbosity)
    marks.append(("small check", time.perf_counter()))
    phase_s = time.perf_counter() - t_phase
    parts, last_t = [], t_phase
    for name, t in marks:
        parts.append(f"{name} {t - last_t:.1f}")
        last_t = t
    print(f"phase 4k: {phase_s:.1f} s ({', '.join(parts)})")
    if phase_s > KINFU_PHASE_S:
        raise AssertionError(f"phase 4k took {phase_s:.1f} s")


def small_kinfu_option(ctt):
    """KinFu at 64x48 on a 64^3 volume over 4 m round the room, two
    levels."""
    return ctt.kinfu.KinfuOption(
        num_pyramid_levels=2, tsdf_length=4.0, tsdf_resolution=64,
        sdf_trunc=0.2, tsdf_origin=(0.0, 0.0, 1.5), distance_threshold=0.3,
        icp_iterations=[5, 5])


def rgbd_small(np, torch, ctt, intr, dev="cuda"):
    """Two frames of the room through KinFu at 64x48 (64^3, two levels)
    and hybrid odometry on that pair at the full width of `intr` with
    the default OdometryOption, on the card and on the CPU: KinFu poses
    within 1e-4, tsdf within 1e-5, equal mesh vertex counts; odometry
    poses within 1e-4 (at 64x48 that pose moves by up to 4e-3 when the
    source depth moves by one ulp, at 640x480 by about 1e-6)."""
    small = intr.scale(0.1)
    create = ctt.geometry.RGBDImage.create_from_color_and_depth
    out = {}
    for name in (dev, "cpu"):
        pipe = ctt.kinfu.KinfuPipeline(small, small_kinfu_option(ctt),
                                       device=name)
        for k in (0, 2):
            c, d = room_frame(np, ctt, k, small, name)
            if not pipe.process_frame(create(
                    c, d, convert_rgb_to_intensity=False)):
                raise AssertionError(f"small KinFu lost frame {k} on "
                                     f"{name}")
        mesh = pipe.extract_triangle_mesh()
        gray = [create(*room_frame(np, ctt, k, intr, name)) for k in (0, 2)]
        odo = ctt.odometry.compute_rgbd_odometry(gray[0], gray[1], intr)
        out[name] = (pipe.cur_pose, pipe.volume.tsdf.cpu().numpy(),
                     len(mesh.vertices), odo)
    g, c = out[dev], out["cpu"]
    d_pose = float(np.abs(g[0] - c[0]).max())
    d_tsdf = float(np.abs(g[1] - c[1]).max())
    d_odo = float(np.abs(g[3][1] - c[3][1]).max())
    print(f"small input (KinFu, 2 frames at 64x48, 64^3; odometry on that "
          f"pair at {intr.width}x{intr.height}): cuda vs cpu pose gap "
          f"{d_pose:.3e}, tsdf gap {d_tsdf:.3e}, mesh vertices {g[2]} vs "
          f"{c[2]}; odometry success {g[3][0]} / {c[3][0]}, pose gap "
          f"{d_odo:.3e}")
    if d_pose > 1e-4 or d_tsdf > 1e-5 or g[2] != c[2] \
            or not (g[3][0] and c[3][0]) or d_odo > 1e-4:
        raise AssertionError("the card and the CPU disagree on KinFu or "
                             "odometry")


# the robotics phase (4r): the room of phase 4k mapped into cupoch's
# default OccupancyGrid (0.05 m, 512^3) from 20 depth frames and 50 scans
# of a simulated Hokuyo UTM-30LX (its published spec: 1081 steps over
# 270 deg, 0.25 deg apart, 30 m), its distance field, a roadmap through
# the room's free box and the 6-joint arm above checked against it
ROBOTICS_PHASE_S = 60.0
LASER_STEPS = 1081
LASER_FOV_DEG = 270.0
LASER_RANGE = 30.0
LASER_SCANS = 50             # DEFAULT_NUM_MAX_SCANS
LASER_HEIGHT = 0.4           # m above the floor
LASER_START_XZ = (0.05, 0.3)
LASER_STEP = 0.02            # m along +z between scans
# laser_filters' ScanShadowsFilter settings: min and max angle, window,
# neighbours
LASER_SHADOW = (10.0, 170.0, 1, 20)
ROOM_OPEN_Z = 0.0            # the room's open side: a ray crossing z = 0
# the roadmap's box (room frame, y down: 0.1-0.7 m above the floor) and
# spacing (the grid's voxel), and the path's ends: behind box 1, past box
# 2's far side
LATTICE_BOX = ((-1.4, 0.1, 0.3), (1.5, 0.7, 2.7))
LATTICE_SPACING = 0.05
PLAN_START = (-0.75, 0.4, 2.6)
PLAN_GOAL = (1.2, 0.4, 2.25)
PLAN_REL_TOL = 1e-5
ARM_CONFIGS = 512
# the base and shoulder links stand on the floor: the moving links are
# checked
ARM_MOVING_LINKS = ("upper_arm_link", "forearm_link", "wrist_1_link",
                    "wrist_2_link", "wrist_3_link")
ARM_SWEEP_VOXEL = 0.02
ARM_SWEEP_LINK = "forearm_link"
EDT_SAMPLES = 10_000
EDGE_SAMPLES = 10_000        # roadmap edges held to the float64 oracle
# a touch closer than this to a face is a tie the float32 tests may call
# either way: the oracles below leave it out and count it
TOUCH_TOL = 1e-6


def laser_scan(np, k):
    """(ranges [LASER_STEPS] float32, scanner-to-room pose float32) of
    scan k: the exact ray-plane and ray-box hits in float64, NaN where a
    ray leaves through the open side or passes LASER_RANGE. The scanner
    looks along +z with its z axis up (room -y)."""
    floor_y = dict(ROOM_PLANES)[1]
    o = np.asarray([LASER_START_XZ[0], floor_y - LASER_HEIGHT,
                    LASER_START_XZ[1] + k * LASER_STEP])
    ang = np.radians(-LASER_FOV_DEG / 2 + np.arange(LASER_STEPS)
                     * LASER_FOV_DEG / (LASER_STEPS - 1))
    d = np.stack([-np.sin(ang), np.zeros_like(ang), np.cos(ang)], -1)
    best = np.full(LASER_STEPS, np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis, value in ROOM_PLANES:
            t = (value - o[axis]) / d[:, axis]
            inside = (o[2] + t * d[:, 2]) >= ROOM_OPEN_Z
            best = np.where((t > 0) & (t < best) & inside, t, best)
        for lo, hi in ROOM_BOXES:
            t1 = (np.asarray(lo) - o) / d
            t2 = (np.asarray(hi) - o) / d
            t_in = np.nanmax(np.minimum(t1, t2), -1)
            t_out = np.nanmin(np.maximum(t1, t2), -1)
            hit = (t_out >= t_in) & (t_in > 0) & (t_in < best)
            best = np.where(hit, t_in, best)
    ranges = np.where(best <= LASER_RANGE, best, np.nan).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    T[:3, 3] = o
    return ranges, T


def robotics_frames(np, ctt, intr, frames, dev):
    """(PointCloud in the room frame, camera centre) of frames 0 ..
    frames-1 of phase 4k's trajectory, from the sensor's uint16 depth."""
    for k in range(frames):
        _, depth = room_frame(np, ctt, k, intr, dev)
        P = room_view(np) @ rgbd_pose(np, k)
        yield ctt.geometry.PointCloud.create_from_depth_image(
            depth, intr, np.linalg.inv(P).astype(np.float32),
            depth_scale=RGBD_DEPTH_SCALE), P[:3, 3].astype(np.float32)


def _sync_ms(torch, fn, dev="cuda"):
    """(fn(), its milliseconds), a card `dev` synchronised around it."""
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def laser_buffer(np, ctt, scans, dev):
    """A LaserScanBuffer of the first `scans` scans, with their poses."""
    buf = ctt.geometry.LaserScanBuffer(
        LASER_STEPS, LASER_SCANS, -np.radians(LASER_FOV_DEG / 2),
        np.radians(LASER_FOV_DEG / 2), device=dev)
    for k in range(scans):
        buf.add_ranges(*laser_scan(np, k))
    return buf


def edt_check(np, dt, occ_idx, n, seed=7):
    """Distances and nearest sites of n seeded voxels round the occupied
    ones against a host float64 brute force over the occupied list
    (exact integer squared distances): the number that differ."""
    rng = np.random.default_rng(seed)
    R = dt.resolution
    lo = np.clip(occ_idx.min(0) - 20, 0, R - 1)
    hi = np.clip(occ_idx.max(0) + 20, 0, R - 1)
    s = rng.integers(lo, hi + 1, (n, 3))
    occ = occ_idx.astype(np.float64)
    on = (occ * occ).sum(-1)
    d2 = np.empty(n, np.int64)
    for a in range(0, n, 1000):
        q = s[a:a + 1000].astype(np.float64)
        m = (q * q).sum(-1)[:, None] + on[None] - 2.0 * q @ occ.T
        d2[a:a + 1000] = np.rint(m.min(1)).astype(np.int64)
    st = dt.nearest_index.new_tensor(s).long()
    near = dt.nearest_index[st[:, 0], st[:, 1], st[:, 2]].cpu().numpy()
    dist = dt.distance[st[:, 0], st[:, 1], st[:, 2]].cpu().numpy()
    want = np.sqrt(d2.astype(np.float64)).astype(np.float32) \
        * np.float32(dt.voxel_size)
    return int(((((near - s) ** 2).sum(-1) != d2) | (dist != want)).sum())


def _boxes_f64(np, grid, idx):
    lo = grid.origin.astype(np.float64) + (idx.astype(np.float64)
                                           - grid.resolution // 2) \
        * grid.voxel_size
    return lo, lo + grid.voxel_size


def segment_hits(np, p0, p1, lo, hi, margin):
    """[S] bool: does segment p0-p1 cross a box [lo - m, hi + m] by more
    than TOUCH_TOL (float64 slabs)? The segments go 64 at a time, in
    the order of their midpoints' 0.5 m cells, against the boxes that
    meet their bounds."""
    lo = lo - (margin - TOUCH_TOL)
    hi = hi + (margin - TOUCH_TOL)
    out = np.zeros(len(p0), bool)
    order = np.lexsort(np.floor(p0 + p1).T[::-1])
    for a in range(0, len(order), 64):
        s = order[a:a + 64]
        a0, b0 = p0[s], p1[s]
        near = ((lo <= np.maximum(a0, b0).max(0))
                & (hi >= np.minimum(a0, b0).min(0))).all(-1)
        bl, bh = lo[near][None], hi[near][None]
        o, d = a0[:, None], (b0 - a0)[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (bl - o) / d
            t1 = (bh - o) / d
        par = np.broadcast_to(d == 0, t0.shape)
        inside = (o >= bl) & (o <= bh)
        tmin = np.where(par, np.where(inside, -np.inf, np.inf),
                        np.minimum(t0, t1)).max(-1)
        tmax = np.where(par, np.where(inside, np.inf, -np.inf),
                        np.maximum(t0, t1)).min(-1)
        out[s] = ((tmax >= np.maximum(tmin, 0.0)) & (tmin <= 1.0)).any(-1)
    return out


def edge_cut_check(np, graph, lo, hi, margin, n, seed=11):
    """(sampled edges, of them cut, ambiguous, wrong): n seeded edges of
    `graph` held to segment_hits against the boxes [lo, hi] inflated by
    `margin`. An edge that crosses a box grown by TOUCH_TOL but none
    shrunk by it is a tie either cut state may answer (ambiguous); any
    other edge is wrong when its infinite weight and the oracle
    disagree."""
    rng = np.random.default_rng(seed)
    lines = graph.lines.cpu().numpy()
    pick = rng.choice(len(lines), min(n, len(lines)), replace=False)
    pts = graph.points.cpu().numpy().astype(np.float64)
    p0, p1 = pts[lines[pick, 0]], pts[lines[pick, 1]]
    cut = np.isinf(graph.edge_weights.cpu().numpy()[pick])
    sure = segment_hits(np, p0, p1, lo, hi, margin)
    maybe = segment_hits(np, p0, p1, lo, hi, margin + 2 * TOUCH_TOL)
    amb = maybe & ~sure
    return len(pick), int(cut.sum()), int(amb.sum()), \
        int(((cut != sure) & ~amb).sum())


def posed_primitives(ctt, chain, poses):
    """The arm's collision primitives at the link poses `poses`."""
    import copy

    prims = []
    for name, T in poses.items():
        for s in chain.link_map[name].collisions:
            p = copy.copy(s.primitive)
            p.transform = (T @ s.primitive.transform).astype("float32")
            prims.append(p)
    return prims


def _clearance(np, prim, pts):
    """Signed float64 clearance of points to a primitive (negative
    inside): L-infinity for a box, Euclidean for a sphere, the larger of
    the radial and axial ones for a cylinder."""
    T = prim.transform.astype(np.float64)
    local = (pts - T[:3, 3]) @ T[:3, :3]
    kind = type(prim).__name__
    if kind == "Box":
        return (np.abs(local) - prim.lengths.astype(np.float64) / 2).max(-1)
    if kind == "Sphere":
        return np.linalg.norm(pts - T[:3, 3], axis=-1) - prim.radius
    return np.maximum(np.linalg.norm(local[:, :2], axis=-1) - prim.radius,
                      np.abs(local[:, 2]) - prim.height / 2)


def arm_oracle(np, prims, centres, inflate):
    """(collided, ambiguous) by float64 containment of the voxel centres
    in the primitives inflated by `inflate`, a centre within TOUCH_TOL of
    an inflated surface ambiguous."""
    c = min(float(_clearance(np, p, centres).min()) for p in prims) - inflate
    return c <= -TOUCH_TOL, abs(c) < TOUCH_TOL


def dense_pairs_host(np, lo1, hi1, lo2, hi2):
    """Float32 AABB overlap pairs on the host, the second set first cut
    to the first's bounds (exact: a box outside them meets none)."""
    keep = np.nonzero(((lo2 <= hi1.max(0)) & (hi2 >= lo1.min(0))).all(-1))[0]
    l2, h2 = lo2[keep], hi2[keep]
    out = []
    for a in range(0, len(lo1), 512):
        hit = ((lo1[a:a + 512, None] <= h2[None])
               & (l2[None] <= hi1[a:a + 512, None])).all(-1)
        i, j = np.nonzero(hit)
        out += list(zip((i + a).tolist(), keep[j].tolist()))
    return set(out)


def robotics_phase(np, torch, ctt, reset_counts, counts, path_counts, card):
    """Phase 4r: occupancy mapping from depth frames and laser scans,
    the distance field, a planner's roadmap and an arm's collisions,
    all at cupoch's defaults on the card, then the card against the CPU
    at a 64^3 grid."""
    import io

    dev = "cuda"
    t_phase = time.perf_counter()
    marks = []
    G = ctt.geometry
    intr, _ = kinfu_config(ctt)
    frames = list(robotics_frames(np, ctt, intr, RGBD_FRAMES, dev))
    buf = laser_buffer(np, ctt, LASER_SCANS, dev)
    marks.append(("scene", time.perf_counter()))
    reset_counts()

    # depth mapping
    grid = G.OccupancyGrid(device=dev)
    state_gb = grid.prob_log.numel() * 4 / 1e9
    ins_ms, steps = [], []
    for pcd, centre in frames:
        ins_ms.append(_sync_ms(torch, lambda: grid.insert(pcd, centre))[1])
        steps.append(grid.last_dda_steps)
    n_pts = int(frames[0][0].points.shape[0])
    n_free = int(grid.extract_free_voxels()[0].shape[0])
    n_occ = int(grid.extract_occupied_voxels()[0].shape[0])
    print(f"path: depth mapping, {len(frames)} frames at {intr.width}x"
          f"{intr.height} ({n_pts} points the first) into an OccupancyGrid "
          f"at its defaults ({grid.voxel_size} m, {grid.resolution}^3, "
          f"prob_log {state_gb:.3f} GB): insert ms cold {ins_ms[0]:.2f}, "
          f"warm median {statistics.median(ins_ms[1:]):.2f}; DDA "
          f"steps min / median / max {min(steps)} / "
          f"{statistics.median(steps)} / {max(steps)}; {n_free} free and "
          f"{n_occ} occupied voxels on {card}")
    # one more insert of frame 1 into an empty grid of the same size,
    # profiled (the mapped grid stays as the 20 frames left it)
    spare = G.OccupancyGrid(device=dev)
    pcd1, centre1 = frames[1]
    profile(torch, f"OccupancyGrid.insert, {n_pts} rays, "
            f"{grid.resolution}^3", lambda: spare.insert(pcd1, centre1),
            statistics.median(ins_ms[1:]) / 1e3, warm_up=False)
    del spare
    marks.append(("depth inserts", time.perf_counter()))

    # laser mapping
    shadow, sh_ms = _sync_ms(torch, lambda: buf.scan_shadows_filter(
        *LASER_SHADOW))
    cloud = G.PointCloud.create_from_laserscanbuffer(shadow, 0.0,
                                                     LASER_RANGE)
    n_raw = int(np.isfinite(buf.get_ranges()).sum())
    laser_ms = []
    scans = shadow._copy()
    while not scans.is_empty():
        scan = scans.pop_one_scan()
        pts = G.PointCloud.create_from_laserscanbuffer(scan, 0.0,
                                                       LASER_RANGE)
        vp = scan.get_origins()[0][:3, 3]
        laser_ms.append(_sync_ms(torch, lambda: grid.insert(pts, vp))[1])
    free_n = int(grid.extract_free_voxels()[0].shape[0])
    occ_idx_t = grid.extract_occupied_voxels()[0]
    occ_idx = occ_idx_t.cpu().numpy()
    print(f"path: laser mapping, {buf.get_num_scans()} scans of "
          f"{LASER_STEPS} steps over {LASER_FOV_DEG:.0f} deg, {n_raw} "
          f"returns, {len(cloud.points)} after the shadow filter "
          f"({sh_ms:.2f} ms): insert ms median "
          f"{statistics.median(laser_ms):.2f}; the grid now {free_n} free "
          f"and {len(occ_idx)} occupied voxels")
    marks.append(("laser", time.perf_counter()))

    # distance field
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dt, edt_ms = _sync_ms(
        torch, lambda: G.DistanceTransform.create_from_occupancy_grid(grid))
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    bad = edt_check(np, dt, occ_idx, EDT_SAMPLES)
    print(f"path: distance field at {dt.resolution}^3: {edt_ms:.2f} ms; "
          f"nearest_index {dt.nearest_index.numel() * 4 / 1e9:.3f} GB, "
          f"peak {peak:.3f} GB above the {held / 1e9:.3f} GB held; "
          f"{EDT_SAMPLES} seeded voxels against a host float64 brute "
          f"force: {bad} differ")
    if bad:
        raise AssertionError("the distance field differs from the brute "
                             "force")
    marks.append(("EDT", time.perf_counter()))

    # planning
    res = [int(round((b - a) / LATTICE_SPACING)) + 1
           for a, b in zip(*LATTICE_BOX)]
    graph = G.Graph.create_from_axis_aligned_bounding_box(
        LATTICE_BOX, res, device=dev)
    planner = ctt.planning.Pos3DPlanner(graph)
    planner.add_obstacle(grid)
    _, upd_ms = _sync_ms(torch, planner.update_graph)
    n_cut = int(torch.isinf(planner.graph.edge_weights).sum())
    path, find_ms = _sync_ms(
        torch, lambda: planner.find_path(PLAN_START, PLAN_GOAL))
    import copy

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    ex = copy.deepcopy(planner.graph)
    n0 = int(ex.points.shape[0])
    ex.add_node_and_connect(np.asarray(PLAN_START, np.float32),
                            planner.max_edge_distance, lazy_add=True)
    ex.add_node_and_connect(np.asarray(PLAN_GOAL, np.float32),
                            planner.max_edge_distance)
    planner._remove_collision_edges(ex)
    idx, length = ex.dijkstra_path(n0, n0 + 1)
    lines = ex.lines.cpu().numpy()
    w = ex.edge_weights.cpu().numpy().astype(np.float64)
    fin = np.isfinite(w)
    order = np.lexsort((w[fin], lines[fin][:, 1], lines[fin][:, 0]))
    li, wf = lines[fin][order], w[fin][order]
    first = np.ones(len(li), bool)
    first[1:] = (li[1:] != li[:-1]).any(-1)
    n = n0 + 2
    csg = coo_matrix((wf[first], (li[first][:, 0], li[first][:, 1])),
                     shape=(n, n)).tocsr()
    ref = float(dijkstra(csg, indices=n0)[n0 + 1])
    pts = np.asarray(path, np.float64)
    lo, hi = _boxes_f64(np, grid, occ_idx)
    n_s, n_s_cut, n_s_amb, n_s_bad = edge_cut_check(
        np, planner.graph, lo, hi, planner.object_radius, EDGE_SAMPLES)
    hits = segment_hits(np, pts[:-1], pts[1:], lo, hi,
                        planner.object_radius) if len(pts) > 1 else []
    along = np.concatenate([pts[:-1] + (pts[1:] - pts[:-1]) * f
                            for f in np.linspace(0, 1, 11)]) \
        if len(pts) > 1 else pts
    edt_min = float(dt.get_distances(along.astype(np.float32)).min())
    floor = planner.object_radius - grid.voxel_size * np.sqrt(3.0) / 2
    print(f"path: planning on a {res[0]}x{res[1]}x{res[2]} lattice "
          f"({int(graph.points.shape[0])} nodes, "
          f"{int(graph.lines.shape[0])} directed edges), Pos3DPlanner at "
          f"its defaults (radius {planner.object_radius}, max edge distance "
          f"{planner.max_edge_distance}): collision-edge removal "
          f"{upd_ms:.2f} ms ({n_cut} edges cut; of {n_s} seeded edges "
          f"{n_s_cut} cut, {n_s_bad} differing from the float64 oracle, "
          f"{n_s_amb} "
          f"within {TOUCH_TOL} m of touching), find_path {find_ms:.2f} ms "
          f"({planner.last_sssp_iterations} SSSP relaxations); path of "
          f"{len(path)} points, length {length:.6f} against scipy's "
          f"{ref:.6f}; edges meeting an inflated occupied box "
          f"{int(np.sum(hits))}; least EDT along it {edt_min:.4f} m "
          f"(floor {floor:.4f})")
    if not path or [tuple(p) for p in path] != [
            tuple(p) for p in ex.points[torch.as_tensor(idx)].cpu().numpy()]:
        raise AssertionError("the planner found no path, or another one")
    if n_s_bad or not 0 < n_s_cut < n_s:
        raise AssertionError("collision-edge removal cut other edges than "
                             "the float64 oracle")
    if abs(length - ref) > PLAN_REL_TOL * ref or np.any(hits) \
            or edt_min < floor - TOUCH_TOL:
        raise AssertionError("the path is longer than scipy's or meets an "
                             "obstacle")
    marks.append(("planning", time.perf_counter()))

    # the arm
    chain = ctt.kinematics.KinematicChain(device=dev)
    chain.build_from_urdf(io.StringIO(ARM_URDF))
    base = arm_base(np)
    rng = np.random.default_rng(17)
    qs = rng.uniform(-np.pi, np.pi, (ARM_CONFIGS, 6))
    # the shoulder keeps the upper arm at or above the horizontal
    qs[:, 1] = rng.uniform(-np.pi, 0.0, ARM_CONFIGS)
    centres = grid.voxel_centers(occ_idx_t).cpu().numpy().astype(np.float64)
    inflate = grid.voxel_size * np.sqrt(3.0) / 2.0
    got, posed = [], []
    torch.cuda.synchronize()
    arm_t0 = time.perf_counter()
    for q in qs:
        poses = chain.forward_kinematics(
            {f"joint_{k}": float(v) for k, v in enumerate(q)}, base)
        prims = posed_primitives(ctt, chain, {
            k: poses[k] for k in ARM_MOVING_LINKS})
        got.append(ctt.collision.compute_intersection(prims, grid)
                   .is_collided())
        posed.append(prims)
    torch.cuda.synchronize()
    arm_ms = (time.perf_counter() - arm_t0) * 1e3
    want, ambiguous = [], 0
    for prims in posed:
        w_hit, amb = arm_oracle(np, prims, centres, inflate)
        want.append(w_hit)
        ambiguous += amb
    got, want = np.asarray(got), np.asarray(want)
    print(f"path: arm, {len(qs)} seeded configurations: forward kinematics "
          f"and compute_intersection(the {len(ARM_MOVING_LINKS)} moving "
          f"links' primitives, occupancy grid) "
          f"{arm_ms / len(qs):.3f} ms each; "
          f"{int(got.sum())} collided ({int(want.sum())} by the float64 "
          f"oracle, {ambiguous} within {TOUCH_TOL} m of touching)")
    if np.any(got != want):
        raise AssertionError("the arm's collided set differs from the "
                             "oracle's")
    # the link swept from the first free configuration to the one that
    # sinks it deepest into the occupied voxels
    link = chain.link_map[ARM_SWEEP_LINK].collisions[0].primitive

    def link_pose(i):
        return chain.forward_kinematics(
            {f"joint_{k}": float(v) for k, v in enumerate(qs[i])}, base)[
                ARM_SWEEP_LINK]

    deep = int(np.argmin([_clearance(np, posed_primitives(
        ctt, chain, {ARM_SWEEP_LINK: link_pose(i)})[0], centres).min()
        for i in range(len(qs))]))
    ends = (int(np.argmin(got)), deep)
    pose = [link_pose(i) for i in ends]
    prim = posed_primitives(ctt, chain, {ARM_SWEEP_LINK: pose[0]})[0]
    sweep, sweep_ms = _sync_ms(
        torch, lambda: prim.create_voxel_grid_with_sweeping(
            ARM_SWEEP_VOXEL, (pose[1] @ link.transform).astype(np.float32)))
    occ_vg = G.VoxelGrid.create_from_occupancy_grid(grid)
    res_b, b_ms = _sync_ms(
        torch, lambda: ctt.collision.compute_intersection(sweep, occ_vg))
    lo1 = (sweep.origin + sweep.voxels_keys.cpu().numpy().astype(np.float32)
           * np.float32(sweep.voxel_size)).astype(np.float32)
    lo2 = (occ_vg.origin + occ_vg.voxels_keys.cpu().numpy().astype(
        np.float32) * np.float32(occ_vg.voxel_size)).astype(np.float32)
    oracle = dense_pairs_host(np, lo1, lo1 + np.float32(sweep.voxel_size),
                              lo2, lo2 + np.float32(occ_vg.voxel_size))
    pairs = set(map(tuple, res_b.collision_index_pairs.cpu().numpy()
                    .tolist()))
    per_box = np.bincount([i for i, _ in oracle] or [0])
    if per_box.max() > 32:
        raise AssertionError("a swept voxel meets over 32 occupied ones: "
                             "the bucket phase's per-box cap would bind")
    print(f"path: swept {ARM_SWEEP_LINK} at {ARM_SWEEP_VOXEL} m from "
          f"configuration {ends[0]} to {ends[1]}: {len(sweep)} "
          f"voxels in {sweep_ms:.2f} ms against "
          f"VoxelGrid.create_from_occupancy_grid ({len(occ_vg)} voxels, "
          f"N*M {len(sweep) * len(occ_vg)}): the {res_b.route} route, "
          f"{res_b.n_dropped} dropped, {len(pairs)} pairs in {b_ms:.2f} ms "
          f"against the host dense oracle's {len(oracle)}")
    if res_b.route != "bucket" or res_b.n_dropped or pairs != oracle:
        raise AssertionError("the bucket route's pairs differ from the "
                             "dense oracle's")
    marks.append(("arm", time.perf_counter()))
    path_counts["robotics"] = c = counts()
    print(f"path launches (phase 4r): {c}")
    if any(c.values()):
        raise AssertionError("phase 4r launched a kernel: none of its "
                             "modules calls one")
    del grid, dt, planner, ex, frames, occ_vg
    robotics_small(np, torch, ctt, dev)
    marks.append(("small check", time.perf_counter()))
    phase_s = time.perf_counter() - t_phase
    parts, last_t = [], t_phase
    for name, t in marks:
        parts.append(f"{name} {t - last_t:.1f}")
        last_t = t
    print(f"phase 4r: {phase_s:.1f} s ({', '.join(parts)})")
    if phase_s > ROBOTICS_PHASE_S:
        raise AssertionError(f"phase 4r took {phase_s:.1f} s")


def robotics_small(np, torch, ctt, dev, R=64):
    """Phase 4r's modules at a R^3 grid of 0.1 m on the card and on the
    CPU from the same host inputs: DDA masks, prob_log, EDT distances and
    indices, collision pairs as sets, SSSP dist and prev, FK poses, laser
    points and carve_depth_map keep masks must be identical."""
    import io

    from cupoch_tpu_torch.geometry import occupancygrid, graph as tgraph

    G = ctt.geometry
    intr, _ = kinfu_config(ctt)
    small = intr.scale(0.1)
    frames = [(p.points.cpu().numpy(), c) for p, c in robotics_frames(
        np, ctt, small, 2, "cpu")]
    out = {}
    for name in (dev, "cpu"):
        r = {}
        grid = G.OccupancyGrid(0.1, R, device=name)
        pts0 = torch.as_tensor(frames[0][0], device=name)
        r["dda"] = occupancygrid.dda_free_mask(
            pts0, torch.as_tensor(frames[0][1], device=name), 0.1,
            torch.zeros(3, device=name), R, 3 * R)[0]
        for p, cpos in frames:
            grid.insert(p, cpos)
        buf = laser_buffer(np, ctt, 5, name)
        shadow = buf.scan_shadows_filter(*LASER_SHADOW)
        r["laser"] = G.PointCloud.create_from_laserscanbuffer(
            shadow, 0.0, LASER_RANGE).points
        for k in range(5):
            sc = G.LaserScanBuffer.from_numpy(
                shadow.ranges[k:k + 1].cpu().numpy(),
                shadow.origins[k:k + 1].cpu().numpy(), 0, 1,
                shadow.min_angle_, shadow.max_angle_, device=name)
            grid.insert(G.PointCloud.create_from_laserscanbuffer(
                sc, 0.0, LASER_RANGE), sc.get_origins()[0][:3, 3])
        r["prob_log"] = grid.prob_log
        dt = G.DistanceTransform.create_from_occupancy_grid(grid)
        r["edt"], r["nearest"] = dt.distance, dt.nearest_index
        lat = G.Graph.create_from_axis_aligned_bounding_box(
            LATTICE_BOX, (15, 4, 13), device=name)
        res = ctt.collision.compute_intersection(grid, lat, 0.1)
        r["pairs"] = set(map(tuple, res.collision_index_pairs.cpu().numpy()
                             .tolist()))
        planner = ctt.planning.Pos3DPlanner(lat)
        planner.add_obstacle(grid)
        planner.update_graph()
        g = planner.graph
        d, prev, _ = tgraph.sssp(g.lines[:, 0], g.lines[:, 1],
                                 g.edge_weights, 0, int(g.points.shape[0]),
                                 int(g.points.shape[0]))
        r["dist"], r["prev"] = d, prev
        chain = ctt.kinematics.KinematicChain(device=name)
        chain.build_from_urdf(io.StringIO(ARM_URDF))
        poses = chain.forward_kinematics({"joint_1": 0.0, "joint_2": 1.3},
                                         arm_base(np))
        prims = posed_primitives(ctt, chain, poses)
        r["arm_pairs"] = set(map(tuple, ctt.collision.compute_intersection(
            prims, grid).collision_index_pairs.cpu().numpy().tolist()))
        r["fk"] = np.stack([poses[k] for k in sorted(poses)])
        params = ctt.camera.PinholeCameraParameters()
        params.intrinsic = small
        params.extrinsic = np.linalg.inv(room_view(np)).astype(np.float32)
        _, depth = room_frame(np, ctt, 0, small, name)
        depth = G.Image(depth.data.to(torch.float32) / torch.tensor(
            RGBD_DEPTH_SCALE, device=name))
        vg = G.VoxelGrid.create_dense((-1.6, -0.6, 0.0), 0.1, 3.2, 1.5, 3.0,
                                      device=name)
        r["carve"] = vg.carve_keep_mask(depth, params, False)
        out[name] = r
    g, c = out[dev], out["cpu"]
    same = {}
    for k in g:
        a, b = g[k], c[k]
        if isinstance(a, torch.Tensor):
            a, b = a.cpu(), b.cpu()
            same[k] = a.shape == b.shape and bool(
                ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        elif isinstance(a, set):
            same[k] = a == b
        else:
            same[k] = np.array_equal(a, b)
    sizes = (f"{int(c['dda'].sum())} DDA voxels, {len(c['pairs'])} edge "
             f"pairs, {len(c['arm_pairs'])} arm pairs, "
             f"{int(c['carve'].sum())} of {c['carve'].numel()} kept")
    print(f"small input (robotics at {R}^3, frames at {small.width}x"
          f"{small.height}, 5 scans): cuda vs cpu identical: "
          + ", ".join(f"{k} {v}" for k, v in same.items()) + f" ({sizes})")
    if not all(same.values()):
        raise AssertionError("the card and the CPU differ on the robotics "
                             "modules")


# the reconstruct-and-save phase (4s): the room of phase 4k fused into a
# scalable TSDF volume at the settings of Open3D's RGB-D integration
# tutorial (which cupoch's API mirrors: voxel 4/512 m, sdf_trunc 0.04,
# RGB8, depth truncated at 4 m), the mesh cleaned, smoothed, sampled and
# tested for self-intersections, a rectified stereo pair of the room at
# a RealSense D435's 0.05 m baseline through SGM at libSGM's defaults,
# every file format written and read back, and the ATE benchmark run on
# the frames written to disk
RECON_PHASE_S = 60.0
RECON_VOXEL = 4.0 / 512
RECON_TRUNC = 0.04
RECON_DEPTH_TRUNC = 4.0
RECON_TAUBIN = 10
RECON_SAMPLES = 1_000_000
STEREO_BASELINE = 0.05
STEREO_SHARE_MIN = 0.90
VOXEL_IO = 0.01
ATE_POSE_TOL = 1e-6
SGM_DISP_SIZE = 128
INTERSECT_SAMPLE = 2000


def recon_rgbd(np, ctt, k, intr, dev):
    """Frame k for the volume: the sensor's uint8 colour as it is and
    its depth in metres, truncated at RECON_DEPTH_TRUNC."""
    c, d = room_frame(np, ctt, k, intr, dev)
    depth = ctt.geometry.RGBDImage.create_from_color_and_depth(
        c, d, RGBD_DEPTH_SCALE, RECON_DEPTH_TRUNC, False).depth
    return ctt.geometry.RGBDImage(c, depth)


def room_share(np, pts, tol):
    """Share of points [N, 3] (first camera frame) within `tol` (a
    number or [N]) of the room's surfaces."""
    return float((room_distance(np, pts) <= tol).mean())


def stereo_pair(np, intr):
    """Rectified grey pair (uint8, ITU-R 601 weights of room_texture's
    RGB) of the first camera and one STEREO_BASELINE to its right, with
    the left view's RGB and z-depth."""
    right = np.eye(4)
    right[0, 3] = STEREO_BASELINE
    rgb_l, z_l = room_depth(np, np.eye(4), intr)
    rgb_r, _ = room_depth(np, right, intr)

    def grey(rgb):
        return np.round(rgb.astype(np.float64) @ [0.299, 0.587, 0.114]) \
            .astype(np.uint8)

    return grey(rgb_l), grey(rgb_r), rgb_l, z_l


def stereo_checks(np, disp, z_true, fx):
    """(share of pixels with a disparity, share of those within 1 px of
    fx b / z)."""
    d = disp.astype(np.float64)
    truth = np.where(z_true > 0, fx * STEREO_BASELINE
                     / np.maximum(z_true, 1e-9), 0.0)
    valid = (d > 0) & (z_true > 0)
    return float(valid.mean()), float((np.abs(d - truth)[valid] <= 1.0)
                                      .mean())


def sgm_stages(torch, ctt, left, right, opt):
    """ms of SGM's stages on the card: census (both images), cost
    volume, path aggregation, winner-takes-all; and the disparity."""
    import importlib

    sgm = importlib.import_module("cupoch_tpu_torch.imageproc.sgm")
    lt = torch.as_tensor(left, dtype=torch.float32, device="cuda")
    rt = torch.as_tensor(right, dtype=torch.float32, device="cuda")
    (cl, cr), ms_census = _sync_ms(torch, lambda: (
        sgm._census97(lt), sgm._census97(rt)))
    cost, ms_cost = _sync_ms(torch, lambda: sgm._cost_volume(
        cl, cr, opt.disp_size, opt.min_disp))
    S, ms_agg = _sync_ms(torch, lambda: sgm._aggregate(
        cost, opt.p1, opt.p2, 8))
    disp, ms_wta = _sync_ms(torch, lambda: sgm._select_disparity(
        S, opt.uniqueness, opt.min_disp, opt.lr_max_diff))
    return {"census": ms_census, "cost": ms_cost, "aggregation": ms_agg,
            "wta": ms_wta}, disp


def _quantized(np, colors):
    """Colours as the files store them (uint8) and read them back."""
    c = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
    return (c.astype(np.float32) / 255.0).astype(np.float32)


def _same(np, a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool((a == b).all())


def _cloud_equal(np, got, want, colors=True):
    """The read cloud against the written one: points and normals bit
    for bit, colours as uint8 stores them."""
    ok = _same(np, got.points.cpu().numpy(), want.points.cpu().numpy())
    if want.has_normals():
        ok &= _same(np, got.normals.cpu().numpy(),
                    want.normals.cpu().numpy())
    if colors and want.has_colors():
        ok &= _same(np, got.colors.cpu().numpy(),
                    _quantized(np, want.colors.cpu().numpy()))
    return ok


def _io_round(torch, path, write, read):
    """(what `read` gives, write ms, read ms, file MB)."""
    _, w_ms = _sync_ms(torch, write)
    got, r_ms = _sync_ms(torch, read)
    return got, w_ms, r_ms, os.path.getsize(path) / 1e6


def textured_copy(np, ctt, mesh, side=256):
    """The mesh with UVs from its vertices' x and z over its box and a
    side x side texture of room_texture over that box's floor plan."""
    v = mesh.vertices.cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    uv_v = np.stack([(v[:, 0] - lo[0]) / (hi[0] - lo[0]),
                     (v[:, 2] - lo[2]) / (hi[2] - lo[2])], -1)
    out = ctt.geometry.TriangleMesh(mesh.vertices, mesh.triangles,
                                    device=mesh.device)
    out.triangle_uvs = uv_v[mesh.triangles.cpu().numpy().reshape(-1)] \
        .astype(np.float32)
    g = (np.arange(side) + 0.5) / side
    gx, gz = np.meshgrid(lo[0] + g * (hi[0] - lo[0]),
                         lo[2] + (1.0 - g) * (hi[2] - lo[2]))
    plan = np.stack([gx, np.zeros_like(gx), gz], -1)
    out.texture = ctt.geometry.Image(room_texture(np, plan),
                                     device=mesh.device)
    return out


def io_checks(np, torch, ctt, root, mesh, cloud, samples):
    """Every format written and read back on the card: (lines, all
    equal).
    Binary files are held bit for bit (colours as uint8 stores them),
    ASCII ones at their printed precision; the cloud's PCD payload is
    decoded by the C codec and the plain decoder."""
    import struct

    io = ctt.io
    lines, ok = [], True

    def record(name, path, got_ok, w_ms, r_ms, mb):
        nonlocal ok
        ok &= bool(got_ok)
        lines.append(f"{name} {mb:.1f} MB, write {mb / w_ms * 1e3:.0f} "
                     f"MB/s, read {mb / r_ms * 1e3:.0f} MB/s, equal "
                     f"{bool(got_ok)}")

    v = mesh.vertices.cpu().numpy()
    t = mesh.triangles.cpu().numpy()
    for ext in ("ply", "stl"):
        path = os.path.join(root, f"mesh.{ext}")
        got, w, r, mb = _io_round(
            torch, path, lambda: io.write_triangle_mesh(path, mesh),
            lambda: io.read_triangle_mesh(path, device="cuda"))
        gv, gt = got.vertices.cpu().numpy(), got.triangles.cpu().numpy()
        if ext == "ply":
            same = _same(np, gv, v) and _same(np, gt, t) and _same(
                np, got.vertex_normals.cpu().numpy(),
                mesh.vertex_normals.cpu().numpy()) and _same(
                np, got.vertex_colors.cpu().numpy(),
                _quantized(np, mesh.vertex_colors.cpu().numpy()))
        else:    # STL keeps the corners; equal ones become one vertex
            same = _same(np, gv[gt], v[t])
        record(f"mesh {ext.upper()}", path, same, w, r, mb)
    tex = textured_copy(np, ctt, mesh)
    path = os.path.join(root, "mesh.obj")
    got, w, r, mb = _io_round(
        torch, path, lambda: io.write_triangle_mesh(path, tex),
        lambda: io.read_triangle_mesh(path, device="cuda"))
    uv = tex.triangle_uvs.cpu().numpy()
    same = (_same(np, got.triangles.cpu().numpy(), t)
            and np.allclose(got.vertices.cpu().numpy(), v, rtol=1e-7,
                            atol=1e-7)
            and np.allclose(got.triangle_uvs.cpu().numpy(), uv, rtol=1e-7,
                            atol=1e-7)
            and _same(np, got.texture.to_numpy(), tex.texture.to_numpy()))
    record("mesh OBJ (8 digits) + texture PNG", path, same, w, r, mb)

    for name, pcd in (("cloud", cloud), ("samples", samples)):
        for ext, kw in (("pcd", {"compressed": True}), ("pcd", {}),
                        ("ply", {})):
            tag = "binary_compressed" if kw else "binary"
            path = os.path.join(root, f"{name}_{tag}.{ext}")
            got, w, r, mb = _io_round(
                torch, path,
                lambda: io.write_point_cloud(path, pcd, **kw),
                lambda: io.read_point_cloud(path, device="cuda"))
            record(f"{name} {ext.upper()} {tag}", path,
                   _cloud_equal(np, got, pcd), w, r, mb)
    # the cloud's compressed payload, decoded both ways
    path = os.path.join(root, "cloud_binary_compressed.pcd")
    with open(path, "rb") as f:
        blob = f.read()
    head = blob.index(b"DATA binary_compressed\n") + 23
    comp, raw = struct.unpack("<II", blob[head:head + 8])
    payload = blob[head + 8:head + 8 + comp]
    lzf = ctt.utility.lzf
    c_out, c_ms = _sync_ms(torch, lambda: lzf.decompress(payload, raw),
                           "cpu")
    p_out, p_ms = _sync_ms(
        torch, lambda: lzf.decompress_plain(payload, raw), "cpu")
    lzf_ok = comp < raw and c_out == p_out and len(c_out) == raw
    ok &= lzf_ok
    lines.append(f"LZF on the cloud's PCD ({raw / 1e6:.1f} MB to "
                 f"{comp / 1e6:.1f} MB): C decoder {c_ms:.1f} ms, plain "
                 f"decoder {p_ms:.1f} ms, equal {lzf_ok}")

    vg = ctt.geometry.VoxelGrid.create_from_point_cloud(cloud, VOXEL_IO)
    path = os.path.join(root, "voxels.ply")
    got, w, r, mb = _io_round(
        torch, path, lambda: io.write_voxel_grid(path, vg),
        lambda: io.read_voxel_grid(path, device="cuda"))
    same = (_same(np, got.voxels_keys.cpu().numpy(),
                  vg.voxels_keys.cpu().numpy())
            and _same(np, got.voxels_colors.cpu().numpy(),
                      _quantized(np, vg.voxels_colors.cpu().numpy()))
            and got.voxel_size == vg.voxel_size
            and _same(np, got.origin, vg.origin))
    record(f"VoxelGrid PLY ({len(vg)} voxels of {VOXEL_IO} m)", path, same,
           w, r, mb)
    return lines, ok


def intersection_check(np, torch, ctt, mesh, pairs):
    """`get_self_intersecting_triangles`'s pairs held to a host oracle:
    the boxes of INTERSECT_SAMPLE seeded triangles against every box by
    the dense test on the CPU, then the triangle test there on each
    candidate (i < j) sharing no vertex. Returns (pairs of the sampled
    triangles the oracle has and `pairs` lacks, the reverse)."""
    import importlib

    col = importlib.import_module("cupoch_tpu_torch.collision.collision")
    tri_tri = ctt.geometry.intersection_test.tri_tri
    t = mesh.triangles.cpu().long()
    tv = mesh.vertices.cpu()[t]                          # [F, 3, 3]
    F = t.shape[0]
    rows = torch.from_numpy(np.sort(np.random.default_rng(13).choice(
        F, min(INTERSECT_SAMPLE, F), replace=False)))
    lo, hi = tv.amin(1), tv.amax(1)
    cand = col.aabb_overlap_pairs(lo[rows], hi[rows], lo, hi, 0.0).long()
    i, j = rows[cand[:, 0]], cand[:, 1]
    i, j = torch.minimum(i, j), torch.maximum(i, j)
    keep = (i != j) & ~(t[i][:, :, None] == t[j][:, None, :]).any(2).any(1)
    i, j = i[keep], j[keep]
    a, b = tv[i], tv[j]
    hit = tri_tri(a[:, 0], a[:, 1], a[:, 2], b[:, 0], b[:, 1], b[:, 2])
    want = set(zip(i[hit].tolist(), j[hit].tolist()))
    sampled = set(rows.tolist())
    got = {(p, q) for p, q in pairs.cpu().tolist()
           if p in sampled or q in sampled}
    return len(want - got), len(got - want)


def pair_kinds(torch, mesh, pairs):
    """(pairs whose triangles are coplanar by tri_tri's rule, |d| <=
    1e-10, pairs holding a triangle of zero area), in float64."""
    t = mesh.triangles.cpu().long()
    tv = mesh.vertices.cpu().double()[t]
    pl = pairs.cpu().long()
    p1, p2 = tv[pl[:, 0]], tv[pl[:, 1]]

    def normal(p):
        return torch.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], dim=-1)

    dist = ((p1 - p2[:, None, 0]) * normal(p2)[:, None]).sum(-1)
    flat = (normal(p1).abs().amax(1) == 0) | (normal(p2).abs().amax(1) == 0)
    return int((dist.abs() <= 1e-10).all(1).sum()), int(flat.sum())


def mesh_ops(np, torch, ctt, mesh, dev, samples):
    """The mesh operations of phase 4s on `mesh` (in place where the
    method works in place), each timed: ({name: ms}, the smoothed mesh
    with normals, the samples, the self-intersecting pairs)."""
    ms = {}
    for name in ("remove_duplicated_vertices", "remove_duplicated_triangles",
                 "remove_unreferenced_vertices"):
        _, ms[name] = _sync_ms(torch, getattr(mesh, name), dev)
    smooth, ms["filter_smooth_taubin"] = _sync_ms(
        torch, lambda: mesh.filter_smooth_taubin(RECON_TAUBIN), dev)
    _, ms["compute_vertex_normals"] = _sync_ms(
        torch, smooth.compute_vertex_normals, dev)
    pts, ms["sample_points_uniformly"] = _sync_ms(
        torch, lambda: smooth.sample_points_uniformly(samples), dev)
    pairs, ms["get_self_intersecting_triangles"] = _sync_ms(
        torch, smooth.get_self_intersecting_triangles, dev)
    return ms, smooth, pts, pairs


def reconstruct_phase(np, torch, ctt, reset_counts, counts, path_counts,
                      card):
    """Phase 4s: the scalable volume over the room's frames, its cloud
    and mesh, the mesh operations, SGM on a rendered stereo pair, every
    file format written and read back, the ATE benchmark from files on
    disk; then the card against the CPU on small inputs. No kernel
    launches. Returns the volume's mesh after its cleanups."""
    import tempfile

    t_phase = time.perf_counter()
    marks = []
    G = ctt.geometry
    dev = "cuda"
    intr = ctt.camera.PinholeCameraIntrinsic(
        ctt.camera.PinholeCameraIntrinsicParameters.PrimeSenseDefault)
    n_frames, disp_size = RGBD_FRAMES, SGM_DISP_SIZE
    fx, _ = intr.get_focal_length()
    frames = [recon_rgbd(np, ctt, k, intr, dev) for k in range(n_frames)]
    left, right, rgb_l, z_l = stereo_pair(np, intr)
    marks.append(("scene", time.perf_counter()))
    reset_counts()

    # the scalable volume
    vol = ctt.integration.ScalableTSDFVolume(
        RECON_VOXEL, RECON_TRUNC, ctt.integration.TSDFVolumeColorType.RGB8,
        device=dev)
    frame_ms = []
    for k, frame in enumerate(frames):
        ext = np.linalg.inv(rgbd_pose(np, k)).astype(np.float32)
        frame_ms.append(_sync_ms(torch, lambda: vol.integrate(
            frame, intr, ext))[1])
    state_gb = vol.capacity * 16 ** 3 * (4 + 4 + 12) / 1e9
    cloud, cloud_ms = _sync_ms(torch, vol.extract_point_cloud, dev)
    mesh, mesh_ms = _sync_ms(torch, vol.extract_triangle_mesh, dev)
    cpts, mv = cloud.points.cpu().numpy(), mesh.vertices.cpu().numpy()
    share_c = room_share(np, cpts, MESH_TOL)
    share_m = room_share(np, mv, MESH_TOL)
    print(f"path: ScalableTSDFVolume (voxel {RECON_VOXEL} m, sdf_trunc "
          f"{RECON_TRUNC}, RGB8, depth stride {vol.depth_sampling_stride}), "
          f"{n_frames} frames at {intr.width}x{intr.height}: "
          f"{len(vol)} blocks, capacity {vol.capacity} ({state_gb:.3f} GB "
          f"of tsdf, weight and colour); cloud {len(cloud)} points, mesh "
          f"{len(mv)} vertices and {mesh.triangles.shape[0]} triangles; "
          f"within {MESH_TOL} m of the room: cloud {share_c:.4f}, mesh "
          f"vertices {share_m:.4f} (limit {MESH_SHARE_MIN})")
    print(f"timing: scalable volume ms a frame: cold {frame_ms[0]:.2f}, "
          f"warm median {statistics.median(frame_ms[2:]):.2f} (min "
          f"{min(frame_ms[2:]):.2f}, max {max(frame_ms[2:]):.2f}); "
          f"extract_point_cloud {cloud_ms:.2f}; extract_triangle_mesh "
          f"{mesh_ms:.2f} on {card}")
    if min(share_c, share_m) < MESH_SHARE_MIN:
        raise AssertionError("the scalable volume's cloud or mesh is off "
                             "the room")
    profile(torch, f"extract_triangle_mesh, {mesh.triangles.shape[0]} "
            "triangles", vol.extract_triangle_mesh, mesh_ms / 1e3,
            warm_up=False)
    marks.append(("volume", time.perf_counter()))

    # the mesh operations
    n_before = (len(mv), int(mesh.triangles.shape[0]))
    ms, smooth, samples, pairs = mesh_ops(np, torch, ctt, mesh, dev,
                                          RECON_SAMPLES)
    share_s = room_share(np, samples.points.cpu().numpy(), MESH_TOL)
    print(f"path: mesh operations on the volume's mesh ({n_before[0]} "
          f"vertices, {n_before[1]} triangles -> {len(mesh.vertices)}, "
          f"{mesh.triangles.shape[0]} after the cleanups): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f"; self-intersection route {smooth.last_intersection_route}, "
          f"{len(pairs)} pairs; {len(samples)} samples within {MESH_TOL} m "
          f"of the room: {share_s:.4f} (limit {MESH_SHARE_MIN}) on {card}")
    if share_s < MESH_SHARE_MIN:
        raise AssertionError("the mesh's samples are off the room")
    if smooth.triangles.shape[0] ** 2 > 16_000_000 \
            and smooth.last_intersection_route != "bucket":
        raise AssertionError("the self-intersection test did not take the "
                             "bucket route")
    missing, extra = intersection_check(np, torch, ctt, smooth, pairs)
    raw = mesh.get_self_intersecting_triangles()
    kinds = {"smoothed": (pairs, pair_kinds(torch, smooth, pairs)),
             "before smoothing": (raw, pair_kinds(torch, mesh, raw))}
    print(f"path: self-intersections on the {smooth.last_intersection_route}"
          f" route ({smooth.last_intersection_dropped} boxes dropped and "
          f"retested densely): " + "; ".join(
              f"{k} {len(p)} pairs, {c} coplanar (tri_tri's box branch), "
              f"{z} with a zero-area triangle"
              for k, (p, (c, z)) in kinds.items())
          + f"; host dense oracle on {INTERSECT_SAMPLE} seeded triangles "
          f"of the smoothed mesh: {missing} pairs missing, {extra} extra")
    if missing or extra:
        raise AssertionError("the self-intersecting pairs differ from the "
                             "host oracle's on the sampled triangles")
    marks.append(("mesh ops", time.perf_counter()))

    # stereo
    opt = ctt.imageproc.SGMOption(intr.width, intr.height,
                                  disp_size=disp_size)
    sgm = ctt.imageproc.SemiGlobalMatching(opt)
    li, ri = G.Image(left, device=dev), G.Image(right, device=dev)
    disp, cold_ms = _sync_ms(torch, lambda: sgm.process_frame(li, ri), dev)
    _, warm_ms = _sync_ms(torch, lambda: sgm.process_frame(li, ri), dev)
    profile(torch, f"SGM process_frame {intr.width}x{intr.height}, "
            f"disp_size {disp_size}", lambda: sgm.process_frame(li, ri),
            warm_ms / 1e3, warm_up=False)
    stages, disp2 = sgm_stages(torch, ctt, left, right, opt)
    d = disp.to_numpy()[..., 0]
    if not _same(np, disp2.cpu().numpy(), d):
        raise AssertionError("SGM's stages disagree with process_frame")
    valid, within = stereo_checks(np, d, z_l, fx)
    color_l = G.Image(rgb_l, device=dev)
    scloud, cl_ms = _sync_ms(torch, lambda: G.PointCloud
                             .create_from_disparity(disp, color_l, intr,
                                                    intr, STEREO_BASELINE),
                             dev)
    sp = scloud.points.cpu().numpy()
    share_z = room_share(np, sp, sp[:, 2] ** 2 / (fx * STEREO_BASELINE))
    truth_max = float(fx * STEREO_BASELINE / z_l[z_l > 0].min())
    print(f"path: SGM {intr.width}x{intr.height}, disp_size {disp_size}, "
          f"8 paths, P1 {opt.p1}, P2 {opt.p2}, uniqueness "
          f"{opt.uniqueness}, baseline {STEREO_BASELINE} m (largest true "
          f"disparity {truth_max:.1f} px): {valid:.4f} of the pixels "
          f"valid, {within:.4f} of those within 1 px (limit "
          f"{STEREO_SHARE_MIN}); stereo cloud {len(sp)} points, "
          f"{share_z:.4f} within one pixel's depth error z^2/(fx b) of "
          f"the room (limit {STEREO_SHARE_MIN})")
    print(f"timing: SGM process_frame cold {cold_ms:.2f} ms, warm "
          f"{warm_ms:.2f} ms; stages " + ", ".join(
              f"{k} {v:.2f}" for k, v in stages.items())
          + f" ms; create_from_disparity {cl_ms:.2f} ms on {card}")
    if within < STEREO_SHARE_MIN or share_z < STEREO_SHARE_MIN:
        raise AssertionError("SGM's disparities or cloud miss their limit")
    marks.append(("stereo", time.perf_counter()))

    # files
    with tempfile.TemporaryDirectory() as root:
        lines, io_ok = io_checks(np, torch, ctt, root, smooth, cloud,
                                 samples)
        print("path: IO, each format written and read back on the card: "
              + "; ".join(lines))
        if not io_ok:
            raise AssertionError("a file did not read back as written")
        marks.append(("io", time.perf_counter()))

        # ATE from files on disk
        seq = os.path.join(root, "sequence")
        write_rgbd_sequence(np, ctt, seq, intr, n_frames)
        from cupoch_tpu_torch.bench import ate as bench

        (ate, n, poses), ate_ms = _sync_ms(
            torch, lambda: bench.run_sequence(seq, device=dev), dev)
    create = G.RGBDImage.create_from_color_and_depth
    mem = [create(*room_frame(np, ctt, k, intr, dev))
           for k in range(n_frames)]
    want, mem_ms = _sync_ms(torch, lambda: bench.odometry_trajectory(
        mem, intr), dev)
    gap = float(np.abs(np.stack(poses) - np.stack(want)).max())
    print(f"path: ATE benchmark from disk ({n} frames at {intr.width}x"
          f"{intr.height}, PNG): ATE {ate:.6e} m; poses against the same "
          f"frames in memory: max gap {gap:.3e} (limit {ATE_POSE_TOL}); "
          f"run_sequence {ate_ms:.1f} ms, in-memory odometry {mem_ms:.1f} "
          f"ms")
    if n != n_frames or gap > ATE_POSE_TOL:
        raise AssertionError("the ATE benchmark's poses from disk differ "
                             "from those in memory")
    marks.append(("ATE", time.perf_counter()))
    path_counts["reconstruct"] = c = counts()
    print(f"path launches (phase 4s): {c}")
    if any(c.values()):
        raise AssertionError("phase 4s launched a kernel: none of its "
                             "modules calls one")
    del vol, frames, smooth, samples, cloud, mem
    recon_small(np, torch, ctt, dev)
    marks.append(("small check", time.perf_counter()))
    phase_s = time.perf_counter() - t_phase
    parts, last_t = [], t_phase
    for name, t in marks:
        parts.append(f"{name} {t - last_t:.1f}")
        last_t = t
    print(f"phase 4s: {phase_s:.1f} s ({', '.join(parts)})")
    if phase_s > RECON_PHASE_S:
        raise AssertionError(f"phase 4s took {phase_s:.1f} s")
    return mesh


def recon_small(np, torch, ctt, dev):
    """Phase 4s's modules on small inputs on the card and on the CPU from
    the same host inputs: the scalable volume on two 64x48 frames at
    0.05 m (slots equal, tsdf and weight within 1e-5, meshes equal once
    sorted), SGM at 160x120 with disp_size 64 (bit-equal), the card's
    argmin on ties (the first index), the mesh operations on that mesh
    (within 1e-5, the samples' draws alike), and files written from card
    tensors byte-equal to those from CPU tensors."""
    import tempfile

    G = ctt.geometry
    intr = ctt.camera.PinholeCameraIntrinsic(
        ctt.camera.PinholeCameraIntrinsicParameters.PrimeSenseDefault)
    small = intr.scale(0.1)
    sgm_intr = intr.scale(0.25)
    left, right, _, _ = stereo_pair(np, sgm_intr)
    out = {}
    for name in (dev, "cpu"):
        vol = ctt.integration.ScalableTSDFVolume(0.05, 0.15, device=name)
        for k in (0, 2):
            vol.integrate(recon_rgbd(np, ctt, k, small, name), small,
                          np.linalg.inv(rgbd_pose(np, k)).astype(np.float32))
        mesh = vol.extract_triangle_mesh()
        _, smooth, samples, pairs = mesh_ops(np, torch, ctt, mesh, name,
                                             1000)
        opt = ctt.imageproc.SGMOption(sgm_intr.width, sgm_intr.height,
                                      disp_size=64)
        disp = ctt.imageproc.SemiGlobalMatching(opt).process_frame(
            G.Image(left, device=name), G.Image(right, device=name))
        out[name] = dict(
            slots=dict(vol._slots), tsdf=vol.tsdf.cpu().numpy(),
            weight=vol.weight.cpu().numpy(),
            mesh=np.sort(mesh.vertices.cpu().numpy(), 0),
            smooth=smooth.vertices.cpu().numpy(),
            normals=smooth.vertex_normals.cpu().numpy(),
            samples=samples.points.cpu().numpy(),
            pairs=pairs.cpu().numpy(), disp=disp.to_numpy(),
            objects=(smooth, vol.extract_point_cloud()))
    g, c = out[dev], out["cpu"]
    gaps = {k: float(np.abs(g[k] - c[k]).max()) if g[k].size else 0.0
            for k in ("tsdf", "weight", "smooth", "normals", "samples")}
    # winner-takes-all's ties: the first least index, as numpy's argmin
    ties = np.random.default_rng(12).integers(0, 3, (4096, 128)) \
        .astype(np.int32)
    same = {"slots": g["slots"] == c["slots"],
            "mesh": _same(np, g["mesh"], c["mesh"]),
            "pairs": _same(np, g["pairs"], c["pairs"]),
            "sgm": _same(np, g["disp"], c["disp"]),
            "argmin ties": _same(np, torch.argmin(torch.as_tensor(
                ties, device=dev), -1).cpu().numpy(), ties.argmin(-1))}
    files = {}
    with tempfile.TemporaryDirectory() as root:
        (mesh_g, cloud_g) = g["objects"]
        for name, write, obj in (
                ("mesh.ply", ctt.io.write_triangle_mesh, mesh_g),
                ("mesh.stl", ctt.io.write_triangle_mesh, mesh_g),
                ("cloud.pcd", lambda p, o: ctt.io.write_point_cloud(
                    p, o, compressed=True), cloud_g)):
            blobs = []
            for where in (dev, "cpu"):
                o = _on(ctt, obj, where)
                p = os.path.join(root, f"{where}_{name}")
                write(p, o)
                with open(p, "rb") as f:
                    blobs.append(f.read())
            files[name] = blobs[0] == blobs[1]
    print(f"small input (scalable volume on two frames at {small.width}x"
          f"{small.height}, 0.05 m; SGM at {sgm_intr.width}x"
          f"{sgm_intr.height}, disp_size 64; mesh operations; files): cuda "
          f"vs cpu: " + ", ".join(f"{k} {v}" for k, v in same.items())
          + ", gaps " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + ", files byte-equal " + ", ".join(f"{k} {v}" for k, v in
                                              files.items()))
    if not (all(same.values()) and all(files.values())
            and max(gaps.values()) <= 1e-5):
        raise AssertionError("the card and the CPU differ on phase 4s's "
                             "modules")


# ---------------------------------------------------------------------------
# the visualization and harness phase (4v): colour maps on 1M values, a
# view fitted to phase 4s's mesh and the headline cloud, a view
# trajectory, the HTML export of both from card tensors, and the
# benchmark harness at its own size and through its CLI
VIS_PHASE_S = 60.0
VIS_VALUES = 1_000_000
VIS_MAP_TOL = 1e-6           # card against the CPU, each colour map
VIEW_TOL = 1e-9              # pinhole round trip, key views of the spline
HARNESS_REPS = 3
HARNESS_CLI_POINTS = 50_000


def view_checks(np, ctt, geoms, host_pts, root):
    """ViewControl fitted to `geoms` (on the card) held to the host
    bounds of `host_pts`, its pinhole round trip, a 4-key-view
    trajectory interpolated into its frames (each key view a frame), and
    the trajectory and a RenderOption through JSON files: (frames, ms of
    the fit, ms of the interpolation)."""
    vis = ctt.visualization
    vc = vis.ViewControl()
    t0 = time.perf_counter()
    vc.fit_in_geometry(*geoms)
    fit_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(vc.bounding_box_min, host_pts.min(0))
            and np.array_equal(vc.bounding_box_max, host_pts.max(0))):
        raise AssertionError("the fitted view's box differs from the host "
                             "min / max")
    vc.change_window_size(640, 480)
    traj = vis.ViewTrajectory()
    gap = 0.0
    for step in range(4):
        vc.rotate(150.0, -40.0 + 30.0 * step)
        vc.scale(-2.0)
        p = vc.convert_to_pinhole_camera_parameters()
        back = vis.ViewControl()
        back.bounding_box_min = vc.bounding_box_min
        back.bounding_box_max = vc.bounding_box_max
        back.change_window_size(640, 480)
        if not back.convert_from_pinhole_camera_parameters(p):
            raise AssertionError("the pinhole parameters did not convert "
                                 "back")
        gap = max(gap, float(np.abs(
            back.convert_to_pinhole_camera_parameters().extrinsic
            - p.extrinsic).max()))
        traj.view_status.append(vc.convert_to_view_parameters())
    t0 = time.perf_counter()
    frames = [traj.get_interpolated_frame(k)[1].convert_to_vector17()
              for k in range(traj.num_of_frames())]
    interp_ms = (time.perf_counter() - t0) * 1e3
    knot = max(float(np.abs(frames[k * (traj.interval + 1)]
                            - s.convert_to_vector17()).max())
               for k, s in enumerate(traj.view_status))
    path = os.path.join(root, "trajectory.json")
    vis.write_view_trajectory(path, traj)
    opt = vis.RenderOption()
    opt.point_size, opt.background_color = 2.0, np.float32([0.1, 0.1, 0.1])
    ropt = os.path.join(root, "render_option.json")
    ctt.io.write_ijson_convertible_to_json(ropt, opt)
    same_json = (vis.read_view_trajectory(path).to_json_dict()
                 == traj.to_json_dict()
                 and ctt.io.read_ijson_convertible_from_json(
                     ropt, vis.RenderOption).to_dict() == opt.to_dict())
    print(f"path: ViewControl fitted on the card to the mesh and the cloud "
          f"in {fit_ms:.2f} ms (box {np.round(vc.bounding_box_min, 4)} .. "
          f"{np.round(vc.bounding_box_max, 4)}, equal to the host min / "
          f"max); pinhole round trip max gap {gap:.3e}; {len(frames)} "
          f"frames of a 4-view trajectory in {interp_ms:.2f} ms, key views "
          f"within {knot:.3e}; trajectory and RenderOption JSON round "
          f"trips equal: {same_json}")
    if gap > VIEW_TOL or knot > VIEW_TOL or not same_json:
        raise AssertionError("a view, the trajectory or a JSON round trip "
                             "missed its limit")
    return frames, fit_ms, interp_ms


def html_checks(np, torch, ctt, mesh, cloud, root):
    """The HTML export of `mesh` and `cloud` from card tensors, its
    decoded arrays held to the geometries' CPU copies, and the same
    export from CPU copies byte-equal: (ms, MB)."""
    import base64
    import re

    vis = ctt.visualization
    card_path = os.path.join(root, "scene_card.html")
    cpu_path = os.path.join(root, "scene_cpu.html")
    _, ms = _sync_ms(torch, lambda: vis.export_html_viewer(
        [mesh, cloud], card_path), mesh.vertices.device)
    mesh_c, cloud_c = ctt.geometry.TriangleMesh(
        mesh.vertices.cpu(), mesh.triangles.cpu(), device="cpu"), \
        cloud.to("cpu")
    if mesh.has_vertex_colors():
        mesh_c.vertex_colors = mesh.vertex_colors.cpu()
    vis.export_html_viewer([mesh_c, cloud_c], cpu_path)
    with open(card_path, "rb") as f:
        html = f.read()
    with open(cpu_path, "rb") as f:
        byte_equal = f.read() == html
    scene = json.loads(re.search(rb"const SCENE = (\{.*?\});\n", html,
                                 re.S).group(1))

    def dec(g, k, dt):
        return np.frombuffer(base64.b64decode(g[k]), dt)

    gm, gc = scene["geoms"]
    tris = mesh_c.triangles.numpy()
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                            tris[:, [2, 0]]]).astype(np.uint32).reshape(-1)
    checks = {
        "mesh points": np.array_equal(dec(gm, "points", np.uint32),
                                      mesh_c.vertices.numpy().view(
                                          np.uint32).reshape(-1)),
        "mesh edges": np.array_equal(dec(gm, "lines", np.uint32), edges),
        "cloud points": np.array_equal(dec(gc, "points", np.uint32),
                                       cloud_c.points.numpy().view(
                                           np.uint32).reshape(-1)),
        "cloud colours": np.array_equal(
            dec(gc, "colors", np.uint32),
            np.clip(cloud_c.colors.numpy(), 0, 1).view(np.uint32)
            .reshape(-1)),
        "css": b"height:100%;" in html and b"100%%" not in html,
        "byte-equal to the CPU export": byte_equal,
    }
    if mesh.has_vertex_colors():
        checks["mesh colours"] = np.array_equal(
            dec(gm, "colors", np.uint32),
            np.clip(mesh_c.vertex_colors.numpy(), 0, 1).view(np.uint32)
            .reshape(-1))
    mb = len(html) / 1e6
    print(f"path: export_html_viewer of the mesh ({len(mesh_c.vertices)} "
          f"vertices, {tris.shape[0]} triangles) and the cloud "
          f"({len(cloud_c)} points coloured by height) from card tensors: "
          f"{ms:.1f} ms, {mb:.2f} MB written; "
          + ", ".join(f"{k} {v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError("the HTML export's arrays differ from the "
                             "geometries'")
    return ms, mb


def no_render_check(ctt, cloud, root):
    """A PNG render with matplotlib unimportable raises the RuntimeError
    that names it (the card's machine has no matplotlib); returns
    whether matplotlib is installed."""
    import importlib.util
    import sys

    installed = importlib.util.find_spec("matplotlib") is not None
    saved = sys.modules.get("matplotlib")
    sys.modules["matplotlib"] = None
    try:
        ctt.visualization.draw_geometries(
            [cloud], filename=os.path.join(root, "x.png"))
    except RuntimeError as e:
        if "matplotlib" not in str(e):
            raise
        print(f"path: draw_geometries to a PNG without matplotlib (installed "
              f"here: {installed}) raised: {e}")
    else:
        raise AssertionError("a PNG render without matplotlib did not raise")
    finally:
        if saved is None:
            del sys.modules["matplotlib"]
        else:
            sys.modules["matplotlib"] = saved
    return installed


def harness_timed(torch, ctt, reset_counts, counts, card):
    """The benchmark harness on its synthetic 120k cloud at HARNESS_REPS,
    its launches counted: ({op: ms}, launches)."""
    import contextlib
    import io

    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        results = ctt.bench.harness.main(["--reps", str(HARNESS_REPS)])
    torch.cuda.synchronize()
    launches = counts()
    ms = {r.name: r.seconds * 1e3 for r in results}
    print(f"path: bench.harness on its synthetic 120k cloud, reps "
          f"{HARNESS_REPS} (the least of them), launches {launches}: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f" on {card}")
    if tuple(ms) != ctt.bench.harness.OPS or not all(v > 0 for v in ms.values()):
        raise AssertionError(f"the harness's ops {tuple(ms)} or times are "
                             f"not the reference's")
    if launches["slot"] < 1:
        raise AssertionError("the harness's registration_icp did not take "
                             "the pooled grid (no kernel-1 launch)")
    return ms, launches


def harness_cli(np, ctt, root):
    """`python -m cupoch_tpu_torch.bench --pcd ... --reps 1 --trace ...`
    through `harness.main` on a HARNESS_CLI_POINTS-point binary PCD: the
    ops as the reference's, and kernel 1 among the trace's kernels:
    ({op: ms}, trace MB)."""
    import contextlib
    import io

    harness = ctt.bench.harness
    rng = np.random.default_rng(3)
    pcd = ctt.geometry.PointCloud(rng.uniform(size=(
        HARNESS_CLI_POINTS, 3)).astype(np.float32), device="cuda")
    path = os.path.join(root, "cli.pcd")
    ctt.io.write_point_cloud(path, pcd)
    trace = os.path.join(root, "trace")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli = harness.main(["--pcd", path, "--reps", "1", "--trace", trace])
    cli_s = time.perf_counter() - t0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    trace_file = os.path.join(trace, harness.TRACE_FILE)
    t0 = time.perf_counter()
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    read_s = time.perf_counter() - t0
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    slot = any("slot_kernel" in k for k in kernels)
    mb = os.path.getsize(trace_file) / 1e6
    cli_ms = {r.name: r.seconds * 1e3 for r in cli}
    print(f"path: python -m cupoch_tpu_torch.bench --pcd (a {len(pcd)}-point "
          f"binary PCD) --reps 1 --trace: {cli_s:.1f} s with the trace; "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in cli_ms.items())
          + f"; trace {mb:.1f} MB, {len(events)} events, {len(kernels)} "
          f"kernel names, kernel 1 (slot_kernel) among them: {slot}; read "
          f"in {read_s:.1f} s")
    if tuple(d["name"] for d in last) != harness.OPS or not slot:
        raise AssertionError("the harness's CLI run or its trace missed "
                             "its checks")
    return cli_ms, mb


def vis_phase(np, torch, ctt, reset_counts, counts, path_counts, card, mesh):
    """Phase 4v: colour maps on VIS_VALUES values on the card against the
    CPU; a view fitted on the card to phase 4s's `mesh` and the 1M-point
    headline cloud, its pinhole round trip, a view trajectory and the
    JSON files; the HTML export of both from card tensors against their
    CPU copies; a PNG render refused without matplotlib; the utility
    surface; the benchmark harness at its own size (launches counted in
    path_counts["4v"]) and through its CLI with a trace."""
    import contextlib
    import io

    t_phase = time.perf_counter()
    marks = []
    vis = ctt.visualization
    dev = "cuda"
    if not ctt.utility.is_cuda_available():
        raise AssertionError("utility.is_cuda_available() is False")
    values = np.random.default_rng(9).uniform(
        -0.2, 1.2, VIS_VALUES).astype(np.float32)
    values_d = torch.as_tensor(values, device=dev)
    map_ms, gaps = {}, {}
    for opt in vis.ColorMapOption:
        vis.get_color_map_color(values_d, opt)
        got, map_ms[opt.name] = _sync_ms(
            torch, lambda: vis.get_color_map_color(values_d, opt))
        if got.device.type != "cuda" or got.dtype != torch.float32 \
                or tuple(got.shape) != (VIS_VALUES, 3):
            raise AssertionError(f"colour map {opt.name}: {got.device} "
                                 f"{got.dtype} {tuple(got.shape)}")
        gaps[opt.name] = float(np.abs(
            got.cpu().numpy()
            - vis.get_color_map_color(values, opt, device="cpu").numpy())
            .max())
    print(f"path: colour maps on {VIS_VALUES} values in [-0.2, 1.2] on the "
          f"card: " + ", ".join(f"{k} {map_ms[k]:.3f} ms (gap to the CPU "
                                f"{gaps[k]:.1e})" for k in map_ms)
          + f" on {card}")
    if max(gaps.values()) > VIS_MAP_TOL:
        raise AssertionError("a colour map on the card differs from the "
                             "CPU's")
    marks.append(("colour maps", time.perf_counter()))

    tgt, _, _, _ = _headline_clouds(np, N_POINTS)
    cloud = ctt.geometry.PointCloud(tgt, device=dev)
    z = cloud.points[:, 2]
    cloud.colors = vis.get_color_map_color((z - z.min()) / (z.max() - z.min()))
    host = np.concatenate([mesh.vertices.cpu().numpy(), tgt])
    with tempfile.TemporaryDirectory() as root:
        view_checks(np, ctt, (mesh, cloud), host, root)
        marks.append(("views", time.perf_counter()))
        html_checks(np, torch, ctt, mesh, cloud, root)
        marks.append(("html", time.perf_counter()))
        no_render_check(ctt, cloud, root)
        bar_out = io.StringIO()
        with contextlib.redirect_stderr(bar_out):
            bar = ctt.utility.ConsoleProgressBar(4, "phase 4v")
            for _ in range(4):
                bar += 1
        if not bar_out.getvalue().endswith("] 100.0%\n"):
            raise AssertionError("ConsoleProgressBar wrote no full bar")
        marks.append(("no render", time.perf_counter()))
        del cloud, values_d
        _, path_counts["4v"] = harness_timed(torch, ctt, reset_counts,
                                             counts, card)
        marks.append(("harness", time.perf_counter()))
        harness_cli(np, ctt, root)
        marks.append(("harness CLI", time.perf_counter()))
    phase_s = time.perf_counter() - t_phase
    parts, last_t = [], t_phase
    for name, t in marks:
        parts.append(f"{name} {t - last_t:.1f}")
        last_t = t
    print(f"phase 4v: {phase_s:.1f} s ({', '.join(parts)})")
    if phase_s > VIS_PHASE_S:
        raise AssertionError(f"phase 4v took {phase_s:.1f} s")


# ---------------------------------------------------------------------------
# the multi-rank phase (4m): the point-sharded and ring-sharded ICP
# loops, the pose graph, bundle adjustment, RGB-D SLAM and the scaling
# bench over D ranks of `parallel.launch`. Ranks are NCCL, one a card,
# where the machine has D cards, else gloo ranks sharing the card (their
# collectives staged through the host); D = 1 runs in this process on a
# mesh of one rank
MULTI_PHASE_S = 120.0
MULTI_RANKS = (2, 4)
SHARDED_POSE_TOL = 1e-3      # tests/test_sharded.py's limits against the
SHARDED_FIT_TOL = 5e-3       # single-device loop
SPHERE_RADIUS = 10.0         # m
SPHERE_NOISE = (0.01, 0.02)  # rad and m, each edge's measurement
PG_ITERS = 10
PG_SHARDED_TOL = 1e-3
PG_ATE_RATIO = 0.6           # tests/test_slam.py's pose-graph criterion
BA_ITERS = 10
BA_RMSE_RATIO = 0.05         # tests/test_slam.py's criteria
BA_SHARDED_TOL = 2e-3
BA_INTRINSICS = (100.0, 100.0, 64.0, 48.0)
BA_BASELINE = 0.2            # m between cameras on the line
BA_NOISE = 0.02              # m on the initial poses and points
# RGB-D SLAM on phase 4k's room: the trajectory drifts by the pairs'
# odometry error (phase 4k holds a pair to ODO_T_MAX = 5 mm and read
# 1.3 mm on an H100), so 19 pairs stay within 2 cm; after a restore the
# first frame's motion is dropped, one trajectory step more
SLAM_T_MAX = 0.02
SMALL_CARD_POSE_TOL = 1e-4   # card ranks against CPU ranks
# RGB-D SLAM at 320x240, card ranks against CPU ranks: the hybrid
# odometry's rounding differs between the two, and 10 pairs moved the
# keyframes by 1.889e-3 to 1.935e-3 (four H100 runs; 5e-4 between the
# packages on the CPU at one thread); a pair's own error against the
# truth there is 1-2 mm (host run)
SMALL_SLAM_TOL = 3e-3


def multi_config():
    """Phase 4m's sizes: the headline and fallback clouds, sphere2500
    (Kaess et al., iSAM: 50 rings of 50 poses, 2500 poses and 4949
    edges), BAL's Trafalgar problem-257-65132-pre (257 cameras, 65 132
    landmarks, 225 911 observations in 8 slots a landmark) and phase
    4k's 20 frames at 640x480."""
    return {"points": N_POINTS, "side": 2.0, "fallback_side": FALLBACK_SIDE,
            "rings": (50, 50), "ba": (257, 65132, 225911, 8),
            "frames": RGBD_FRAMES, "scale": 1.0, "keyframe_interval": 5,
            "save_frame": 10, "slam_t_max": SLAM_T_MAX, "scaling": True}


def small_multi_config():
    """The test sizes: the paths on the card's ranks against CPU
    ranks, and in tests/test_torch_{sharded,slam}.py against the JAX
    package."""
    return {"points": 5000, "side": 1.0, "fallback_side": 1.0,
            "rings": (6, 8), "ba": (6, 64, 224, 4), "frames": 7,
            "scale": 0.5, "keyframe_interval": 2, "save_frame": 3,
            "slam_t_max": SLAM_T_MAX, "scaling": False}


def _rodrigues(np, w):
    """[..., 3] rotation vectors -> [..., 3, 3] (float64)."""
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.maximum(th[..., 0], 1e-300)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def sphere_graph(np, rings, per_ring, seed=7):
    """A sphere2500-style graph: poses on `rings` circles of latitude of a
    SPHERE_RADIUS sphere, `per_ring` a circle, facing along the path;
    odometry edges i-1 -> i and loop edges i-per_ring -> i; every
    measurement perturbed by SPHERE_NOISE; initial poses composed from
    the noisy odometry. Returns (gt [N, 4, 4], initial [N, 4, 4], src
    [E], tgt [E], measured [E, 4, 4]), float32 but gt (float64)."""
    rng = np.random.default_rng(seed)
    n = rings * per_ring
    i = np.arange(n)
    lat = -np.pi / 2 + np.pi * (i // per_ring + 1) / (rings + 1)
    lon = 2 * np.pi * (i % per_ring) / per_ring
    up = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                   np.sin(lat)], -1)
    east = np.stack([-np.sin(lon), np.cos(lon), np.zeros(n)], -1)
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, 0] = east
    gt[:, :3, 1] = np.cross(up, east)
    gt[:, :3, 2] = up
    gt[:, :3, 3] = SPHERE_RADIUS * up
    src = np.concatenate([i[:-1], i[:-per_ring]])
    tgt = np.concatenate([i[1:], i[per_ring:]])
    rel = np.linalg.inv(gt[src]) @ gt[tgt]
    noise = np.tile(np.eye(4), (len(src), 1, 1))
    noise[:, :3, :3] = _rodrigues(
        np, rng.normal(0, SPHERE_NOISE[0], (len(src), 3)))
    noise[:, :3, 3] = rng.normal(0, SPHERE_NOISE[1], (len(src), 3))
    meas = rel @ noise
    init = np.empty_like(gt)
    init[0] = gt[0]
    for k in range(1, n):
        init[k] = init[k - 1] @ meas[k - 1]
    return (gt, init.astype(np.float32), src, tgt,
            meas.astype(np.float32))


def pose_graph_of(ctt, init, src, tgt, meas):
    g = ctt.slam.PoseGraph()
    g.nodes = [ctt.slam.PoseGraphNode(p) for p in init]
    g.edges = [ctt.slam.PoseGraphEdge(int(s), int(t), m)
               for s, t, m in zip(src, tgt, meas)]
    return g


def translation_ate(np, poses, gt):
    return float(np.sqrt(np.mean(np.sum(
        (np.asarray(poses)[:, :3, 3] - gt[:, :3, 3]) ** 2, -1))))


def ba_problem(np, n_cams, n_pts, n_obs, k, seed=8):
    """A BA problem made as tests/test_slam.py makes its own, with BAL's
    shape: cameras on a line BA_BASELINE m apart looking along +z,
    camera 0 at the origin (the world is its frame), landmarks in the
    slab z in [2, 3] m over the line widened by 1 m at each end, each
    seen by its 2 to k nearest cameras (n_obs observations in all), as a
    walk's photos overlap; exact measurements, the translations of
    cameras 1.. and the points moved by BA_NOISE. Returns (poses0,
    points0, obs_cam, obs_uv, intrinsics, gt_poses, gt_points) as
    float32 / int32 numpy."""
    rng = np.random.default_rng(seed)
    gt_poses = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    gt_poses[:, 0, 3] = -BA_BASELINE * np.arange(n_cams)
    span = BA_BASELINE * (n_cams - 1)
    gt_pts = rng.uniform([-1.0, -1.0, 2.0], [span + 1.0, 1.0, 3.0],
                         size=(n_pts, 3)).astype(np.float32)
    base = n_obs // n_pts
    m = np.full(n_pts, base)
    m[rng.choice(n_pts, n_obs - base * n_pts, replace=False)] += 1
    if m.max() > k or base < 2 or n_cams < k:
        raise ValueError("observations do not fit the slots")
    # the k nearest cameras lie among the 2k + 1 round the nearest one
    near = np.clip(np.rint(gt_pts[:, 0] / BA_BASELINE).astype(np.int64), 0,
                   n_cams - 1)
    cand = near[:, None] + np.arange(-k, k + 1)
    dist = np.abs(gt_pts[:, :1] - BA_BASELINE * cand)
    dist[(cand < 0) | (cand >= n_cams)] = np.inf
    order = np.argsort(dist, axis=1, kind="stable")[:, :k]
    cams = np.take_along_axis(cand, order, 1)
    obs_cam = np.where(np.arange(k)[None, :] < m[:, None], cams, -1)
    T = gt_poses[cams].astype(np.float64)
    pc = np.einsum("lkij,lj->lki", T[..., :3, :3], gt_pts) + T[..., :3, 3]
    fx, fy, cx, cy = BA_INTRINSICS
    obs_uv = np.stack([fx * pc[..., 0] / pc[..., 2] + cx,
                       fy * pc[..., 1] / pc[..., 2] + cy],
                      -1).astype(np.float32)
    poses0 = gt_poses.copy()
    poses0[1:, :3, 3] += rng.normal(0, BA_NOISE, (n_cams - 1, 3))
    pts0 = gt_pts + rng.normal(0, BA_NOISE, gt_pts.shape).astype(np.float32)
    return (poses0, pts0, obs_cam.astype(np.int32), obs_uv,
            np.float32(BA_INTRINSICS), gt_poses, gt_pts)


def scale_aligned_gap(np, poses_a, poses_b):
    """Largest gap of camera translations 1.. of `poses_a`, scaled by
    the least-squares factor onto `poses_b` (the monocular gauge), from
    `poses_b`'s."""
    ta = np.asarray(poses_a)[1:, :3, 3].astype(np.float64)
    tb = np.asarray(poses_b)[1:, :3, 3].astype(np.float64)
    s = float(np.sum(ta * tb) / max(np.sum(ta * ta), 1e-12))
    return float(np.abs(s * ta - tb).max())


def slam_frames(np, cfg, directory):
    """Phase 4k's room at cfg's scale, its frames (colour uint8, depth
    uint16 mm) written to an .npz under `directory`: (intrinsic as a
    dict, the file's path). Ranks read the file: a spawned rank's
    arguments go through a pipe that its start blocks on."""
    import cupoch_tpu_torch as ctt
    intr, _ = kinfu_config(ctt)
    if cfg["scale"] != 1.0:
        intr = intr.scale(cfg["scale"])
    arrays = {}
    for k in range(cfg["frames"]):
        rgb, depth = room_depth(np, rgbd_pose(np, k), intr)
        arrays[f"c{k}"] = rgb
        arrays[f"d{k}"] = np.round(depth * RGBD_DEPTH_SCALE).astype(np.uint16)
    path = os.path.join(directory, f"frames_{intr.width}.npz")
    np.savez(path, **arrays)
    return intr.to_dict(), path


def load_frames(np, path):
    """[(colour, depth)] of a `slam_frames` file."""
    with np.load(path) as z:
        return [(z[f"c{k}"], z[f"d{k}"]) for k in range(len(z.files) // 2)]


def slam_option(ctt, cfg):
    """Keyframes every cfg["keyframe_interval"] frames, a loop closure
    tried at every keyframe against keyframes two or more back, and an
    optimisation every 2 keyframes."""
    return ctt.slam.SlamOption(
        keyframe_interval=cfg["keyframe_interval"], loop_closure_interval=1,
        loop_closure_min_gap=2, optimize_every_n_keyframes=2)


def multi_slam(intr_dict, frames_path, cfg, mesh):
    """RGBDSlam over the frames of `frames_path` (`slam_frames`) without
    a break, then again with a save
    after frame cfg["save_frame"] and a restore into a new instance that
    runs on; each run ends with one more optimisation. Rank 0 tracks; the
    others pass None. Returns both runs' states and the tracked frames'
    indices, the saved and restored states, and ms a frame."""
    import tempfile

    import numpy as np

    import cupoch_tpu_torch as ctt
    intr = ctt.camera.PinholeCameraIntrinsic.from_dict(intr_dict)
    opt = slam_option(ctt, cfg)
    lead = mesh.rank == 0
    dev = mesh.device
    frames = load_frames(np, frames_path) if lead else None

    def frame(k):
        if not lead:
            return None
        c, d = frames[k]
        return ctt.geometry.RGBDImage.create_from_color_and_depth(
            ctt.geometry.Image(c, device=dev),
            ctt.geometry.Image(d, device=dev))

    def run(slam, ks):
        for k in ks:
            slam.process_frame(frame(k))
        slam.optimize()

    n, s = cfg["frames"], cfg["save_frame"]
    whole = ctt.slam.RGBDSlam(intr, opt, mesh=mesh)
    t0 = time.perf_counter()
    run(whole, range(n))
    ms = (time.perf_counter() - t0) * 1e3 / n
    first = ctt.slam.RGBDSlam(intr, opt, mesh=mesh)
    for k in range(s + 1):
        first.process_frame(frame(k))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slam.npz")
        first.save(path)
        again = ctt.slam.RGBDSlam(intr, opt, mesh=mesh)
        again.restore(path)
    saved = dict(first.state(), frame_id=first.frame_id,
                 since_opt=first._since_opt)
    restored = dict(again.state(), frame_id=again.frame_id,
                    since_opt=again._since_opt)
    run(again, range(s + 1, n))
    # the frame after a restore re-anchors tracking and adds no pose
    resumed = list(range(s + 1)) + list(range(s + 2, n))
    return {"whole": whole.state(), "resumed": again.state(),
            "resumed_frames": resumed, "saved": saved,
            "restored": restored, "ms": ms}


def slam_errors(np, traj, frames):
    """Translation error of each tracked pose against the trajectory's
    truth (the first camera's frame is the world)."""
    return np.asarray([np.linalg.norm(T[:3, 3] - rgbd_pose(np, k)[:3, 3])
                       for T, k in zip(traj, frames)])


def check_multi_slam(np, out, t_max, what):
    """The SLAM limits on one rank's `multi_slam` output: trajectory
    errors within `t_max`, and after the restore one step more."""
    for key in out["saved"]:
        if not np.array_equal(np.asarray(out["saved"][key]),
                              np.asarray(out["restored"][key])):
            raise AssertionError(f"{what}: restored {key} differs from the "
                                 f"saved one")
    n = len(out["whole"]["trajectory"])
    e_whole = slam_errors(np, out["whole"]["trajectory"], range(n))
    e_res = slam_errors(np, out["resumed"]["trajectory"],
                        out["resumed_frames"])
    step = float(np.linalg.norm(RGBD_STEP_SHIFT))
    # a dropped step also turns the rest by RGBD_STEP_DEG, which moves
    # them by under 1 mm over these few centimetres
    limit_res = t_max + step + 1e-3
    lc = int(out["whole"]["edge_uncertain"].sum())
    if e_whole.max() > t_max or e_res.max() > limit_res \
            or not np.isfinite(out["whole"]["keyframe_poses"]).all():
        raise AssertionError(
            f"{what}: trajectory errors {e_whole.max():.4e} (limit "
            f"{t_max}) and after the restore {e_res.max():.4e} (limit "
            f"{limit_res:.4e})")
    return e_whole.max(), e_res.max(), lc


def multi_collectives(mesh):
    """Each collective of the mesh on values that depend on the rank."""
    import torch
    x = torch.arange(4, dtype=torch.float32, device=mesh.device) \
        + 10.0 * mesh.rank
    return {"psum": mesh.psum(x), "pmin": mesh.pmin(x),
            "pmax": mesh.pmax(x), "ppermute": mesh.ppermute(x),
            "all_gather": mesh.all_gather(x[None]),
            "broadcast_tensor": mesh.broadcast(x),
            "broadcast": mesh.broadcast_object({"from": mesh.rank})}


def check_collectives(np, outs):
    """`multi_collectives` of every rank against what each collective
    must give."""
    D = len(outs)
    xs = [np.arange(4, dtype=np.float32) + 10.0 * r for r in range(D)]
    for r, o in enumerate(outs):
        want = {"psum": sum(xs), "pmin": xs[0], "pmax": xs[-1],
                "ppermute": xs[(r - 1) % D], "all_gather": np.stack(xs),
                "broadcast_tensor": xs[0]}
        for k, v in want.items():
            if not np.array_equal(o[k], v):
                raise AssertionError(f"{k} at rank {r} of {D}: {o[k]}")
        if o["broadcast"] != {"from": 0}:
            raise AssertionError(f"broadcast at rank {r}: {o['broadcast']}")


def multi_ring(cfg, mesh):
    """ring_sharded_registration_icp on the headline pair."""
    import numpy as np

    import cupoch_tpu_torch as ctt
    tgt, tn, src, _ = _headline_clouds(np, cfg["points"], side=cfg["side"])
    return ctt.parallel.ring_sharded_registration_icp(
        src, tgt, tn, RADIUS, mesh, max_iteration=ITERS)


def multi_point(cfg, mesh):
    """sharded_registration_icp on the fallback cloud."""
    import numpy as np

    import cupoch_tpu_torch as ctt
    tgt, tn, src, _ = _headline_clouds(np, cfg["points"],
                                       side=cfg["fallback_side"])
    return ctt.parallel.sharded_registration_icp(
        src, tgt, tn, RADIUS, mesh, max_iteration=ITERS)


def ring_round_check(cfg, mesh):
    """On rank 1 of 2: kernel 1 on the first round's shard (rank 1's
    table shard, global supertiles Gd..) against slot_plain; (equal share,
    largest score gap, Gd, valid queries). Other ranks, and ranks on the
    CPU, return None."""
    if mesh.size != 2 or mesh.rank != 1 or mesh.device.type != "cuda":
        return None
    import numpy as np
    import torch

    from cupoch_tpu_torch.knn import poolgrid, poolgrid_slot
    from cupoch_tpu_torch.parallel import sharded
    from cupoch_tpu_torch.registration import fused_icp
    from cupoch_tpu_torch.registration.estimation import (
        TransformationEstimationType as ET)
    tgt, tn, src, _ = _headline_clouds(np, cfg["points"], side=cfg["side"])
    dev = mesh.device
    src_l, mask_l = sharded._source_shard(src, mesh)
    attrs, code = fused_icp.make_target_attrs(
        ET.PointToPlane, torch.as_tensor(tgt, device=dev),
        torch.as_tensor(tn, device=dev))
    plan = poolgrid.plan_poolgrid(tgt, RADIUS, query_points=src, est=code,
                                  shards=2)
    grid = sharded.shard_pool_table(poolgrid.make_poolgrid(
        torch.as_tensor(tgt, device=dev), attrs, plan["origin"],
        plan["cell_size"], plan["dims"], plan["cap"], plan["kc"], est=code,
        tile=plan["tile"], shards=2, active_cells=plan["active_cells"]),
        mesh)
    Gd = grid.n_tiles
    qpool, _, _ = poolgrid.bin_queries_pool(
        src_l, torch.eye(4), grid.origin, grid.cell_size, grid.dims,
        plan["qp"], grid.tile, mask=mask_l, shards=2,
        cell_map=grid.cell_map, n_rank_pad=2 * Gd * grid.tile)
    block = qpool.reshape(2, Gd, *qpool.shape[1:])[1]
    params = poolgrid.make_params(torch.eye(4), RADIUS ** 2, grid)
    same, gap = slot_gap(torch, grid, block, params,
                         poolgrid_slot.slot_pass(grid, block, params),
                         poolgrid_slot.slot_plain(grid, block, params),
                         "rank 1's table shard")
    return same, gap, Gd, int((block[:, 3] >= 0).sum())


def point_shard_check(cfg, mesh):
    """On rank 0: kernel 2 in GN mode (point-to-plane) on its shard of
    the fallback cloud against fused_plain; (relative sum gap, pose
    update gap, queries). Other ranks, and ranks on the CPU, return None."""
    if mesh.rank != 0 or mesh.device.type != "cuda":
        return None
    import numpy as np
    import torch

    from cupoch_tpu_torch.knn import rungrid, rungrid_fused
    from cupoch_tpu_torch.parallel import sharded
    from cupoch_tpu_torch.registration import fused_icp
    from cupoch_tpu_torch.registration.estimation import (
        TransformationEstimationType as ET)
    tgt, tn, src, _ = _headline_clouds(np, cfg["points"],
                                       side=cfg["fallback_side"])
    dev = mesh.device
    src_l, mask_l = sharded._source_shard(src, mesh)
    attrs, code = fused_icp.make_target_attrs(
        ET.PointToPlane, torch.as_tensor(tgt, device=dev),
        torch.as_tensor(tn, device=dev))
    plan = rungrid.plan_rungrid(tgt, RADIUS, query_points=src, nch=4)
    grid = rungrid.make_rungrid(
        torch.as_tensor(tgt, device=dev), attrs, plan["origin"],
        plan["cell_size"], plan["dims"], plan["cap"], est=code,
        kc=plan["kc"])
    qsoa, qidx = rungrid.bin_queries(src_l, src_l, grid.origin,
                                     grid.cell_size, grid.dims,
                                     plan["qcap"], mask=mask_l)
    params = rungrid.make_params(torch.eye(4), RADIUS ** 2, grid)
    sk = rungrid_fused.fused_query(grid, qsoa, qidx, params, code, False)
    sp = rungrid_fused.fused_plain(grid, qsoa, qidx, params, code, False)
    rel, d_pose = fused_gn_gap(fused_icp, ET.PointToPlane, sk.cpu(),
                               sp.cpu())
    return rel, d_pose, int(mask_l.sum())


def multi_pose_graph(cfg, mesh):
    """global_optimization of the sphere graph over the mesh: (poses,
    ms an iteration, peak MB on the device)."""
    import numpy as np
    import torch

    import cupoch_tpu_torch as ctt
    _, init, src, tgt, meas = sphere_graph(np, *cfg["rings"])
    g = pose_graph_of(ctt, init, src, tgt, meas)
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    ctt.slam.global_optimization(
        g, ctt.slam.GlobalOptimizationOption(max_iteration=PG_ITERS),
        mesh=mesh)
    ms = (time.perf_counter() - t0) * 1e3 / PG_ITERS
    peak = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 20 \
        if on_card else 0.0
    return np.stack([n.pose for n in g.nodes]), ms, peak


def multi_ba(cfg, mesh):
    """bundle_adjustment of the BA problem over the mesh: (poses,
    points, initial and final reprojection RMSE, ms an iteration, peak
    MB)."""
    import numpy as np
    import torch

    import cupoch_tpu_torch as ctt
    C, L, n_obs, k = cfg["ba"]
    prob = ctt.slam.BAProblem(*ba_problem(np, C, L, n_obs, k)[:5])
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    poses, points, _ = ctt.slam.bundle_adjustment(prob, BA_ITERS,
                                                  mesh=mesh)
    ms = (time.perf_counter() - t0) * 1e3 / BA_ITERS
    peak = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 20 \
        if on_card else 0.0
    rmse0 = ctt.slam.reprojection_rmse(prob, device=mesh.device)
    rmse = ctt.slam.reprojection_rmse(prob, poses, points)
    return poses, points, rmse0, rmse, ms, peak


def multi_small(intr_dict, frames_path, mesh):
    """Every path of the phase at the test sizes (a job for the card's
    ranks and for CPU ranks, compared by `check_small_multi`)."""
    cfg = small_multi_config()
    return {"collectives": multi_collectives(mesh),
            "ring": multi_ring(cfg, mesh), "point": multi_point(cfg, mesh),
            "pose_graph": multi_pose_graph(cfg, mesh)[0],
            "ba": multi_ba(cfg, mesh)[:2],
            "slam": multi_slam(intr_dict, frames_path, cfg, mesh)}


def check_small_multi(np, card, cpu):
    """The card ranks' `multi_small` against the CPU ranks': poses within
    SMALL_CARD_POSE_TOL (ICP, the pose graph), fitness within 1e-3, BA
    within BA_SHARDED_TOL after scale alignment, SLAM keyframes within
    SMALL_SLAM_TOL; returns the largest gaps."""
    gaps = {}
    for key in ("ring", "point"):
        gaps[key] = float(np.abs(card[key][0] - cpu[key][0]).max())
        if gaps[key] > SMALL_CARD_POSE_TOL \
                or abs(card[key][1] - cpu[key][1]) > 1e-3:
            raise AssertionError(f"small {key} ICP: card {card[key][:4]} "
                                 f"against CPU {cpu[key][:4]}")
    gaps["pose_graph"] = float(np.abs(card["pose_graph"]
                                      - cpu["pose_graph"]).max())
    gaps["ba"] = scale_aligned_gap(np, card["ba"][0], cpu["ba"][0])
    gaps["slam"] = float(np.abs(card["slam"]["whole"]["keyframe_poses"]
                                - cpu["slam"]["whole"]["keyframe_poses"])
                         .max())
    if gaps["pose_graph"] > SMALL_CARD_POSE_TOL \
            or gaps["ba"] > BA_SHARDED_TOL or gaps["slam"] > SMALL_SLAM_TOL:
        raise AssertionError(f"small inputs, card against CPU: {gaps}")
    return gaps


def multi_rank_jobs(ctt, D, cfg, intr_dict, frames, small):
    """{name: job} that every rank of a D-rank group runs, in order."""
    from cupoch_tpu_torch.bench import scaling
    from cupoch_tpu_torch.parallel.launch import Job
    jobs = {"collectives": Job(multi_collectives),
            "ring": Job(multi_ring, (cfg,)),
            "ring check": Job(ring_round_check, (cfg,)),
            "point": Job(multi_point, (cfg,)),
            "point check": Job(point_shard_check, (cfg,)),
            "pose graph": Job(multi_pose_graph, (cfg,)),
            "ba": Job(multi_ba, (cfg,)),
            "slam": Job(multi_slam, (intr_dict, frames, cfg))}
    if cfg["scaling"] and D > 1:
        if D == max(MULTI_RANKS):
            jobs["scaling"] = Job(scaling.run_scaling)
        jobs["split"] = Job(scaling.collective_split)
    if small is not None:
        jobs["small"] = Job(multi_small, small)
    return jobs


def _by_name(jobs, ranks_out):
    """Per rank, {job name: the launcher's record}."""
    return [dict(zip(jobs, r)) for r in ranks_out]


def multi_phase(np, torch, ctt, reset_counts, counts, path_counts, card,
                dev="cuda", config=multi_config, refs=None):
    """Phase 4m: every sub-step at D = 1 (this process, a mesh of one
    rank) and in one group of D ranks for each D of MULTI_RANKS, held to
    the limits above, and the paths at the test sizes on the card's 2
    ranks against 2 CPU gloo ranks. D = 1 runs first, alone on the card;
    then the rank groups and the CPU ranks run at the same time, so
    each group's times include the other's load, and every line says so
    (the phase limit does not fit them one after another: a group takes
    15-25 s to start its ranks and to load their kernels). `refs`: the
    single-device
    `registration_icp` results on the headline pair and on the fallback
    cloud at this phase's settings, when the caller has them (phase 4
    computes both), else computed here."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase4m_")
    try:
        _multi_phase(np, torch, ctt, reset_counts, counts, path_counts,
                     card, dev, config(), small_multi_config(), refs, tmp,
                     t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _multi_phase(np, torch, ctt, reset_counts, counts, path_counts, card,
                 dev, cfg, small_cfg, refs, tmp, t_phase):
    """`multi_phase`'s body; its frame files go to `tmp`."""
    from cupoch_tpu_torch.parallel import launch
    # a rehearsal on the CPU runs the plain versions, which count no
    # launch
    on_card = dev != "cpu"
    intr_dict, frames = slam_frames(np, cfg, tmp)
    small = slam_frames(np, small_cfg, tmp)
    marks = [("scene", time.perf_counter())]
    if on_card:
        torch.cuda.empty_cache()
    tgt, tn, src, T_true = _headline_clouds(np, cfg["points"],
                                            side=cfg["side"])
    ftgt, ftn, fsrc, fT_true = _headline_clouds(np, cfg["points"],
                                                side=cfg["fallback_side"])
    pt2pl = ctt.registration.TransformationEstimationPointToPlane()
    crit = ctt.registration.ICPConvergenceCriteria(REL_TOL, REL_TOL, ITERS)

    def single(s, t, n):
        target = ctt.geometry.PointCloud(torch.as_tensor(t, device=dev),
                                         device=dev)
        target.normals = torch.as_tensor(n, device=dev)
        return ctt.registration.registration_icp(
            ctt.geometry.PointCloud(torch.as_tensor(s, device=dev),
                                    device=dev), target,
            RADIUS, estimation=pt2pl, criteria=crit)

    ref_ring, ref_point = refs if refs is not None else (
        single(src, tgt, tn), single(fsrc, ftgt, ftn))
    plan = ctt.knn.poolgrid.plan_poolgrid(tgt, RADIUS, query_points=src,
                                          est=2)
    n_cells = len(plan["active_cells"]) \
        if plan["active_cells"] is not None else int(np.prod(plan["dims"]))
    gt_sphere, init_sphere = sphere_graph(np, *cfg["rings"])[:2]
    C, L, n_obs, k = cfg["ba"]
    marks.append(("references", time.perf_counter()))

    # D = 1: the same jobs in this process on a mesh of one rank, alone
    # on the card
    jobs = multi_rank_jobs(ctt, 1, cfg, intr_dict, frames, None)
    out1 = {}
    for name, job in jobs.items():
        m = ctt.parallel.make_point_mesh(1, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        res = job.fn(*job.args, mesh=m)
        if on_card:
            torch.cuda.synchronize()
        out1[name] = {"result": launch.to_numpy(res),
                      "seconds": time.perf_counter() - t0,
                      "launches": counts(), "staged": m.staged,
                      "staged_bytes": m.staged_bytes}
    groups = {1: ("one rank, run alone", [out1])}
    marks.append(("D=1", time.perf_counter()))
    # then the rank groups and the CPU ranks, all at the same time
    started = {"cpu": ({"small": launch.Job(multi_small, small)},
                       launch.start_ranks([launch.Job(multi_small, small)],
                                          2, backend="gloo", device="cpu"))}
    for D in MULTI_RANKS:
        backend = "nccl" if on_card and torch.cuda.device_count() >= D \
            else "gloo"
        jobs = multi_rank_jobs(ctt, D, cfg, intr_dict, frames,
                               small if D == 2 else None)
        started[D] = (jobs, launch.start_ranks(
            list(jobs.values()), D, backend=backend, device=dev), backend)
    for D in MULTI_RANKS:
        jobs, handle, backend = started[D]
        groups[D] = (backend, _by_name(jobs, handle.join()))
        marks.append((f"D={D} joined", time.perf_counter()))
    cpu_small = started["cpu"][1].join()
    marks.append(("CPU ranks joined", time.perf_counter()))

    pg_ref = ba_ref = None
    for D in (1,) + MULTI_RANKS:
        backend, ranks = groups[D]
        shared = D > 1 and dev != "cpu" and torch.cuda.device_count() < D
        beside = ", ".join(f"the D={o} group" for o in MULTI_RANKS
                           if o != D) + " and 2 CPU ranks"
        where = f"D={D} ({backend}" + (
            ", ranks sharing one card" if shared else "") + (
            f", at the same time as {beside})" if D > 1 else ")")
        res = [{k: j["result"] for k, j in r.items()} for r in ranks]
        staged = [sum(j["staged"] for j in r.values()) for r in ranks]
        staged_b = [sum(j["staged_bytes"] for j in r.values())
                    for r in ranks]
        secs = {k: round(max(r[k]["seconds"] for r in ranks), 2)
                for k in ranks[0]}
        print(f"multi {where}: {D} rank(s) on {dev}; host-staged "
              f"collectives a rank {staged} ({[b / 1e9 for b in staged_b]} "
              f"GB); seconds a job (the slowest rank) {secs}")
        check_collectives(np, [r["collectives"] for r in res])
        # ring ICP
        for r, (T, fit, rmse, it, secs) in enumerate(x["ring"] for x in res):
            lc = ranks[r]["ring"]["launches"]
            pose_err = float(np.abs(T - T_true).max())
            ref_err = float(np.abs(T - ref_ring.transformation).max())
            if pose_err > POSE_TOL or fit < 0.99 or ref_err > \
                    SHARDED_POSE_TOL or abs(fit - ref_ring.fitness) > \
                    SHARDED_FIT_TOL or lc["slot"] != on_card * D * (it + 1):
                raise AssertionError(
                    f"ring ICP {where} rank {r}: pose error {pose_err}, "
                    f"fitness {fit}, against registration_icp {ref_err}, "
                    f"slot launches {lc['slot']} for {it} iterations")
            path_counts[f"4m ring {where} rank {r}"] = lc
        T, fit, rmse, it, secs = res[0]["ring"]
        rows = -(-n_cells // (plan["tile"] * D)) * plan["tile"] * D
        shard_gb = rows * plan["kc"] * 16 / D / 1e9
        print(f"path: ring_sharded_registration_icp {where}: fitness "
              f"{fit:.6f} rmse {rmse:.6e} iterations {it} pose error "
              f"{np.abs(T - T_true).max():.3e}, against registration_icp "
              f"{np.abs(T - ref_ring.transformation).max():.3e}; slot "
              f"launches a rank "
              f"{[r['ring']['launches']['slot'] for r in ranks]}"
              f"; {secs:.3f} s (grid build and loop, rank 0); the ring "
              f"moves {(D - 1) * shard_gb:.3f} GB a rank a pass "
              f"({D - 1} x a {shard_gb:.3f} GB shard; staged "
              f"{ranks[0]['ring']['staged_bytes'] / max(it + 1, 1) / 1e9:.3f} "
              f"GB a pass on rank 0)")
        if D == 2 and res[1]["ring check"] is not None:
            same, gap, Gd, nq = res[1]["ring check"]
            print(f"kernel[slot ring shard]: rank 1's first round on its "
                  f"table shard (global supertiles {Gd}..), {nq} valid "
                  f"queries: "
                  f"slots equal on {same:.6f}, max score gap {gap}")
        # point-sharded ICP
        for r, (T, fit, rmse, it, secs) in enumerate(x["point"] for x in res):
            lc = ranks[r]["point"]["launches"]
            ref_err = float(np.abs(T - ref_point.transformation).max())
            if np.abs(T - fT_true).max() > POSE_TOL or fit < 0.99 \
                    or ref_err > SHARDED_POSE_TOL \
                    or abs(fit - ref_point.fitness) > SHARDED_FIT_TOL \
                    or lc["fused_gn"] != on_card * it \
                    or lc["fused_corres"] != on_card:
                raise AssertionError(
                    f"point-sharded ICP {where} rank {r}: fitness {fit}, "
                    f"against the run-grid fallback {ref_err}, launches "
                    f"{lc} for {it} iterations")
            path_counts[f"4m point {where} rank {r}"] = lc
        T, fit, rmse, it, secs = res[0]["point"]
        print(f"path: sharded_registration_icp {where}: fitness {fit:.6f} "
              f"rmse {rmse:.6e} iterations {it} pose error "
              f"{np.abs(T - fT_true).max():.3e}, against the run-grid "
              f"fallback {np.abs(T - ref_point.transformation).max():.3e}; "
              f"fused launches on rank 0 {ranks[0]['point']['launches']}; "
              f"{secs:.3f} s")
        if res[0]["point check"] is not None:
            rel, d_pose, nq = res[0]["point check"]
            print(f"kernel[fused GN, rank 0's shard] {where}: {nq} points, "
                  f"sums within {rel:.2e} of fused_plain's, pose update "
                  f"{d_pose:.2e}")
        # pose graph
        poses, ms, peak = res[0]["pose graph"]
        if any(not np.array_equal(r["pose graph"][0], poses) for r in res):
            raise AssertionError(f"pose graph {where}: ranks differ")
        before = translation_ate(np, init_sphere, gt_sphere)
        after = translation_ate(np, poses, gt_sphere)
        anchor = float(np.abs(poses[0] - init_sphere[0]).max())
        if D == 1:
            pg_ref = poses
        gap = float(np.abs(poses - pg_ref).max())
        print(f"path: global_optimization {where}, {len(poses)} poses, "
              f"{PG_ITERS} iterations: ATE {before:.4f} -> {after:.4f} m, "
              f"node 0 moved {anchor:.2e}, against D=1 {gap:.2e}; "
              f"{ms:.1f} ms an iteration, peak {peak:.0f} MB a rank")
        if not after < PG_ATE_RATIO * before or anchor > 1e-6 \
                or gap > PG_SHARDED_TOL:
            raise AssertionError(f"pose graph {where} missed its limits")
        # bundle adjustment
        bposes, bpoints, rmse0, rmse, ms, peak = res[0]["ba"]
        if D == 1:
            ba_ref = bposes
        gap = scale_aligned_gap(np, bposes, ba_ref)
        print(f"path: bundle_adjustment {where}, {C} cameras, {L} "
              f"landmarks, {n_obs} observations: reprojection RMSE "
              f"{rmse0:.4f} -> {rmse:.3e} px, against D=1 after scale "
              f"alignment {gap:.2e}; {ms:.1f} ms an iteration, peak "
              f"{peak:.0f} MB a rank")
        if not rmse < BA_RMSE_RATIO * rmse0 or gap > BA_SHARDED_TOL:
            raise AssertionError(f"bundle adjustment {where} missed its "
                                 f"limits")
        # RGB-D SLAM
        out = res[0]["slam"]
        e_whole, e_res, lc = check_multi_slam(np, out, cfg["slam_t_max"],
                                          f"RGBDSlam {where}")
        for r in res[1:]:
            for key, v in out["whole"].items():
                if not np.array_equal(np.asarray(v),
                                      np.asarray(r["slam"]["whole"][key])):
                    raise AssertionError(f"RGBDSlam {where}: ranks' {key} "
                                         f"differ")
        print(f"path: RGBDSlam {where}, {cfg['frames']} frames: "
              f"{len(out['whole']['keyframe_poses'])} keyframes, {lc} loop "
              f"closure(s); trajectory error max {e_whole:.4e} m, after the "
              f"restore at frame {cfg['save_frame']} {e_res:.4e} m; restored "
              f"state equal to the saved one"
              f"{'; ranks equal' if D > 1 else ''}; {out['ms']:.1f} ms a "
              f"frame")
        for row in res[0].get("scaling", ()):
            print(f"bench.scaling run_scaling {where}: " + json.dumps(row))
        if "split" in res[0]:
            print(f"bench.scaling collective_split {where}: "
                  + json.dumps(res[0]["split"]))
    gaps = check_small_multi(np, groups[2][1][0]["small"]["result"],
                             cpu_small[0][0]["result"])
    print(f"multi small inputs, card ranks against CPU gloo ranks (D=2): "
          f"largest gaps {gaps}")
    phase_s = time.perf_counter() - t_phase
    parts, last = [], t_phase
    for name, t in marks:
        parts.append(f"{name} {t - last:.1f}")
        last = t
    print(f"phase 4m: {phase_s:.1f} s ({', '.join(parts)}; D = 1 ran "
          f"alone, then the groups and the CPU ranks together)")
    if phase_s > MULTI_PHASE_S:
        raise AssertionError(f"phase 4m took {phase_s:.1f} s")


def _on(ctt, obj, device):
    """A copy of a mesh or cloud on `device`."""
    G = ctt.geometry
    if isinstance(obj, G.TriangleMesh):
        out = G.TriangleMesh(obj.vertices.to(device),
                             obj.triangles.to(device), device=device)
        for name in ("vertex_normals", "vertex_colors"):
            v = getattr(obj, name)
            setattr(out, name, None if v is None else v.to(device))
        return out
    out = G.PointCloud(obj.points.to(device), device=device)
    for name in ("normals", "colors"):
        v = getattr(obj, name)
        setattr(out, name, None if v is None else v.to(device))
    return out


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


def _bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _issue_ms(visits, instr, card_clock):
    """Computed issue ceiling: `visits` (query, lane) pairs at `instr`
    instructions each, issued at ISSUE_PER_CLOCK_SM on every SM of the
    card at its maximum SM clock (`card_clock` = (SMs, Hz))."""
    sms, hz = card_clock
    return visits * instr / (ISSUE_PER_CLOCK_SM * sms * hz) * 1e3


def _kernel_build(nvcc, name, occupancy):
    """The ptxas register / spill lines of `name`'s build, and the
    kernel's occupancy at these shapes as the runtime reports it."""
    ptxas = " | ".join(ln.strip().replace("ptxas info    : ", "")
                       for ln in nvcc.build_logs.get(name, "").splitlines()
                       if "Used" in ln or "spill" in ln) or "cached"
    blocks, warps = occupancy
    return (f"occupancy {blocks} blocks of {warps} warps an SM; ptxas: "
            f"{ptxas}")


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


def slot_gap(torch, grid, qpool, params, got, want, mode):
    """(share of valid queries whose slot equals slot_plain's, largest
    score gap) of slots `got` against `want`; raises unless >= AGREE_MIN
    are equal and every score gap lies within a key quantum."""
    torch.cuda.synchronize()
    valid = qpool[:, 3] >= 0
    same = float(((got == want) & valid).sum()) / max(int(valid.sum()), 1)
    sk, quantum = _scores(torch, grid, qpool, params, got)
    sp, _ = _scores(torch, grid, qpool, params, want)
    err = torch.where(valid, (sk - sp).abs(), 0.0)
    max_err = float(err.max())
    worst = float((err - torch.where(valid, quantum, 0.0)).max())
    if same < AGREE_MIN or worst > 0:
        raise AssertionError(
            f"slot kernel ({mode}) disagrees with slot_plain: {same:.6f} "
            f"equal, max score gap {max_err} vs the key quantum")
    return same, max_err


def _slot_scanned(torch, grid, qpool):
    """(query, slot) visits kernel 1 makes: each cell's queries in groups
    of 8, the last of r < 8 scored as 8 when r > 4 and as 4 otherwise,
    each over the row's KC slots."""
    tag = qpool[:, 3]
    valid = tag >= 0
    rows = torch.arange(tag.shape[0], device=tag.device)[:, None] \
        * grid.tile + tag.clamp(min=0).long()
    n = torch.bincount(rows[valid], minlength=grid.table.shape[0])
    r = n % 8
    slots = n // 8 * 8 + torch.where(r > 4, 8, torch.where(r > 0, 4, 0))
    return int(slots.sum()) * grid.kc


def check_slot_kernel(torch, poolgrid_slot, nvcc, grid, qpool, params, mode,
                      card_clock):
    """Kernel 1 against slot_plain on the same inputs; returns its record."""
    same, max_err = slot_gap(
        torch, grid, qpool, params, poolgrid_slot.slot_pass(grid, qpool,
                                                            params),
        poolgrid_slot.slot_plain(grid, qpool, params), mode)
    n_valid = int((qpool[:, 3] >= 0).sum())
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
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    scanned = _slot_scanned(torch, grid, qpool)
    issue_ms = _issue_ms(scanned, K1_INSTR_PER_VISIT, card_clock)
    build = _kernel_build(nvcc, "poolgrid_slot",
                          poolgrid_slot.occupancy(QP, grid.kc))
    rec = {"mode": mode, "equal": same, "max_abs_err": max_err,
           "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": n_bytes, "ops": n_ops,
           "valid_queries": n_valid}
    print(f"kernel[slot {mode}]: slots equal on {same:.6f} of {n_valid} "
          f"valid queries, max score gap {max_err}; kernel {kernel_ms:.4f} "
          f"ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by} ({n_bytes / 1e9:.3f} GB, {n_ops / 1e9:.2f} G ops); "
          f"issue ceiling {issue_ms:.4f} ms (computed: the kernel makes "
          f"{scanned / 1e9:.3f} G visits at {K1_INSTR_PER_VISIT} "
          f"instructions; the queries need {n_valid * grid.kc / 1e9:.3f} "
          f"G); {build}; library_ms null: no single PyTorch call computes "
          f"a per-cell packed-key argmin over a gathered candidate row")
    return rec


def headline_pool(np, torch, poolgrid, fused_icp, est, dev):
    """The headline pair on `dev` and its pooled-grid plan for `est`, as
    the pooled paths make them: a dict of the clouds ("tgt", "tn",
    "src", "T_true", and "tgt_d", "tn_d", "src_d" on the card), the
    all-true "mask", "est_code", "plan" and "build", which builds the
    grid."""
    tgt, tn, src, T_true = _headline_clouds(np, N_POINTS)
    h = {"tgt": tgt, "tn": tn, "src": src, "T_true": T_true,
         "tgt_d": torch.as_tensor(tgt, device=dev),
         "tn_d": torch.as_tensor(tn, device=dev),
         "src_d": torch.as_tensor(src, device=dev),
         "mask": torch.ones(N_POINTS, dtype=torch.bool, device=dev)}
    attrs, est_code = fused_icp.make_target_attrs(est, h["tgt_d"],
                                                  h["tn_d"])
    plan = poolgrid.plan_poolgrid(tgt, RADIUS, query_points=src,
                                  est=est_code)

    def build():
        return poolgrid.make_poolgrid(
            h["tgt_d"], attrs, plan["origin"], plan["cell_size"],
            plan["dims"], plan["cap"], plan["kc"], est=est_code,
            tile=plan["tile"], mask=h["mask"],
            active_cells=plan["active_cells"])

    h.update(est_code=est_code, plan=plan, build=build)
    return h


def slot_inputs(np, torch, poolgrid, hp, grid):
    """Kernel 1's inputs on the headline grid: (mode, qpool, params) in
    the Gauss-Newton configuration (identity pose) and in the exact one
    (the true pose)."""
    r2 = torch.tensor(RADIUS, dtype=torch.float32) ** 2
    for mode, T in (("gn", np.eye(4, dtype=np.float32)),
                    ("exact", hp["T_true"])):
        T = torch.as_tensor(T)
        qpool, _, _ = poolgrid.bin_queries_pool(
            hp["src_d"], T, grid.origin, grid.cell_size, grid.dims,
            hp["plan"]["qp"], grid.tile, mask=hp["mask"],
            cell_map=grid.cell_map, n_rank_pad=grid.n_tiles * grid.tile)
        yield mode, qpool, poolgrid.make_params(T, r2, grid)


def evaluate_input(np, torch, rungrid, hp):
    """Kernel 2's correspondence input at the plan evaluate_registration
    makes for the headline pair at the true pose (the grid built as it
    builds it: no attributes, kc = 27 cap rounded up): (plan, grid,
    qsoa, qidx, params)."""
    T_true = hp["T_true"]
    src_true = hp["src"] @ T_true[:3, :3].T + T_true[:3, 3]
    eplan = rungrid.plan_rungrid(hp["tgt"], RADIUS, margin=0.0,
                                 query_points=src_true, nch=0)
    tgt_d, mask = hp["tgt_d"], hp["mask"]
    egrid = rungrid.make_rungrid(
        tgt_d, tgt_d.new_zeros((N_POINTS, 0)), eplan["origin"],
        eplan["cell_size"], eplan["dims"], eplan["cap"], mask=mask)
    src_true_d = torch.as_tensor(src_true, device=tgt_d.device)
    qsoa, qidx = rungrid.bin_queries(
        src_true_d, src_true_d, egrid.origin, egrid.cell_size, egrid.dims,
        eplan["qcap"], mask=mask)
    r2 = torch.tensor(RADIUS, dtype=torch.float32) ** 2
    return eplan, egrid, qsoa, qidx, rungrid.make_params(torch.eye(4), r2,
                                                         egrid)


def fallback_cloud(np, torch, poolgrid, rungrid, est_code, dev):
    """The [0,1.4]^3 cloud, whose pool plan is rejected, and its run
    plan: a dict of the clouds ("tgt", "tn", "src", "T_true", and
    "tgt_d", "tn_d", "src_d" and the source normals "sn_d" on the card)
    and the "plan"."""
    ftgt, ftn, fsrc, fT_true = _headline_clouds(np, N_POINTS,
                                                side=FALLBACK_SIDE)
    if poolgrid.plan_poolgrid(ftgt, RADIUS, query_points=fsrc,
                              est=est_code) is not None:
        raise AssertionError("the fallback cloud's pool plan was accepted")
    fplan = rungrid.plan_rungrid(ftgt, RADIUS, query_points=fsrc, nch=4)
    if fplan is None:
        raise AssertionError("the fallback cloud's run plan was rejected")
    return {"tgt": ftgt, "tn": ftn, "src": fsrc, "T_true": fT_true,
            "tgt_d": torch.as_tensor(ftgt, device=dev),
            "tn_d": torch.as_tensor(ftn, device=dev),
            "src_d": torch.as_tensor(fsrc, device=dev),
            "sn_d": torch.as_tensor(ftn @ fT_true[:3, :3], device=dev),
            "plan": fplan}


def fallback_inputs(torch, rungrid, fused_icp, ET, fb, mask):
    """Kernel 2's Gauss-Newton inputs at the fallback plan: (estimator,
    grid, qsoa, qidx, params) for point-to-point, point-to-plane and
    symmetric."""
    fplan = fb["plan"]
    r2 = torch.tensor(RADIUS, dtype=torch.float32) ** 2
    for est_type in (ET.PointToPoint, ET.PointToPlane, ET.SymmetricMethod):
        fattrs, fcode = fused_icp.make_target_attrs(est_type, fb["tgt_d"],
                                                    fb["tn_d"])
        fgrid = rungrid.make_rungrid(
            fb["tgt_d"], fattrs, fplan["origin"], fplan["cell_size"],
            fplan["dims"], fplan["cap"], mask=mask, est=fcode,
            kc=fplan["kc"])
        sym = est_type == ET.SymmetricMethod
        qsoa, qidx = rungrid.bin_queries(
            fb["src_d"], fb["src_d"], fgrid.origin, fgrid.cell_size,
            fgrid.dims, fplan["qcap"], extra=fb["sn_d"] if sym else None,
            n_extra=3 if sym else 0, mask=mask)
        yield est_type, fgrid, qsoa, qidx, rungrid.make_params(
            torch.eye(4), r2, fgrid)


def _rungrid_need(torch, rungrid, grid, qsoa, qidx, params, dist,
                  words_per_lane, out_bytes, ops_per_lane):
    """(bytes, operations, lanes a valid query scans) that a run-grid
    pass must move and do for this run's data. Lanes are sorted by |c|
    from the cell centre and window w's least |c| is bounds[w], so a
    query at |e| from the centre must look at window w only when
    bounds[w] <= dist + |e|, with `dist` [Cp, qcap] its distance to the
    nearest candidate (clamped to r) for a 1-NN search, or r for the
    truncated moments. Bytes: qidx of every cell; for each cell holding
    a valid query, the windows its farthest-reaching query needs (16
    bytes a lane, plus 4 a word channel) and the cell's window bounds;
    the query rows of the valid queries; the outputs. Operations:
    `ops_per_lane` per (valid query, lane of the windows it needs)."""
    cp, nq, qcap = qsoa.shape
    p = params
    cen = rungrid.cell_centers(grid.dims, p[13:16], p[16], cp)
    q = qsoa[:, :3]
    e = torch.stack([p[3 * i] * q[:, 0] + p[3 * i + 1] * q[:, 1]
                     + p[3 * i + 2] * q[:, 2] + p[9 + i] - cen[:, i, None]
                     for i in range(3)], 1)
    reach = dist + e.norm(dim=1)                              # [cp, qcap]
    valid = qidx >= 0
    windows = torch.where(
        valid, (grid.bounds[:, None, :] <= reach[..., None]).sum(-1), 0)
    n_valid = int(valid.sum())
    busy = int(valid.any(1).sum())
    row_lanes = int(windows.max(1).values.sum()) * rungrid.WINDOW
    lanes = int(windows.sum()) * rungrid.WINDOW
    n_bytes = (qidx.numel() * 4 + row_lanes * (16 + 4 * words_per_lane)
               + busy * grid.n_windows * 4 + n_valid * nq * 4 + out_bytes)
    return n_bytes, lanes * ops_per_lane, lanes / max(n_valid, 1)


def _fused_scanned(torch, rungrid, grid, qsoa, qidx, params):
    """(query, lane) visits kernel 2 makes for this run's data: per cell
    its valid queries sorted by |e|, 8 a warp. A query's gate is open at
    the first window (if the row holds a real lane) and at window
    w while sqrt(min(m + qn, r^2)) + |e| >= bounds[w], with m its least
    score over the windows before w (the gate only closes as w grows); a
    warp scans the windows up to its queries' last open one, for 8 query
    slots (4 when it holds at most 4). The scores repeat the kernel's
    rounding, so the count is the kernel's own."""
    cp, _, qcap = qsoa.shape
    KC, NW, W = grid.kc, grid.n_windows, rungrid.WINDOW
    p = params
    cen = rungrid.cell_centers(grid.dims, p[13:16], p[16], cp)
    prefix = torch.isfinite(grid.bounds).sum(1).clamp(max=1)
    w_idx = torch.arange(NW, device=qsoa.device)
    pad = (-qcap) % 8
    total = 0
    step = max(1, (1 << 28) // (qcap * KC * 4))
    for c0 in range(0, cp, step):
        q = qsoa[c0:c0 + step]
        c = grid.cand[c0:c0 + step]
        cc = cen[c0:c0 + step]
        n = q.shape[0]
        e = [p[3 * i] * q[:, 0] + p[3 * i + 1] * q[:, 1]
             + p[3 * i + 2] * q[:, 2] + p[9 + i] - cc[:, i, None]
             for i in range(3)]
        qn = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
        v = c[:, 3, None, :] + e[0][..., None] * c[:, 0, None, :]
        v = v + e[1][..., None] * c[:, 1, None, :]
        v = v + e[2][..., None] * c[:, 2, None, :]
        wmin = v.view(n, qcap, NW, W).amin(-1)
        del v
        before = torch.cat([torch.full_like(wmin[..., :1], float("inf")),
                            wmin.cummin(-1).values[..., :-1]], -1)
        bestd = torch.sqrt(torch.clamp(torch.minimum(
            before + qn[..., None], p[12]), min=0.0))
        dqc = torch.sqrt(qn)
        closed = (bestd + dqc[..., None] < grid.bounds[c0:c0 + step, None]) \
            & (w_idx >= prefix[c0:c0 + step, None, None])
        own = torch.where(closed.any(-1), closed.int().argmax(-1), NW)
        valid = qidx[c0:c0 + step] >= 0
        order = torch.sort(torch.where(valid, dqc, float("inf")), dim=1,
                           stable=True).indices
        own = torch.nn.functional.pad(
            torch.where(valid, own, 0).gather(1, order), (0, pad))
        cnt = torch.nn.functional.pad(valid.gather(1, order).int(),
                                      (0, pad))
        cnt = cnt.view(n, -1, 8).sum(-1)
        windows = own.view(n, -1, 8).amax(-1)
        slots = torch.where(cnt > 4, 8, torch.where(cnt > 0, 4, 0))
        total += int((windows * slots).sum()) * W
    return total


def fused_corres_gap(torch, d2k, nik, d2p, nip, qidx):
    """(share of valid queries whose -index equals fused_plain's, largest
    d2 gap) of the kernel's correspondences against the plain version's;
    raises unless both agree on which queries found a candidate, >=
    AGREE_MIN of the winners are equal and every d2 lies within 1 ulp."""
    torch.cuda.synchronize()
    valid = qidx >= 0
    if not torch.equal(torch.isfinite(d2k), torch.isfinite(d2p)):
        raise AssertionError("fused corres: kernel and plain disagree on "
                             "which queries found a candidate")
    same = float(((nik == nip) & valid).sum()) / max(int(valid.sum()), 1)
    fin = torch.isfinite(d2p)
    gap = torch.where(fin, (d2k - d2p).abs(), 0.0)
    ulp = torch.nextafter(d2p.abs(), torch.tensor(float("inf"),
                                                  device=d2p.device)) \
        - d2p.abs()
    worst = float(torch.where(fin, gap - ulp, 0.0).max())
    max_err = float(gap.max())
    if same < AGREE_MIN or worst > 0:
        raise AssertionError(f"fused corres: winners equal on {same:.6f}, "
                             f"max d2 gap {max_err} beyond 1 ulp")
    return same, max_err


def fused_gn_gap(fused_icp, est_type, sk, sp):
    """(largest gap of a sum relative to its group's largest magnitude,
    pose-update gap) of the kernel's GN sums `sk` against fused_plain's
    `sp` (on the CPU); raises unless the counts are equal and the gaps
    within GN_REL_TOL and 1e-5."""
    if est_type.name == "PointToPoint":     # count, t, p, t p^T, err
        count, groups = 0, [(1, 4), (4, 7), (7, 16), (16, 17)]
    else:                                   # JTJ, JTr, count, err
        count, groups = 27, [(0, 21), (21, 27), (28, 29)]
    if sk[count] != sp[count] or sp[count] < 1:
        raise AssertionError(f"fused GN ({est_type.name}): counts "
                             f"{float(sk[count])} vs {float(sp[count])}")
    rel = 0.0
    for a, b in groups:
        scale = float(sp[a:b].abs().max())
        rel = max(rel, float((sk[a:b] - sp[a:b]).abs().max()) / scale)
    d_pose = float((fused_icp._update_from_sums(est_type, sk)
                    - fused_icp._update_from_sums(est_type, sp)).abs().max())
    if rel > GN_REL_TOL or d_pose > 1e-5:
        raise AssertionError(f"fused GN ({est_type.name}): sums differ by "
                             f"{rel} of their group, pose updates by "
                             f"{d_pose}")
    return rel, d_pose


def _fused_issue(torch, rungrid, rungrid_fused, nvcc, grid, qsoa, qidx,
                 params, n_ops, corres, card_clock):
    """The text of kernel 2's computed issue ceiling at these inputs and
    of its build (occupancy, ptxas)."""
    scanned = _fused_scanned(torch, rungrid, grid, qsoa, qidx, params)
    issue_ms = _issue_ms(scanned, K2_INSTR_PER_VISIT, card_clock)
    build = _kernel_build(nvcc, "rungrid_fused", rungrid_fused.occupancy(
        qsoa.shape[2], grid.attrp.shape[1], grid.est, corres))
    return (f"issue ceiling {issue_ms:.4f} ms (computed: the kernel scans "
            f"{scanned / 1e9:.3f} G visits at {K2_INSTR_PER_VISIT} "
            f"instructions; the queries need {n_ops / 7 / 1e9:.3f} G); "
            f"{build}")


def check_fused_corres(torch, rungrid, rungrid_fused, nvcc, grid, qsoa,
                       qidx, params, card_clock):
    """Kernel 2 in correspondence mode against fused_plain."""
    d2k, nik = rungrid_fused.fused_query(grid, qsoa, qidx, params, 0, True)
    d2p, nip = rungrid_fused.fused_plain(grid, qsoa, qidx, params, 0, True)
    same, max_err = fused_corres_gap(torch, d2k, nik, d2p, nip, qidx)
    n_valid = int((qidx >= 0).sum())
    ms = _time_ms(torch, lambda: rungrid_fused.fused_query(
        grid, qsoa, qidx, params, 0, True), TIMED_LAUNCHES)
    plain_ms = _time_ms(torch, lambda: rungrid_fused.fused_plain(
        grid, qsoa, qidx, params, 0, True), 3)
    cp, _, qcap = qsoa.shape
    n_bytes, n_ops, lanes = _rungrid_need(
        torch, rungrid, grid, qsoa, qidx, params,
        torch.sqrt(torch.minimum(d2p, params[12])), 1, 2 * cp * qcap * 4, 7)
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    issue = _fused_issue(torch, rungrid, rungrid_fused, nvcc, grid, qsoa,
                         qidx, params, n_ops, True, card_clock)
    print(f"kernel[fused corres]: cells {cp} qcap {qcap} kc {grid.kc}; "
          f"winners equal on {same:.6f} of {n_valid} valid queries, max d2 "
          f"gap {max_err}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e9:.3f} GB, "
          f"{n_ops / 1e9:.2f} G ops, {lanes:.0f} lanes a query); {issue}; "
          f"library_ms null: {NO_LIBRARY}")
    return {"mode": "corres", "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "equal": same}


def check_fused_gn(torch, rungrid, rungrid_fused, fused_icp, nvcc, est_type,
                   grid, qsoa, qidx, params, card_clock):
    """Kernel 2 in Gauss-Newton mode against fused_plain: the count sums
    equal, every other sum within GN_REL_TOL of its group's largest
    magnitude, and the pose updates from both within 1e-5."""
    est = grid.est
    sk = rungrid_fused.fused_query(grid, qsoa, qidx, params, est, False)
    sp = rungrid_fused.fused_plain(grid, qsoa, qidx, params, est, False)
    sk, sp = sk.cpu(), sp.cpu()
    rel, d_pose = fused_gn_gap(fused_icp, est_type, sk, sp)
    ms = _time_ms(torch, lambda: rungrid_fused.fused_query(
        grid, qsoa, qidx, params, est, False), TIMED_LAUNCHES)
    plain_ms = _time_ms(torch, lambda: rungrid_fused.fused_plain(
        grid, qsoa, qidx, params, est, False), 3)
    # the nearest candidate of each query, for the windows it needs
    d2, _ = rungrid_fused.fused_plain(grid, qsoa, qidx, params, 0, True)
    cp, _, qcap = qsoa.shape
    n_bytes, n_ops, lanes = _rungrid_need(
        torch, rungrid, grid, qsoa, qidx, params,
        torch.sqrt(torch.minimum(d2, params[12])), grid.attrp.shape[1],
        rungrid.N_SUMS * 4, 7)
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    issue = _fused_issue(torch, rungrid, rungrid_fused, nvcc, grid, qsoa,
                         qidx, params, n_ops, False, card_clock)
    count = int(sp[0 if est == 1 else 27])
    print(f"kernel[fused gn {est_type.name}]: cells {cp} qcap {qcap} kc "
          f"{grid.kc} P {grid.attrp.shape[1]}; count {count}, sums "
          f"within {rel:.2e} of their group, pose updates within "
          f"{d_pose:.2e}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e9:.3f} GB, "
          f"{n_ops / 1e9:.2f} G ops, {lanes:.0f} lanes a query); {issue}; "
          f"library_ms null: {NO_LIBRARY}")
    return {"mode": f"gn_{est_type.name}", "max_abs_err": float(
        (sk - sp).abs().max()), "rel_err": rel, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def _gmm_scanned(torch, rungrid, grid, qsoa, qidx, params):
    """(query, lane) visits kernel 3 makes: per cell its valid queries
    sorted by |e|, 8 a warp; a warp scans the windows its farthest query
    reaches, for 8 query slots (4 when it holds at most 4 queries)."""
    cp, _, qcap = qsoa.shape
    p = params
    cen = rungrid.cell_centers(grid.dims, p[13:16], p[16], cp)
    q = qsoa[:, :3]
    e = torch.stack([p[3 * i] * q[:, 0] + p[3 * i + 1] * q[:, 1]
                     + p[3 * i + 2] * q[:, 2] + p[9 + i] - cen[:, i, None]
                     for i in range(3)], 1)
    d = torch.where(qidx >= 0, e.norm(dim=1), float("inf"))
    d = torch.sort(d, 1).values
    pad = (-qcap) % 8
    d = torch.nn.functional.pad(d, (0, pad), value=float("inf"))
    g = d.reshape(cp, -1, 8)
    cnt = torch.isfinite(g).sum(-1)                        # [cp, G]
    far = torch.where(torch.isfinite(g), g, 0.0).max(-1).values
    reach = torch.sqrt(p[12]) + far
    windows = (grid.bounds[:, None, :] <= reach[..., None]).sum(-1)
    slots = torch.where(cnt > 4, 8, torch.where(cnt > 0, 4, 0))
    return int((windows * slots).sum()) * rungrid.WINDOW


def gmm_gap(torch, got, want, what="gmm kernel"):
    """Largest gap between moments `got` and gmm_plain's `want`; raises
    where one lies beyond rtol GMM_RTOL, atol GMM_ATOL."""
    torch.cuda.synchronize()
    max_err = 0.0
    for name, a, b in zip(("m0", "m1x", "m1y", "m1z", "m2"), got, want):
        gap = (a - b).abs()
        max_err = max(max_err, float(gap.max()))
        bad = int((gap > GMM_ATOL + GMM_RTOL * b.abs()).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} {name} values beyond "
                                 f"rtol {GMM_RTOL} atol {GMM_ATOL}")
    return max_err


def gmm_case(np, torch, rungrid, rsrc, rtgt, sigma0, dev):
    """Kernel 3's inputs at the FilterReg plan of the pair (rsrc, rtgt)
    at sigma0, as the E-step at the identity gives them: (grid, qsoa,
    qidx, params)."""
    n = len(rtgt)
    trunc = 3.0 * sigma0
    rplan = rungrid.plan_rungrid(rtgt, trunc, margin=0.25,
                                 query_points=rsrc, nch=0)
    rtgt_d = torch.as_tensor(rtgt, device=dev)
    rsrc_d = torch.as_tensor(rsrc, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    grid = rungrid.make_rungrid(
        rtgt_d, rtgt_d.new_zeros((n, 0)), rplan["origin"],
        rplan["cell_size"], rplan["dims"], rplan["cap"], mask=mask)
    print(f"filterreg plan: dims {rplan['dims']} cap {rplan['cap']} kc "
          f"{grid.kc} (plan kc {rplan['kc']}) qcap {rplan['qcap']} "
          f"sigma_initial {sigma0:.6f}")
    qsoa, qidx = rungrid.bin_queries(
        rsrc_d, rsrc_d, grid.origin, grid.cell_size, grid.dims,
        rplan["qcap"], mask=mask)
    params = rungrid.make_params(torch.eye(4), torch.tensor(trunc) ** 2,
                                 grid, inv_2s2=1.0 / (2.0 * sigma0 * sigma0))
    return grid, qsoa, qidx, params


def gmm_tie_case(np, torch, rungrid, dev):
    """Two queries of one cell whose |e| differ by 800 ulp (B in slot 0
    the farther, A in slot 1) and a lane at |c| between r + |e_A| and
    r + |e_B|, on the line through B, with that |c| as its window's
    bound: B reaches the window and A does not, and the lane lies inside
    r of B (weight about exp(-4.5) at trunc = 3 sigma). A kernel that
    took A for the farther query would drop it. (grid, qsoa, qidx,
    params); the cell's centre is the origin of e."""
    f32 = np.float32
    base = int(np.array(0.2, f32).view(np.uint32)) & ~0x3FF
    dA, dB = np.array([base + 100, base + 900], np.uint32).view(f32)
    r = f32(0.1)
    r2 = r * r
    rr = np.sqrt(r2)
    dqA, dqB = np.sqrt(dA * dA), np.sqrt(dB * dB)
    L = rr + (dqA + dqB) / f32(2)
    d2B = ((L * L + dB * (f32(-2) * L)) + f32(0)) + f32(0) + dB * dB
    if not (rr + dqA < L <= rr + dqB and d2B <= r2):
        raise AssertionError("the near-equal |e| case is not built as meant")
    kc, qcap, w = 2 * rungrid.WINDOW, 8, rungrid.WINDOW
    # window 0: 128 lanes within r of both queries, |c| from 0.15 up;
    # window 1: the lane above, then empty lanes
    c = np.concatenate([f32(0.15) + f32(1e-3) * np.arange(w, dtype=f32),
                        [L]]).astype(f32)
    cand = np.zeros((1, 4, kc), f32)
    cand[0, 3] = rungrid.BIG
    cand[0, 0, :w + 1], cand[0, 3, :w + 1] = f32(-2) * c, c * c
    negidx = np.ones((1, kc), f32)
    negidx[0, :w + 1] = -np.arange(w + 1, dtype=f32)
    bounds = np.array([[c[0], L]], f32)
    qsoa = np.zeros((1, 3, qcap), f32)
    qsoa[0, 0, :2] = dB, dA
    qidx = np.full((1, qcap), -1, np.int32)
    qidx[0, :2] = 0, 1
    t = lambda a: torch.as_tensor(a, device=dev)
    grid = rungrid.RunGrid(
        t(cand), t(np.zeros((1, 0, kc), np.int32)), t(negidx), t(bounds),
        t(np.zeros((0, 2), f32)), t(np.full(3, -0.5, f32)),
        t(f32(1.0)), (1, 1, 1), 1, kc, rungrid.EST_NONE)
    sigma = r / f32(3)
    params = rungrid.make_params(torch.eye(4), torch.tensor(r2), grid,
                                 inv_2s2=float(f32(1) / (f32(2) * sigma
                                                         * sigma)))
    return grid, t(qsoa), t(qidx), params


def slot_edge_case(np, seed=5):
    """Kernel 1's built edge cases: one input of three supertiles of 32
    cells, KC 256, QP 128, at the identity pose with key offset 16:
    - "one_cell": supertile 0 holds 100 queries in one cell (13 groups
      of 8, more than one pass of the block's 4 warps);
    - "small_cells": supertile 1 holds cells of 1, 4, 5, 7, 8, 9, 16 and
      33 queries among empty cells, its lanes shuffled;
    - "equal_keys": the 9 queries of that supertile sit on a candidate
      their row holds twice, at slots 4 and 9: the two keys are equal and
      slot 4 must win;
    - "empty_row": the 1-query cell of supertile 1 has a row without a
      real slot: every key is equal and slot 0 must win;
    - "empty_lanes": supertile 2 holds only tag -1 lanes (slot 0).
    Candidates lie on a 1/4 lattice within 0.75 of the cell centre (200
    of a row's slots; the rest empty, c' = 0 and |c|^2 = 3e18, as the
    pooled grid's table holds them) and residuals on a 1/16 lattice, so
    every real slot's score is exact in f32 and in the JAX mirror's bf16
    products, and both order the keys alike. Returns numpy arrays
    {"table" [96, 256, 4], "qpool" [3, 7, 128], "params" [32], "tile",
    "kc", "cap", "parts": {name: (supertile, [QP] bool lanes)}}."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    G, T, KC, QP, n_real = 3, 32, 256, 128, 200
    lattice = np.stack(np.meshgrid(*[np.arange(-3, 4)] * 3, indexing="ij"),
                       -1).reshape(-1, 3).astype(f32) / f32(4)
    table = np.zeros((G * T, KC, 4), f32)
    table[..., 3] = f32(3.0e18)
    for r in range(G * T):
        c = lattice[rng.choice(len(lattice), n_real, replace=False)]
        table[r, :n_real, :3] = f32(-2) * c
        table[r, :n_real, 3] = (c * c).sum(-1)
    qpool = np.zeros((G, 7, QP), f32)
    qpool[:, 3] = -1.0

    def place(g, cell, lanes, e):
        cc = np.array([cell % 4, cell // 4 % 4, cell // 16], f32) + f32(0.5)
        qpool[g, 0:3, lanes] = cc + e          # indexed as [lanes, 3]
        qpool[g, 3, lanes] = cell
        qpool[g, 4:7, lanes] = cc

    def residuals(n):
        return rng.integers(-8, 9, size=(n, 3)).astype(f32) / f32(16)

    parts = {}
    lanes = rng.permutation(QP)
    place(0, 7, lanes[:100], residuals(100))
    parts["one_cell"] = (0, qpool[0, 3] >= 0)
    lanes = rng.permutation(QP)
    at = 0
    for cell, n in ((0, 1), (3, 4), (4, 5), (10, 7), (11, 8), (17, 9),
                    (20, 16), (31, 33)):
        mine = lanes[at:at + n]
        at += n
        if n == 1:
            table[T + cell, :, :3] = 0.0
            table[T + cell, :, 3] = f32(3.0e18)
            parts["empty_row"] = (1, np.isin(np.arange(QP), mine))
        if n == 9:
            # a point the row holds at slots 4 and 9 alone
            p = lattice[rng.integers(len(lattice))]
            row = table[T + cell]
            c = list(row[:n_real, :3] / f32(-2))
            c = [x for x in c if not (x == p).all()]
            c.insert(4, p)
            c.insert(9, p)
            c = np.asarray(c, f32)
            row[:, :3], row[:, 3] = 0.0, f32(3.0e18)
            row[:len(c), :3], row[:len(c), 3] = f32(-2) * c, (c * c).sum(-1)
            place(1, cell, mine, np.repeat(p[None], n, 0))
            parts["equal_keys"] = (1, np.isin(np.arange(QP), mine))
        else:
            place(1, cell, mine, residuals(n))
    parts["small_cells"] = (1, qpool[1, 3] >= 0)
    parts["empty_lanes"] = (2, np.ones(QP, bool))
    params = np.zeros(32, f32)
    params[[0, 4, 8]] = 1.0
    params[12] = 0.01
    params[13] = 16.0
    return {"table": table, "qpool": qpool, "params": params, "tile": T,
            "kc": KC, "cap": 8, "parts": parts}


def slot_edge_grid(torch, poolgrid, case, dev):
    """The port's PoolGrid and the query tensors of `slot_edge_case`:
    (grid, qpool, params) on `dev`."""
    t = lambda a: torch.as_tensor(a, device=dev)
    grid = poolgrid.PoolGrid(
        t(case["table"]), torch.zeros((1, 4), device=dev),
        torch.zeros(3, device=dev), torch.ones((), device=dev),
        t(case["params"][13]), (4, 4, 2 * case["qpool"].shape[0]),
        case["cap"], case["kc"], poolgrid.EST_NONE, case["tile"])
    return grid, t(case["qpool"]), t(case["params"])


def check_slot_edges(torch, poolgrid, poolgrid_slot, np, dev):
    """Kernel 1 on `slot_edge_case` against slot_plain: every slot equal
    (valid lanes and the slot 0 of tag -1 lanes), and slot 4 on the
    equal keys."""
    case = slot_edge_case(np)
    grid, qpool, params = slot_edge_grid(torch, poolgrid, case, dev)
    got = poolgrid_slot.slot_pass(grid, qpool, params)
    want = poolgrid_slot.slot_plain(grid, qpool, params)
    torch.cuda.synchronize()
    g, lanes = case["parts"]["equal_keys"]
    tie = got[g][torch.as_tensor(lanes, device=dev)]
    g0, lanes0 = case["parts"]["empty_row"]
    tie0 = got[g0][torch.as_tensor(lanes0, device=dev)]
    if not torch.equal(got, want) or not bool((tie == 4).all()) \
            or not bool((tie0 == 0).all()):
        bad = {name: int((got[gi] != want[gi])[torch.as_tensor(
            m, device=dev)].sum()) for name, (gi, m) in
            case["parts"].items()}
        raise AssertionError(f"slot kernel on the built cases: slots that "
                             f"differ from slot_plain {bad}; equal keys "
                             f"gave {tie.tolist()} (slot 4 must win), the "
                             f"row without a real slot {tie0.tolist()} (0)")
    print(f"kernel[slot built cases]: {', '.join(case['parts'])}: every "
          f"slot equal to slot_plain, slot 4 wins the equal keys, slot 0 "
          f"the row without a real slot")


def fused_edge_case(np, seed=6):
    """Kernel 2's built edge cases: one run grid of 8 cells (dims 2^3,
    origin -0.5, cell 1, so cell 0's centre is the origin and every other
    centre coordinate is 0 or 1), KC 384 (3 windows), qcap 24, r = 0.1,
    PT2PL words (P 2, fields u * 2^-14 - 1):
    - cell 0, "gate": queries A and B on the x axis, |e| 800 ulp apart
      (B, the farther, in slot 0), 256 lanes on the far side (none within
      r of either) and lane 256 (window 2) at |c| = L on their side, with
      r + |e_A| < L <= r + |e_B|: only B's gate reaches it, and it lies
      within r of B alone;
    - cell 1, "tie_cross": query T1 at e = (1/8, 0, 0) scores the lanes
      c = (1/16, 0, 0) (window 0) and (3/16, 0, 0) (window 1, another
      thread of its group) exactly alike; "tie_thread": query T2 sits on
      a point the row holds twice (lanes 1 and 2, one thread). The tied
      lanes differ in index and in both words; every value is dyadic, so
      the scores are exact;
    - cell 2, "pass": 20 valid queries (more than a pass of 16) among 300
      random candidates within 0.6 of the centre;
    - cell 3: a valid query and a row without a real lane; cell 4: a row
      and no query; cells 5-7 empty.
    Returns numpy arrays {"cand", "attrp", "negidx", "bounds",
    "pack_lohi", "origin", "cell_size", "dims", "kc", "qsoa" [8, 3, 24],
    "qidx" [8, 24], "r2", "ties": {name: (cell, slot, lanes)}}."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    Cp, KC, qcap, W = 8, 384, 24, 128
    dims = (2, 2, 2)
    big = f32(3.0e18)
    cand = np.zeros((Cp, 4, KC), f32)
    cand[:, 3] = big
    negidx = np.ones((Cp, KC), f32)
    attrp = np.zeros((Cp, 2, KC), np.int32)
    bounds = np.full((Cp, KC // W), np.inf, f32)
    qsoa = np.zeros((Cp, 3, qcap), f32)
    qidx = np.full((Cp, qcap), -1, np.int32)
    next_index = [1000]

    def fill_row(cell, pts, index=None, words=None):
        """Candidates `pts` (relative to the centre) of row `cell`,
        sorted by |c| (stably); returns the lane of each input point."""
        pts = np.asarray(pts, f32)
        mag = np.sqrt((pts * pts).sum(-1))
        order = np.argsort(mag, kind="stable")
        n = len(pts)
        if index is None:
            index = np.arange(next_index[0], next_index[0] + n)
            next_index[0] += n
        if words is None:
            words = rng.integers(0, 1 << 15, size=(n, 2, 2))
            words = words[..., 0] | (words[..., 1] << 16)
        p = pts[order]
        cand[cell, :3, :n] = (f32(-2) * p).T
        cand[cell, 3, :n] = (p * p).sum(-1)
        negidx[cell, :n] = -np.asarray(index, f32)[order]
        attrp[cell, :, :n] = np.asarray(words, np.int32)[order].T
        m = mag[order]
        for w in range(KC // W):
            if w * W < n:
                bounds[cell, w] = m[w * W:(w + 1) * W].min()
        lane = np.empty(n, int)
        lane[order] = np.arange(n)
        return lane

    def centre(cell):
        return np.array([cell // 4, cell // 2 % 2, cell % 2], f32)

    ties = {}
    # cell 0: B and A on the x axis, 800 ulp apart in |e|
    base = int(np.array(0.2, f32).view(np.uint32)) & ~0x3FF
    dA, dB = np.array([base + 100, base + 900], np.uint32).view(f32)
    r2 = f32(0.1) * f32(0.1)
    rr = np.sqrt(r2)
    dqA, dqB = np.sqrt(dA * dA), np.sqrt(dB * dB)
    L = rr + (dqA + dqB) / f32(2)
    if not (rr + dqA < L <= rr + dqB and (L - dB) ** 2 <= r2 < (L - dA) ** 2):
        raise AssertionError("the near-equal |e| case is not built as meant")
    far = np.zeros((2 * W, 3), f32)
    far[:, 0] = -(f32(0.15) + f32(5e-4) * np.arange(2 * W, dtype=f32))
    gate_lane = fill_row(0, np.concatenate([far, [[L, 0, 0]]]))[-1]
    qsoa[0, 0, :2] = dB, dA
    qidx[0, :2] = 0, 1
    ties["gate"] = (0, 0, [gate_lane])
    # cell 1: exact ties across windows and threads, and within a thread
    fill_pts = [[0, k / 1024, 0] for k in range(66, 206)] \
        + [[0, 0, -k / 1024] for k in (100, 120, 140, 160)]
    p = [0, 0, 65 / 1024]
    pts = [[0.0625, 0, 0], [0.1875, 0, 0], p, p] + fill_pts
    lo_hi = lambda lo, hi: lo | (hi << 16)
    words = rng.integers(0, 1 << 15, size=(len(pts), 2))
    words = np.asarray([[lo_hi(a, b), lo_hi(b, a)] for a, b in words])
    words[0] = [lo_hi(30000, 5), lo_hi(7, 9)]
    words[1] = [lo_hi(10, 20), lo_hi(20000, 3)]
    words[2] = [lo_hi(5, 31000), lo_hi(1, 1)]
    words[3] = [lo_hi(6, 2), lo_hi(32000, 4)]
    index = [40, 7, 30, 12] + list(range(100, 100 + len(fill_pts)))
    lanes = fill_row(1, pts, index, words)
    if not (lanes[0] // W == 0 and lanes[1] // W == 1
            and lanes[0] % W // 4 % 8 != lanes[1] % W // 4 % 8
            and lanes[2] // 4 == lanes[3] // 4):
        raise AssertionError("the tie case is not built as meant")
    cc = centre(1)
    qsoa[1, :, 3] = cc + f32([0.125, 0, 0])
    qsoa[1, :, 7] = cc + f32(p)
    qidx[1, [3, 7]] = 3, 7
    ties["tie_cross"] = (1, 3, [lanes[0], lanes[1]])
    ties["tie_thread"] = (1, 7, [lanes[2], lanes[3]])
    # cell 2: 20 queries, 300 candidates
    v = rng.normal(size=(300, 3)).astype(f32)
    v *= (f32(0.6) * rng.uniform(size=(300, 1)).astype(f32) ** f32(1 / 3)
          / np.linalg.norm(v, axis=1, keepdims=True))
    fill_row(2, v)
    slots = rng.choice(qcap, 20, replace=False)
    qsoa[2, :, slots] = centre(2) + rng.uniform(
        -0.4, 0.4, size=(20, 3)).astype(f32)
    qidx[2, slots] = 20 + np.arange(20)
    # cell 3: a query and no real lane; cell 4: lanes and no query
    qsoa[3, :, 0] = centre(3) + f32(0.1)
    qidx[3, 0] = 50
    fill_row(4, rng.uniform(-0.5, 0.5, size=(40, 3)))
    pack = np.array([[-1.0, 2.0 ** -14]] * 4, f32)
    return {"cand": cand, "attrp": attrp, "negidx": negidx,
            "bounds": bounds, "pack_lohi": pack,
            "origin": np.full(3, -0.5, f32), "cell_size": f32(1.0),
            "dims": dims, "kc": KC, "qsoa": qsoa, "qidx": qidx, "r2": r2,
            "ties": ties}


def fused_edge_grid(torch, rungrid, case, dev):
    """The port's RunGrid (PT2PL) and query tensors of `fused_edge_case`:
    (grid, qsoa, qidx, params) on `dev`."""
    grid = rungrid.RunGrid.from_numpy(
        case["cand"], case["attrp"], case["negidx"], case["bounds"],
        case["pack_lohi"], case["origin"], case["cell_size"], case["dims"],
        8, case["kc"], rungrid.EST_PT2PL, device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)
    params = rungrid.make_params(torch.eye(4), torch.tensor(case["r2"]), grid)
    return grid, t(case["qsoa"]), t(case["qidx"]), params


def check_fused_edges(np, torch, rungrid, rungrid_fused, dev):
    """Kernel 2 on `fused_edge_case` against fused_plain: corres winners
    and d2 equal (d2 within 1 ulp), the tie queries at the smallest
    index, B alone finding the lane only its gate reaches; GN (PT2PL)
    counts equal and sums within GN_REL_TOL of their group."""
    case = fused_edge_case(np)
    grid, qsoa, qidx, params = fused_edge_grid(torch, rungrid, case, dev)
    d2k, nik = rungrid_fused.fused_query(grid, qsoa, qidx, params, 0, True)
    d2p, nip = rungrid_fused.fused_plain(grid, qsoa, qidx, params, 0, True)
    torch.cuda.synchronize()
    fin = torch.isfinite(d2p)
    ulp = torch.nextafter(d2p.abs(), torch.tensor(float("inf"),
                                                  device=dev)) - d2p.abs()
    gap = torch.where(fin, (d2k - d2p).abs() - ulp, 0.0)
    picks = {name: float(nik[c, s]) for name, (c, s, _) in
             case["ties"].items()}
    want = {name: float(nip[c, s]) for name, (c, s, _) in
            case["ties"].items()}
    if not torch.equal(fin, torch.isfinite(d2k)) or not torch.equal(nik, nip) \
            or float(gap.max()) > 0 or picks != want \
            or picks["tie_cross"] != -7.0 or picks["tie_thread"] != -12.0 \
            or not bool(torch.isinf(d2k[0, 1])):
        raise AssertionError(f"fused corres on the built cases: -index "
                             f"{picks} vs plain {want}, max d2 gap beyond "
                             f"1 ulp {float(gap.max())}")
    sk = rungrid_fused.fused_query(grid, qsoa, qidx, params,
                                   rungrid.EST_PT2PL, False).cpu()
    sp = rungrid_fused.fused_plain(grid, qsoa, qidx, params,
                                   rungrid.EST_PT2PL, False).cpu()
    rel = max(float((sk[a:b] - sp[a:b]).abs().max())
              / float(sp[a:b].abs().max()) for a, b in ((0, 21), (21, 27),
                                                        (28, 29)))
    if sk[27] != sp[27] or rel > GN_REL_TOL:
        raise AssertionError(f"fused GN on the built cases: counts "
                             f"{float(sk[27])} vs {float(sp[27])}, sums "
                             f"within {rel} of their group")
    print(f"kernel[fused built cases]: gate, tie_cross, tie_thread, pass, "
          f"empty rows: corres equal to fused_plain ({picks}); GN count "
          f"{int(sp[27])}, sums within {rel:.2e} of their group")


def check_gmm(torch, rungrid, rungrid_gmm, nvcc, grid, qsoa, qidx, params,
              card_clock):
    """Kernel 3 against gmm_plain (rtol 2e-5, atol 1e-5)."""
    max_err = gmm_gap(torch, rungrid_gmm.gmm_pass(grid, qsoa, qidx, params),
                      rungrid_gmm.gmm_plain(grid, qsoa, qidx, params))
    ms = _time_ms(torch, lambda: rungrid_gmm.gmm_pass(
        grid, qsoa, qidx, params), TIMED_LAUNCHES)
    plain_ms = _time_ms(torch, lambda: rungrid_gmm.gmm_plain(
        grid, qsoa, qidx, params), 3)
    cp, _, qcap = qsoa.shape
    n_bytes, n_ops, lanes = _rungrid_need(
        torch, rungrid, grid, qsoa, qidx, params,
        torch.sqrt(params[12]).expand(cp, qcap), 0, 5 * cp * qcap * 4,
        16)   # 7 for d2, compare, exp, 7 for the moments
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    n_valid = int((qidx >= 0).sum())
    need = n_ops // 16
    scanned = _gmm_scanned(torch, rungrid, grid, qsoa, qidx, params)
    issue_ms = _issue_ms(need, K3_INSTR_PER_VISIT, card_clock)
    build = _kernel_build(nvcc, "rungrid_gmm", rungrid_gmm.occupancy(qcap))
    print(f"kernel[gmm]: cells {cp} qcap {qcap} kc {grid.kc}; {n_valid} "
          f"valid queries need {lanes:.0f} lanes each; max "
          f"gap {max_err}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e9:.3f} GB, "
          f"{n_ops / 1e9:.2f} G ops); issue ceiling {issue_ms:.4f} ms "
          f"(computed: {need / 1e9:.3f} G visits the queries need at "
          f"{K3_INSTR_PER_VISIT} instructions; the kernel scans "
          f"{scanned / 1e9:.3f} G); {build}; library_ms null: {NO_LIBRARY}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _built(torch, rollgrid_nn, what, build):
    """Runs `build` (a roll or cell grid on the card) and prints its time
    and memory: the time of the call, the bytes the grid holds and the
    peak above what was allocated before it, then the same for its lane
    rank (`rollgrid_nn.lane_rank`, part of the build) alone."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    grid = build()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rank = rollgrid_nn.lane_rank(grid.cand_idx)
    torch.cuda.synchronize()
    rank_peak = torch.cuda.max_memory_allocated() - base
    del rank
    rank_ms = _time_ms(torch, lambda: rollgrid_nn.lane_rank(grid.cand_idx),
                       3)
    print(f"build[{what}]: {build_ms:.2f} ms, {held / 1e9:.3f} GB held, "
          f"{peak / 1e9:.3f} GB peak; its lane rank {rank_ms:.3f} ms "
          f"(median of 3 runs after one), {rank_peak / 1e9:.3f} GB peak "
          f"with its {grid.cand_idx.numel() * 2 / 1e9:.3f} GB output")
    return grid


def nn_cases(np, torch, ftgt, fsrc, fT_true, dev):
    """Kernel 4's inputs as the paths give them, one at a time: (mode,
    binned queries, grid, radius) at the roll plan of the [0,1.4]^3
    cloud (ftgt, the source fsrc at the identity and at the true pose
    fT_true) and at the cell plan of the sheet, each grid's build timed
    by `_built`."""
    from cupoch_tpu_torch.knn import cellgrid, poolgrid, rollgrid
    from cupoch_tpu_torch.knn import rollgrid_nn
    roll_plan = rollgrid.plan_rollgrid(ftgt, RADIUS)
    if roll_plan is None:
        raise AssertionError("the fallback cloud's roll plan was rejected")
    ftgt_d = torch.as_tensor(ftgt, device=dev)
    fsrc_d = torch.as_tensor(fsrc, device=dev)
    mask = torch.ones(len(ftgt), dtype=torch.bool, device=dev)
    grid = _built(torch, rollgrid_nn, "roll", lambda: rollgrid.build_rollgrid(
        ftgt_d, roll_plan["origin"], roll_plan["cell_size"],
        roll_plan["dims"], roll_plan["cap"], mask=mask))
    print(f"roll plan: dims {roll_plan['dims']} cap {roll_plan['cap']} kc "
          f"{grid.cand.shape[2]} ({grid.cand.numel() * 4 / 1e9:.3f} GB "
          f"of candidates)")
    for mode, T in (("roll identity", np.eye(4, dtype=np.float32)),
                    ("roll true pose", fT_true)):
        q = fsrc_d @ torch.as_tensor(T[:3, :3].T, device=dev) \
            + torch.as_tensor(T[:3, 3], device=dev)
        yield mode, rollgrid.bin_queries(grid, q)[0], grid, RADIUS
        del q
    del grid
    sheet, _ = _sheet(np)
    sheet_src = sheet + np.float32(SHEET_SHIFT)
    if poolgrid.plan_poolgrid(sheet, SHEET_RADIUS, query_points=sheet_src,
                              est=poolgrid.EST_COLORED) is not None \
            or rollgrid.plan_rollgrid(sheet, SHEET_RADIUS) is not None:
        raise AssertionError("the sheet's pool or roll plan was accepted")
    cplan = cellgrid.plan_cellgrid(sheet, SHEET_RADIUS)
    if cplan is None:
        raise AssertionError("the sheet's cell plan was rejected")
    sheet_d = torch.as_tensor(sheet, device=dev)
    grid = _built(torch, rollgrid_nn, "cell", lambda: cellgrid.build_cellgrid(
        sheet_d, cplan["origin"], cplan["cell_size"], cplan["active"],
        cplan["dims"], cplan["cap"], cplan["n_active"]))
    print(f"cell plan: dims {cplan['dims']} cap {cplan['cap']} active "
          f"{cplan['n_active']} kc {grid.cand.shape[2]}")
    yield ("cell", cellgrid.bin_queries(
        grid, torch.as_tensor(sheet_src, device=dev))[0], grid, SHEET_RADIUS)


def check_nn_reduce(torch, rollgrid_nn, nvcc, q_soa, grid, radius, mode,
                    card_clock):
    """Kernel 4 against nn_reduce_plain on the same binned queries: idx
    equal on every query and d2 bit for bit (both round every operation
    on its own, in one order); failing that, >= 99.99% equal with every
    d2 gap within 1 ulp."""
    cand, cidx, rank = grid.cand, grid.cand_idx, grid.cand_rank
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2
    ik, dk = rollgrid_nn.nn_reduce(q_soa, cand, cidx, r2, rank)
    ip, dp = rollgrid_nn.nn_reduce_plain(q_soa, cand, cidx, r2)
    torch.cuda.synchronize()
    valid = q_soa[:, 0] != QUERY_FILL                       # [C, qcap]
    n_valid = int(valid.sum())
    same = float(((ik == ip) & valid).sum()) / max(n_valid, 1)
    exact = torch.equal(ik, ip) and torch.equal(dk, dp)
    if not torch.equal(torch.isfinite(dk), torch.isfinite(dp)):
        raise AssertionError(f"nn reduce ({mode}): kernel and plain "
                             f"disagree on which queries found a target")
    fin = torch.isfinite(dp)
    gap = torch.where(fin, (dk - dp).abs(), 0.0)
    ulp = torch.nextafter(dp.abs(), torch.tensor(float("inf"),
                                                 device=dp.device)) \
        - dp.abs()
    max_err = float(gap.max())
    if not exact and (same < 0.9999
                      or float(torch.where(fin, gap - ulp, 0.0).max()) > 0):
        raise AssertionError(f"nn reduce ({mode}): winners equal on "
                             f"{same:.6f}, max d2 gap {max_err}")
    ms = _time_ms(torch, lambda: rollgrid_nn.nn_reduce(q_soa, cand, cidx,
                                                       r2, rank),
                  TIMED_LAUNCHES)
    plain_ms = _time_ms(torch, lambda: rollgrid_nn.nn_reduce_plain(
        q_soa, cand, cidx, r2), 2)
    # the nearest library yardstick: cdist over the same [qcap] x [KC]
    # blocks, then the least distance of each query
    qx = q_soa.transpose(1, 2).contiguous()
    cx = cand.transpose(1, 2).contiguous()
    composite_ms = _time_ms(torch, lambda: torch.cdist(qx, cx).min(-1), 3)
    del qx, cx
    # least work for this run's data: a cell holding a valid query reads
    # every lane's index (the 27 runs interleave empty slots with real
    # ones, so no lane can go unread), the coordinates of its real lanes
    # and its query rows; an idle cell reads its first query channel;
    # every cell writes its outputs. 8 f32 operations per (valid query,
    # real lane): an empty lane cannot be the answer.
    C, _, qcap = q_soa.shape
    KC = cand.shape[2]
    busy_cells = valid.any(1)
    busy = int(busy_cells.sum())
    real = (cidx >= 0).sum(1)                                  # [C]
    n_bytes = busy * KC * 4 + int(real[busy_cells].sum()) * 12 \
        + busy * qcap * 12 + (C - busy) * qcap * 4 + C * qcap * 8
    visits = int((valid.sum(1) * real).sum())
    n_ops = visits * 8
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    issue_ms = _issue_ms(visits, K4_INSTR_PER_VISIT, card_clock)
    build = _kernel_build(nvcc, "rollgrid_nn",
                          rollgrid_nn.occupancy(qcap, KC))
    print(f"kernel[nn reduce {mode}]: cells {C} (busy {busy}) qcap {qcap} "
          f"kc {KC}; idx equal on {same:.6f} of {n_valid} valid queries, "
          f"bit for bit {exact}, max d2 gap {max_err}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, cdist+min composite {composite_ms:.3f} "
          f"ms, bound {bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e9:.3f} "
          f"GB, {n_ops / 1e9:.2f} G ops); issue ceiling {issue_ms:.4f} ms "
          f"(computed: {visits / 1e9:.3f} G visits at {K4_INSTR_PER_VISIT} "
          f"instructions); {build}; library_ms null: {NO_LIBRARY_NN}")
    return {"mode": mode, "equal": same, "bit_exact": exact,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "composite_ms": composite_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": n_bytes, "ops": n_ops,
            "valid_queries": n_valid, "busy_cells": busy}


def bruteforce_cases(np, torch, dev):
    """(level, queries, data, mask, nq, nd) at KinFu's BF_LEVELS: frame
    3's surface onto frame 4's, every 53rd query on a target point and
    every 97th target point again at the end (ties the least index must
    win), both padded to `registration_icp`'s bucket size; the mask
    keeps the target points and drops the padding, as the ICP loop's
    does."""
    from cupoch_tpu_torch.utility.shape import bucket_size, pad_axis0
    for level in BF_LEVELS:
        src = rendered_surface(np, 3, level)
        tgt = rendered_surface(np, 4, level)
        tgt = np.concatenate([tgt, tgt[::97]])
        src[::53] = tgt[:len(src[::53])]
        nq, nd = len(src), len(tgt)
        q = pad_axis0(torch.as_tensor(src), bucket_size(nq)).to(dev)
        d = pad_axis0(torch.as_tensor(tgt), bucket_size(nd)).to(dev)
        mask = torch.arange(d.shape[0], device=dev) < nd
        yield level, q, d, mask, nq, nd


def check_bruteforce_nn(np, torch, bruteforce, nvcc, level, q, d, mask, nq,
                        nd, card_clock):
    """The brute-force 1-NN kernel against nn_search_plain on the same
    card tensors, bit for bit: over the valid prefixes with the loop's
    mask and with a scattered one (a fifth of the points dropped), and
    over the whole padded clouds with the loop's mask. Then its time,
    the plain version's, cdist + argmin's, and its bound for this run's
    pairs."""
    rng = np.random.default_rng(17 + level)
    scattered = mask & torch.as_tensor(
        rng.uniform(size=d.shape[0]) > 0.2, device=d.device)
    max_err = 0.0
    for name, m in (("loop's mask", mask), ("scattered mask", scattered)):
        got = bruteforce.nn_search(q, d, data_mask=m, n_queries=nq,
                                   n_data=nd)
        want = bruteforce.nn_search_plain(q, d, m, nq, nd)
        torch.cuda.synchronize()
        fin = torch.isfinite(want[1])
        max_err = max(max_err, float(torch.where(
            fin, (got[1] - want[1]).abs(), 0.0).max()))
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(
                f"bruteforce_nn level {level}, {name}: "
                f"{int((got[0] != want[0]).sum())} indices and "
                f"{int((got[1] != want[1]).sum())} distances differ from "
                f"nn_search_plain")
        if not (bool((got[0][nq:] == -1).all())
                and bool(torch.isinf(got[1][nq:]).all())):
            raise AssertionError(f"bruteforce_nn level {level}, {name}: a "
                                 f"query past the count found a point")
    idx, d2 = bruteforce.nn_search(q, d, data_mask=mask, n_queries=nq,
                                   n_data=nd)
    full = bruteforce.nn_search(q, d, data_mask=mask)
    on = torch.arange(0, nq, 53, device=q.device)
    torch.cuda.synchronize()
    if not (torch.equal(full[0][:nq], idx[:nq])
            and torch.equal(full[1][:nq], d2[:nq])):
        raise AssertionError(f"bruteforce_nn level {level}: the padded call "
                             f"disagrees with the counted one")
    if not (bool((d2[on] == 0).all())
            and torch.equal(idx[on], torch.arange(len(on), device=q.device,
                                                  dtype=torch.int32))):
        raise AssertionError(f"bruteforce_nn level {level}: a query on a "
                             f"target point missed it or took a later copy")
    ms = _time_ms(torch, lambda: bruteforce.nn_search(
        q, d, data_mask=mask, n_queries=nq, n_data=nd), TIMED_LAUNCHES)
    plain_ms = _time_ms(torch, lambda: bruteforce.nn_search_plain(
        q, d, mask, nq, nd), 3)
    qv, dv = q[:nq].contiguous(), d[:nd].contiguous()
    library_ms = _time_ms(torch, lambda: [
        torch.cdist(qv[i:i + BF_LIBRARY_TILE], dv).argmin(-1)
        for i in range(0, nq, BF_LIBRARY_TILE)], 5)
    del qv, dv
    # least work: each valid (query, point) pair's 8 operations; the
    # bytes are the two clouds, the mask and the outputs
    pairs = nq * nd
    n_ops = pairs * BF_OPS_PER_PAIR
    n_bytes = (nq + nd) * 12 + nd + q.shape[0] * 8
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    issue_ms = _issue_ms(pairs, BF_INSTR_PER_PAIR, card_clock)
    ptxas = " | ".join(ln.strip().replace("ptxas info    : ", "")
                       for ln in nvcc.build_logs.get("bruteforce_nn", "")
                       .splitlines() if "Used" in ln or "spill" in ln) \
        or "cached"
    print(f"kernel[bruteforce_nn level {level}]: {nq} queries (padded "
          f"{q.shape[0]}) on {nd} points (padded {d.shape[0]}), "
          f"{pairs / 1e9:.3f} G pairs; bit for bit with nn_search_plain "
          f"under the loop's and a scattered mask, the padded call equal; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, library "
          f"{library_ms:.3f} ms ({BF_LIBRARY}), bound {bound_ms:.4f} ms by "
          f"{bound_by} ({n_ops / 1e9:.2f} G ops), issue ceiling "
          f"{issue_ms:.4f} ms (computed: {BF_INSTR_PER_PAIR} instructions "
          f"a pair); ptxas: {ptxas}")
    return {"level": level, "queries": nq, "points": nd, "pairs": pairs,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "issue_ms": issue_ms}


def raycast_volume(np, torch, ctt, dev):
    """KinFu's volume (`kinfu_config`) on `dev`, integrated from the
    trajectory's first RAYCAST_FRAMES frames at their true poses, and
    the 640x480 intrinsics."""
    intr, opt = kinfu_config(ctt)
    vol = ctt.integration.UniformTSDFVolume(
        opt.tsdf_length, opt.tsdf_resolution, opt.sdf_trunc,
        opt.tsdf_color_type, opt.tsdf_origin, device=dev)
    for k in range(RAYCAST_FRAMES):
        c, d = room_frame(np, ctt, k, intr, dev)
        vol.integrate(ctt.geometry.RGBDImage.create_from_color_and_depth(
            c, d, convert_rgb_to_intensity=False), intr,
            np.linalg.inv(rgbd_pose(np, k)).astype(np.float32))
    return vol, intr


def raycast_args(np, torch, vol, intr, pose, max_steps=None):
    """`tsdf_ops.raycast`'s arguments for `vol` seen through `intr` from
    the camera-to-world `pose`, as `UniformTSDFVolume.raycast` and KinFu
    make them (max_steps None: the volume's own count)."""
    extrinsic = np.linalg.inv(pose).astype(np.float32)
    cam = np.linalg.inv(extrinsic).astype(np.float32)
    if max_steps is None:
        max_steps = int(np.ceil(vol.length * np.sqrt(3.0)
                                / (0.5 * vol.sdf_trunc))) + 1
    return (vol.tsdf, vol.weight, vol.color,
            torch.as_tensor(np.asarray(intr.intrinsic_matrix, np.float32),
                            device=vol.device),
            torch.as_tensor(cam, device=vol.device), vol.voxel_length,
            vol.sdf_trunc, vol._corner(), intr.height, intr.width,
            max_steps)


def raycast_equal(torch, got, want):
    """Whether two raycasts' points, normals and colours are equal bit
    for bit (NaN where there is no hit, so compared as int32) and their
    steps equal."""
    return got[3] == want[3] and all(
        torch.equal(g.view(torch.int32), w.view(torch.int32))
        for g, w in zip(got[:3], want[:3]))


def march_work(torch, tsdf_ops, args):
    """(march steps over every ray, rays the march finds a hit on, the
    steps the plain march reports) of raycast arguments `args`: each ray
    counted up to its own stop under `raycast_plain`'s march rule, for
    the raycast's byte count."""
    tsdf, _, _, K, cam, vl, trunc, origin, H, W, max_steps = args
    R = tsdf.shape[0]
    dirs, _, rel_o, _, inv_vl, t_far, ray0, step = tsdf_ops._rays(
        K, cam, vl, trunc, origin, R, H, W)
    flat = tsdf.reshape(-1)

    def nearest(s):
        gi = torch.floor((rel_o + dirs * s[..., None]) * inv_vl) \
            .to(torch.int64)
        inb = ((gi >= 1) & (gi < R - 1)).all(-1)
        gi = gi.clamp(0, R - 1)
        return flat[(gi[..., 0] * R + gi[..., 1]) * R + gi[..., 2]], inb

    f, inb = nearest(ray0)
    f = torch.where(inb, f, 0.0)
    stopped = torch.zeros((H, W), dtype=torch.bool, device=tsdf.device)
    found = torch.zeros_like(stopped)
    taken = torch.zeros((H, W), dtype=torch.int64, device=tsdf.device)
    slowest = max_steps + 1
    for i in range(max_steps):
        ray_len = ray0 + float(i) * step
        f_new, inb = nearest(ray_len + step)
        taken += ~stopped
        live_in = ~stopped & inb
        hit = live_in & (f > 0.0) & (f_new < 0.0)
        found |= hit
        stopped |= hit | (live_in & (f < 0.0) & (f_new > 0.0)) \
            | (ray_len >= t_far)
        f = torch.where(inb, f_new, f)
        if bool(stopped.all()):
            slowest = i + 1
            break
    return (int(taken.sum()), int(found.sum()),
            tsdf_ops.march_steps(slowest, max_steps))


def check_tsdf_raycast(np, torch, ctt, tsdf_ops, nvcc, dev):
    """The raycast kernel against raycast_plain on the same card tensors,
    bit for bit, at KinFu's four level shapes on `raycast_volume`; then
    at each level the kernel's time alone, the wrapper's (set-up, the
    launch, the 4-byte read and the tail), the plain version's, and the
    bound of this run's bytes. Returns a record a level."""
    vol, intr = raycast_volume(np, torch, ctt, dev)
    pose = rgbd_pose(np, RAYCAST_FRAMES)
    recs = []
    for level in RAYCAST_LEVELS:
        args = raycast_args(np, torch, vol, intr.scale(0.5 ** level), pose)
        before = tsdf_ops.launches
        got = tsdf_ops.raycast(*args)
        want = tsdf_ops.raycast_plain(*args)
        torch.cuda.synchronize()
        if tsdf_ops.launches != before + 1:
            raise AssertionError(f"tsdf_raycast level {level}: "
                                 f"{tsdf_ops.launches - before} launches")
        if not raycast_equal(torch, got, want):
            differ = [int((g.view(torch.int32) != w.view(torch.int32))
                          .any(-1).sum()) for g, w in zip(got[:3], want[:3])]
            raise AssertionError(
                f"tsdf_raycast level {level}: steps {got[3]} / {want[3]}; "
                f"points, normals, colours differ on {differ} rays")
        taken, march_hits, steps = march_work(torch, tsdf_ops, args)
        if steps != got[3]:
            raise AssertionError(f"tsdf_raycast level {level}: the march "
                                 f"rule gives {steps} steps, the kernel "
                                 f"{got[3]}")
        hits = int(torch.isfinite(got[0]).all(-1).sum())
        H, W = args[8], args[9]
        rays = tsdf_ops._rays(*args[3:8], vol.resolution, H, W)
        ms = _time_ms(torch, lambda: tsdf_ops._launch(
            vol.tsdf, vol.weight, vol.color, rays, args[7], args[10]),
            TIMED_LAUNCHES)
        wrapper_ms = _time_ms(torch, lambda: tsdf_ops.raycast(*args),
                              TIMED_LAUNCHES)
        plain_ms = _time_ms(torch, lambda: tsdf_ops.raycast_plain(*args), 3)
        n_bytes = (4 * taken + RAYCAST_REFINE_BYTES * march_hits
                   + RAYCAST_HIT_BYTES * hits + RAYCAST_RAY_BYTES * H * W)
        bound_ms, bound_by = _bound(n_bytes, 0)
        ptxas = " | ".join(ln.strip().replace("ptxas info    : ", "")
                           for ln in nvcc.build_logs.get("tsdf_raycast", "")
                           .splitlines() if "Used" in ln or "spill" in ln) \
            or "cached"
        print(f"kernel[tsdf_raycast level {level}]: {W}x{H} rays on a "
              f"{vol.resolution}^3 volume, {hits} hits ({march_hits} in the "
              f"march), {taken / (H * W):.1f} march steps a ray, {steps} "
              f"steps reported; bit for bit with raycast_plain; kernel "
              f"{ms:.4f} ms, wrapper {wrapper_ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({n_bytes / 1e6:.2f} MB); ptxas: {ptxas}")
        recs.append({"level": level, "rays": H * W, "hits": hits,
                     "march_steps": taken, "steps": steps,
                     "max_abs_err": 0.0, "ms": ms, "wrapper_ms": wrapper_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
    del vol
    return recs


def grid_cache_report(rungrid, phase):
    """Print what the k-NN grid cache (`knn_search_grid`) did in `phase`
    in this process, then start the next phase's count."""
    st = rungrid.grid_cache_stats
    print(f"grid cache, {phase}: {st['hits']} hits (the oldest with "
          f"{st['oldest_hit']} grids stored after it), {st['stored']} grids "
          f"stored, {st['evicted']} evicted, {st['refused']} refused (over "
          f"the budget alone), at most {st['max_grids']} grids "
          f"and {st['max_bytes'] / 2**20:.1f} MiB held, the largest grid "
          f"{st['max_grid_bytes'] / 2**20:.1f} MiB (budget "
          f"{rungrid._GRID_CACHE_BYTES / 2**20:.0f} MiB)")
    rungrid.reset_grid_cache_stats()


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs an NVIDIA GPU")
    import cupoch_tpu_torch as ctt
    from cupoch_tpu_torch.integration import tsdf_ops
    from cupoch_tpu_torch.knn import (bruteforce, poolgrid, poolgrid_slot,
                                      rollgrid, rollgrid_nn, rungrid,
                                      rungrid_fused, rungrid_gmm)
    from cupoch_tpu_torch.registration import fused_icp
    from cupoch_tpu_torch.registration.estimation import (
        TransformationEstimationType,
    )
    from cupoch_tpu_torch.utility import nvcc

    from cupoch_tpu_torch.parallel.launch import (
        launch_counts as counts, reset_launch_counts as reset_counts)

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    card_clock = (torch.cuda.get_device_properties(0).multi_processor_count,
                  max_mhz * 1e6)
    print(f"card: {card_clock[0]} SMs, maximum SM clock {max_mhz:.0f} MHz")
    t_start = time.perf_counter()

    # 2. build
    t0 = time.perf_counter()
    libs = nvcc.build_all()
    build_s = time.perf_counter() - t0
    for name in libs:
        ptxas = [ln.strip() for ln in nvcc.build_logs.get(name, "")
                 .splitlines() if "Used" in ln or "spill" in ln]
        print(f"build: {name} in {build_s:.2f} s (all sources at once); "
              f"ptxas: {' | '.join(ptxas) or 'cached'}")

    # 3a. kernel 1 against its plain version at the headline shapes,
    # and on its built edge cases
    est = TransformationEstimationType.PointToPlane
    hp = headline_pool(np, torch, poolgrid, fused_icp, est, dev)
    tgt, tn, src, T_true = hp["tgt"], hp["tn"], hp["src"], hp["T_true"]
    tgt_d, tn_d, src_d, mask = hp["tgt_d"], hp["tn_d"], hp["src_d"], \
        hp["mask"]
    plan, build, est_code = hp["plan"], hp["build"], hp["est_code"]
    grid = build()
    print(f"plan: dims {plan['dims']} cap {plan['cap']} kc {plan['kc']} "
          f"qp {plan['qp']} tile {plan['tile']} supertiles {grid.n_tiles} "
          f"compact {plan['active_cells'] is not None}; table "
          f"{tuple(grid.table.shape)}")
    r2 = torch.tensor(RADIUS, dtype=torch.float32) ** 2
    records = [check_slot_kernel(torch, poolgrid_slot, nvcc, grid, qpool,
                                 params, mode, card_clock)
               for mode, qpool, params in slot_inputs(np, torch, poolgrid,
                                                      hp, grid)]
    del grid
    check_slot_edges(torch, poolgrid, poolgrid_slot, np, dev)

    # 3b. kernel 2, correspondence mode, at evaluate_registration's plan
    # for the headline pair at the true pose
    eplan, egrid, qsoa, qidx, eparams = evaluate_input(np, torch, rungrid,
                                                       hp)
    print(f"evaluate plan: dims {eplan['dims']} cap {eplan['cap']} kc "
          f"{egrid.kc} (plan kc {eplan['kc']}) qcap {eplan['qcap']}")
    fused_recs = [check_fused_corres(torch, rungrid, rungrid_fused, nvcc,
                                     egrid, qsoa, qidx, eparams, card_clock)]
    # the target points this grid holds (the rest it dropped at its cell
    # cap); evaluate_registration builds the same grid from the same
    # target below
    held = np.zeros(N_POINTS, bool)
    ni = egrid.negidx[egrid.negidx <= 0]
    held[(-ni).long().cpu().numpy()] = True
    del egrid, qsoa, qidx, ni

    # 3c. kernel 2, Gauss-Newton mode, at the run-grid ICP fallback's plan,
    # and both modes on the built edge cases
    fb = fallback_cloud(np, torch, poolgrid, rungrid, est_code, dev)
    ftgt, ftn, fsrc, fT_true = fb["tgt"], fb["tn"], fb["src"], fb["T_true"]
    ftgt_d, ftn_d, fsrc_d, fsn_d = fb["tgt_d"], fb["tn_d"], fb["src_d"], \
        fb["sn_d"]
    fplan = fb["plan"]
    print(f"fallback plan: dims {fplan['dims']} cap {fplan['cap']} kc "
          f"{fplan['kc']} qcap {fplan['qcap']}")
    for est_type, fgrid, qsoa, qidx, fparams in fallback_inputs(
            torch, rungrid, fused_icp, TransformationEstimationType, fb,
            mask):
        fused_recs.append(check_fused_gn(
            torch, rungrid, rungrid_fused, fused_icp, nvcc, est_type, fgrid,
            qsoa, qidx, fparams, card_clock))
        del fgrid, qsoa, qidx
    check_fused_edges(np, torch, rungrid, rungrid_fused, dev)

    # 3d. kernel 3 at the FilterReg plan, and on two queries whose |e|
    # differ in their last bits
    rsrc, rtgt, sigma0, rT_true = _filterreg_pair(np, N_POINTS)
    rgrid, qsoa, qidx, gparams = gmm_case(np, torch, rungrid, rsrc, rtgt,
                                          sigma0, dev)
    gmm_rec = check_gmm(torch, rungrid, rungrid_gmm, nvcc, rgrid, qsoa,
                        qidx, gparams, card_clock)
    del rgrid, qsoa, qidx, gparams
    tie = gmm_tie_case(np, torch, rungrid, dev)
    tie_gap = gmm_gap(torch, rungrid_gmm.gmm_pass(*tie),
                      rungrid_gmm.gmm_plain(*tie),
                      "gmm kernel, near-equal |e|")
    print(f"kernel[gmm near-equal |e|]: 2 queries 800 ulp apart in |e|, a "
          f"lane only the farther reaches; max gap {tie_gap}")
    rtgt_d = torch.as_tensor(rtgt, device=dev)
    rsrc_d = torch.as_tensor(rsrc, device=dev)

    # 3e. kernel 4 at the roll plan of the fallback cloud, at the identity
    # and at the true pose, and at the cell plan of the sheet
    nn_recs = [check_nn_reduce(torch, rollgrid_nn, nvcc, q_soa, grid, radius,
                               mode, card_clock)
               for mode, q_soa, grid, radius in nn_cases(
                   np, torch, ftgt, fsrc, fT_true, dev)]
    # 3f. the brute-force 1-NN kernel at KinFu's level shapes
    bf_recs = [check_bruteforce_nn(np, torch, bruteforce, nvcc, *case,
                                   card_clock)
               for case in bruteforce_cases(np, torch, dev)]
    # 3g. the raycast kernel at KinFu's four level shapes
    rc_recs = check_tsdf_raycast(np, torch, ctt, tsdf_ops, nvcc, dev)
    roll_plan = rollgrid.plan_rollgrid(ftgt, RADIUS)
    sheet, sheet_n = _sheet(np)
    sheet_src = sheet + np.float32(SHEET_SHIFT)
    sheet_d = torch.as_tensor(sheet, device=dev)
    sheet_src_d = torch.as_tensor(sheet_src, device=dev)

    # 4. paths, through the public entries
    source = ctt.geometry.PointCloud(src_d)
    target = ctt.geometry.PointCloud(tgt_d)
    target.normals = tn_d
    crit = ctt.registration.ICPConvergenceCriteria(REL_TOL, REL_TOL, ITERS)
    pt2pl = ctt.registration.TransformationEstimationPointToPlane()
    path_counts = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = ctt.registration.registration_icp(source, target, RADIUS,
                                            estimation=pt2pl, criteria=crit)
    reg_s = time.perf_counter() - t0
    path_counts["registration_icp pooled"] = counts()
    launches = poolgrid_slot.launches
    pose_err = float(np.abs(res.transformation - T_true).max())
    print(f"path: registration_icp pt2pl {N_POINTS} points (pooled grid): "
          f"fitness {res.fitness:.6f} rmse {res.inlier_rmse:.6e} iterations "
          f"{res.iterations} pose error {pose_err:.3e} launches "
          f"{path_counts['registration_icp pooled']} dropped target "
          f"{res.n_dropped_target} queries {res.n_dropped_queries}; "
          f"{reg_s:.3f} s with the host plan")
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

    build_s, grid = timed(build)
    loop_s, out = timed(lambda: loop(grid))
    it = out[4]
    frame_s = build_s + loop_s
    print(f"timing: secs_per_frame {frame_s:.4f} grid_build_s "
          f"{build_s:.4f} icp_loop_s {loop_s:.4f} pass_ms "
          f"{loop_s / max(it, 1) * 1e3:.3f} iterations {it} on {card}")
    profile(torch, "pooled ICP loop", lambda: loop(grid), loop_s)
    del grid

    # evaluate_registration at the true pose, then at the ICP result's
    # pose against that result's correspondences
    reset_counts()
    t0 = time.perf_counter()
    ev = ctt.registration.evaluate_registration(source, target, RADIUS,
                                                T_true)
    ev_s = time.perf_counter() - t0
    path_counts["evaluate_registration"] = counts()
    ev2 = ctt.registration.evaluate_registration(source, target, RADIUS,
                                                 res.transformation)
    agree, nearer = _nearer_agreement(np, src, tgt, res.transformation,
                                      ev2.correspondence_set,
                                      res.correspondence_set, held)
    print(f"path: evaluate_registration {N_POINTS} points at the true pose: "
          f"fitness {ev.fitness:.6f} rmse {ev.inlier_rmse:.6e} launches "
          f"{path_counts['evaluate_registration']}; {ev_s:.3f} s with the "
          f"host plan; at the ICP pose its correspondences agree with "
          f"registration_icp's on {agree:.6f} of rows; where they differ "
          f"its pick is the nearer one, or the pooled pick is a target its "
          f"grid dropped, on {nearer:.6f}; it holds {int(held.sum())} of "
          f"{N_POINTS} targets")
    if ev.fitness < 0.999 or ev.inlier_rmse > EVAL_RMSE_MAX \
            or agree < 0.99 or nearer < 1.0:
        raise AssertionError("evaluate_registration missed its bounds")
    if path_counts["evaluate_registration"]["fused_corres"] != 1 \
            or path_counts["evaluate_registration"]["fused_gn"] != 0:
        raise AssertionError("evaluate_registration must make exactly one "
                             "correspondence launch")
    del source, target, tgt_d, tn_d, src_d

    # the run-grid ICP fallback through the public entry
    fsource = ctt.geometry.PointCloud(fsrc_d)
    ftarget = ctt.geometry.PointCloud(ftgt_d)
    ftarget.normals = ftn_d
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fres = ctt.registration.registration_icp(
        fsource, ftarget, RADIUS, estimation=pt2pl, criteria=crit)
    freg_s = time.perf_counter() - t0
    path_counts["registration_icp fallback"] = c = counts()
    fpose_err = float(np.abs(fres.transformation - fT_true).max())
    print(f"path: registration_icp pt2pl {N_POINTS} points in "
          f"[0,{FALLBACK_SIDE}]^3 (run-grid fallback): fitness "
          f"{fres.fitness:.6f} rmse {fres.inlier_rmse:.6e} iterations "
          f"{fres.iterations} pose error {fpose_err:.3e} launches {c}; "
          f"{freg_s:.3f} s with the host plan and the grid build")
    if fpose_err > POSE_TOL or fres.fitness < 0.99:
        raise AssertionError("the run-grid fallback missed its bounds")
    if c["fused_gn"] != fres.iterations or c["fused_corres"] != 1 \
            or c["slot"] != 0:
        raise AssertionError(f"fallback launches {c} for "
                             f"{fres.iterations} iterations")
    fattrs, fcode = fused_icp.make_target_attrs(est, ftgt_d, ftn_d)

    def fbuild():
        return rungrid.make_rungrid(
            ftgt_d, fattrs, fplan["origin"], fplan["cell_size"],
            fplan["dims"], fplan["cap"], mask=mask, est=fcode,
            kc=fplan["kc"])

    def floop(g):
        out = fused_icp.icp_core_rungrid(
            fsrc_d, mask, fsn_d, g, torch.eye(4), RADIUS,
            fplan["rebin_margin"], REL_TOL, REL_TOL, fplan["qcap"], est,
            ITERS)
        torch.cuda.synchronize()
        return out

    fbuild_s, fgrid = timed(fbuild)
    floop_s, out = timed(lambda: floop(fgrid))
    print(f"timing: fallback secs_per_frame {fbuild_s + floop_s:.4f} "
          f"grid_build_s {fbuild_s:.4f} icp_loop_s {floop_s:.4f} pass_ms "
          f"{floop_s / max(out[4], 1) * 1e3:.3f} iterations {out[4]} on "
          f"{card}")
    profile(torch, "run-grid ICP loop", lambda: floop(fgrid), floop_s)
    del fgrid, fsource, ftarget

    # registration_filterreg on the scaled FilterReg pair
    rsource = ctt.geometry.PointCloud(rsrc_d)
    rtarget = ctt.geometry.PointCloud(rtgt_d)
    fr_opt = ctt.registration.FilterRegOption(sigma_initial=sigma0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rres = ctt.registration.registration_filterreg(rsource, rtarget,
                                                   option=fr_opt)
    fr_s = time.perf_counter() - t0
    path_counts["registration_filterreg"] = c = counts()
    t_err = float(np.abs(rres.transformation[:3, 3] - rT_true[:3, 3]).max())
    r_err = float(np.abs(rres.transformation[:3, :3] - np.eye(3)).max())
    # an E-step per EM iteration, plus the one whose likelihood check
    # stopped a loop that converged before max_iteration
    e_steps = rres.iterations + (rres.iterations < fr_opt.max_iteration)
    print(f"path: registration_filterreg {N_POINTS} points (grid E-step): "
          f"iterations {rres.iterations} likelihood {rres.likelihood:.6e} "
          f"translation error {t_err:.3e} rotation error {r_err:.3e} "
          f"launches {c}; {fr_s:.3f} s with the host plan and the grid "
          f"build")
    if t_err > 1e-3 or r_err > 4e-3:
        raise AssertionError("registration_filterreg missed its bounds")
    if c["gmm"] != e_steps or c["fused_gn"] or c["fused_corres"]:
        raise AssertionError(f"filterreg launches {c} for {e_steps} "
                             f"E-steps")

    def freg():
        out = ctt.registration.registration_filterreg(rsource, rtarget,
                                                      option=fr_opt)
        torch.cuda.synchronize()
        return out

    freg_call_s, _ = timed(freg, reps=1)
    profile(torch, "registration_filterreg, host plan and grid build "
            "included", freg, freg_call_s)
    del rsource, rtarget, rtgt_d, rsrc_d

    colored_gicp_paths(np, torch, ctt, rollgrid, reset_counts, counts,
                       path_counts, timed, crit, card, roll_plan,
                       (ftgt, ftn, fsrc, fT_true), (tgt, tn, src, T_true),
                       (sheet, sheet_n, sheet_src))
    del ftgt_d, ftn_d, fsrc_d, fsn_d, sheet_d, sheet_src_d

    small_inputs(np, ctt, poolgrid, rungrid, tgt, tn, src, T_true, crit,
                 pt2pl)
    del tgt, tn, src, ftgt, ftn, fsrc, sheet, sheet_n, sheet_src
    grid_cache_report(rungrid, "phases 3-4")
    # 4g. global registration
    global_registration(np, torch, ctt, reset_counts, counts, path_counts,
                        card)
    grid_cache_report(rungrid, "phase 4g")
    # 4k. RGB-D odometry and KinectFusion
    rgbd_phase(np, torch, ctt, reset_counts, counts, path_counts, card)
    grid_cache_report(rungrid, "phase 4k")
    # 4r. occupancy mapping, distance field, planning and collisions
    robotics_phase(np, torch, ctt, reset_counts, counts, path_counts, card)
    grid_cache_report(rungrid, "phase 4r")
    # 4s. scalable volume, mesh operations, stereo, files and the ATE
    mesh = reconstruct_phase(np, torch, ctt, reset_counts, counts,
                             path_counts, card)
    grid_cache_report(rungrid, "phase 4s")
    # 4v. colour maps, views, the HTML export and the benchmark harness
    vis_phase(np, torch, ctt, reset_counts, counts, path_counts, card, mesh)
    grid_cache_report(rungrid, "phase 4v")
    del mesh
    # 4m. the sharded ICP loops, the SLAM backend and the scaling bench
    # over 1, 2 and 4 ranks
    multi_phase(np, torch, ctt, reset_counts, counts, path_counts, card,
                refs=(res, fres))
    grid_cache_report(rungrid, "phase 4m, this process's ranks")

    # 5. per-kernel numbers, then the result
    print(json.dumps({"path_launches": path_counts,
                      "seconds": time.perf_counter() - t_start}))
    gn, exact = records   # one f32 kernel: both modes time alike
    pl = next(r for r in fused_recs if r["mode"] == "gn_PointToPlane")
    # each kernel's launches over every path of phase 4
    total = {k: sum(c[k] for c in path_counts.values()) for k in counts()}
    print(json.dumps({"kernels": [{
        "name": "poolgrid_slot",
        "route": "cuda",
        "source": "cupoch_tpu_torch/csrc/poolgrid_slot.cu",
        "replaces": "cupoch_tpu/knn/poolgrid.py:724",
        "launches": total["slot"],
        "max_abs_err": max(gn["max_abs_err"], exact["max_abs_err"]),
        "ms": gn["ms"],
        "plain_ms": gn["plain_ms"],
        "bound_ms": gn["bound_ms"],
        "bound_by": gn["bound_by"],
        "library_ms": None,
    }, {
        "name": "rungrid_fused",
        "route": "cuda",
        "source": "cupoch_tpu_torch/csrc/rungrid_fused.cu",
        "replaces": "cupoch_tpu/knn/rungrid.py:603",
        "launches": total["fused_corres"] + total["fused_gn"],
        "max_abs_err": max(r["max_abs_err"] for r in fused_recs),
        "ms": pl["ms"],
        "plain_ms": pl["plain_ms"],
        "bound_ms": pl["bound_ms"],
        "bound_by": pl["bound_by"],
        "library_ms": None,
        # GN sums are reduced over 1M queries (magnitudes up to 1e6):
        # their absolute gaps say less than their relative ones
        "max_rel_err": max(r.get("rel_err", 0.0) for r in fused_recs),
        "modes": {r["mode"]: {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "rel_err") if k in r} for r in fused_recs},
    }, {
        "name": "rungrid_gmm",
        "route": "cuda",
        "source": "cupoch_tpu_torch/csrc/rungrid_gmm.cu",
        "replaces": "cupoch_tpu/knn/rungrid.py:1141",
        "launches": total["gmm"],
        "max_abs_err": gmm_rec["max_abs_err"],
        "ms": gmm_rec["ms"],
        "plain_ms": gmm_rec["plain_ms"],
        "bound_ms": gmm_rec["bound_ms"],
        "bound_by": gmm_rec["bound_by"],
        "library_ms": None,
    }, {
        "name": "rollgrid_nn",
        "route": "cuda",
        "source": "cupoch_tpu_torch/csrc/rollgrid_nn.cu",
        "replaces": "cupoch_tpu/knn/rollgrid.py:215",
        "launches": total["nn"],
        "max_abs_err": max(r["max_abs_err"] for r in nn_recs),
        "ms": nn_recs[0]["ms"],
        "plain_ms": nn_recs[0]["plain_ms"],
        "bound_ms": nn_recs[0]["bound_ms"],
        "bound_by": nn_recs[0]["bound_by"],
        "library_ms": None,
        "composite_ms": nn_recs[0]["composite_ms"],
        "modes": {r["mode"]: {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "composite_ms",
            "max_abs_err", "bit_exact")} for r in nn_recs},
    }, {
        "name": "bruteforce_nn",
        "route": "cuda",
        "source": "cupoch_tpu_torch/csrc/bruteforce_nn.cu",
        # the JAX package's brute force is plain XLA, no kernel
        "replaces": None,
        "launches": total["bruteforce_nn"],
        "max_abs_err": max(r["max_abs_err"] for r in bf_recs),
        "ms": bf_recs[0]["ms"],
        "plain_ms": bf_recs[0]["plain_ms"],
        "bound_ms": bf_recs[0]["bound_ms"],
        "bound_by": bf_recs[0]["bound_by"],
        "library_ms": bf_recs[0]["library_ms"],
        "levels": {r["level"]: {k: r[k] for k in (
            "queries", "points", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "issue_ms")} for r in bf_recs},
    }, {
        "name": "tsdf_raycast",
        "route": "cuda",
        "source": "cupoch_tpu_torch/csrc/tsdf_raycast.cu",
        # the JAX package's raycast is a lax.while_loop of XLA ops
        "replaces": None,
        "launches": total["tsdf_raycast"],
        "max_abs_err": max(r["max_abs_err"] for r in rc_recs),
        "ms": rc_recs[0]["ms"],
        "plain_ms": rc_recs[0]["plain_ms"],
        "bound_ms": rc_recs[0]["bound_ms"],
        "bound_by": rc_recs[0]["bound_by"],
        "library_ms": None,
        "levels": {r["level"]: {k: r[k] for k in (
            "rays", "hits", "march_steps", "steps", "ms", "wrapper_ms",
            "plain_ms", "bound_ms", "bound_by")} for r in rc_recs},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def _expect(name, c, it, kernel):
    """Launch counts of a path that runs `kernel` once an iteration plus
    once for the initial pose, and no other kernel."""
    want = {k: 0 for k in c}
    want[kernel] = it + 1
    if c != want:
        raise AssertionError(f"{name}: launches {c}, expected {want}")


def colored_gicp_paths(np, torch, ctt, rollgrid, reset_counts, counts,
                       path_counts, timed, crit, card, roll_plan, cube,
                       headline, sheet_data):
    """Colored ICP and GICP through their public entries, each held to
    fitness >= 0.99, every pose entry within POSE_TOL of the truth and
    its launch counts: on the [0,1.4]^3 cloud (roll grid; GICP from
    points alone, so `estimate_normals` runs on both 1M-point clouds),
    on the headline pair (pooled grid) and Colored ICP on the sheet
    (cell grid). Then the Colored roll-grid loop on a prebuilt grid,
    timed and profiled."""
    from cupoch_tpu_torch.registration import registration as regmod
    from cupoch_tpu_torch.registration.estimation import (
        TransformationEstimationType as ET,
    )

    reg = ctt.registration
    dev = torch.device("cuda")

    def cloud(pts, normals=None, colors=None):
        pc = ctt.geometry.PointCloud(torch.as_tensor(pts, device=dev))
        pc.normals, pc.colors = normals, colors
        return pc

    def run(name, fn, T_true, kernel):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        secs = time.perf_counter() - t0
        path_counts[name] = c = counts()
        err = float(np.abs(res.transformation - T_true).max())
        print(f"path: {name}: fitness {res.fitness:.6f} rmse "
              f"{res.inlier_rmse:.6e} iterations {res.iterations} pose "
              f"error {err:.3e} launches {c}; {secs:.3f} s with the "
              f"precompute, host plan and grid build")
        if not np.isfinite(res.transformation).all() or err > POSE_TOL \
                or res.fitness < 0.99:
            raise AssertionError(f"{name} missed its bounds")
        _expect(name, c, res.iterations, kernel)
        return res

    ftgt, ftn, fsrc, fT_true = cube
    fcols = _color_field(np, ftgt)
    fsource, ftarget = cloud(fsrc, colors=fcols), cloud(ftgt, ftn, fcols)
    run(f"registration_colored_icp {len(ftgt)} points in "
        f"[0,{FALLBACK_SIDE}]^3 (roll grid)",
        lambda: reg.registration_colored_icp(fsource, ftarget, RADIUS,
                                             criteria=crit), fT_true, "nn")
    run(f"registration_generalized_icp {len(ftgt)} points in "
        f"[0,{FALLBACK_SIDE}]^3 from points alone (roll grid)",
        lambda: reg.registration_generalized_icp(
            cloud(fsrc), cloud(ftgt), RADIUS, criteria=crit), fT_true, "nn")

    tgt, tn, src, T_true = headline
    cols = _color_field(np, tgt)
    run(f"registration_colored_icp {len(tgt)} points (pooled grid)",
        lambda: reg.registration_colored_icp(
            cloud(src, colors=cols), cloud(tgt, tn, cols), RADIUS,
            criteria=crit), T_true, "slot")
    run(f"registration_generalized_icp {len(tgt)} points from points "
        f"alone (pooled grid)",
        lambda: reg.registration_generalized_icp(
            cloud(src), cloud(tgt), RADIUS, criteria=crit), T_true, "slot")

    sheet, sheet_n, sheet_src = sheet_data
    scols = _color_field(np, sheet)
    sT = np.eye(4, dtype=np.float32)
    sT[:3, 3] = -np.float32(SHEET_SHIFT)
    run(f"registration_colored_icp {len(sheet)}-point sheet (cell grid)",
        lambda: reg.registration_colored_icp(
            cloud(sheet_src, colors=scols), cloud(sheet, sheet_n, scols),
            SHEET_RADIUS, criteria=crit), sT, "nn")

    # the Colored roll-grid loop on a prebuilt grid (the precompute made
    # once, as a tracking loop would)
    est = reg.TransformationEstimationForColoredICP()
    src_p, src_m, src_n = regmod._prep(fsource, True)
    tgt_p, tgt_m, tgt_n = regmod._prep(ftarget, True)
    aux = regmod._estimator_aux(ET.ColoredICP, est, fsource, ftarget,
                                RADIUS, src_p.shape[0], tgt_p.shape[0])

    def rbuild():
        return rollgrid.build_rollgrid(
            tgt_p, roll_plan["origin"], roll_plan["cell_size"],
            roll_plan["dims"], roll_plan["cap"], mask=tgt_m)

    def rloop(g):
        out = regmod._icp_core(
            src_p, src_m, src_n, tgt_p, tgt_m, tgt_n, torch.eye(4), RADIUS,
            REL_TOL, REL_TOL, ET.ColoredICP, ITERS, "roll", aux=aux, grid=g,
            counts=(len(fsource), len(ftarget)))
        torch.cuda.synchronize()
        return out

    rbuild_s, rgrid = timed(rbuild)
    rloop_s, out = timed(lambda: rloop(rgrid))
    print(f"timing: colored roll-grid secs_per_frame {rbuild_s + rloop_s:.4f} "
          f"grid_build_s {rbuild_s:.4f} icp_loop_s {rloop_s:.4f} pass_ms "
          f"{rloop_s / max(out[4], 1) * 1e3:.3f} iterations {out[4]} on "
          f"{card}")
    profile(torch, "colored roll-grid ICP loop", lambda: rloop(rgrid),
            rloop_s)


def _nearer_agreement(np, src, tgt, T, run_set, pool_set, held):
    """(share of the pooled correspondences the run-grid set holds too,
    share of the differing source rows where the run grid's target is
    at least as near as the pooled one (in f64, within the run grid's d2
    rounding) or the pooled target is one the run grid dropped at its
    cell cap (`held` false)). The pooled exact pass ranks by a key that
    keeps 11 mantissa bits of the score, so it may take a neighbour a
    few mm off; the run grid takes the nearest it holds."""
    run = dict(np.asarray(run_set).tolist())
    pool = dict(np.asarray(pool_set).tolist())
    differ = [i for i in pool if i in run and run[i] != pool[i]]
    agree = sum(1 for i in pool if run.get(i) == pool[i]) \
        / max(len(pool), 1)
    if not differ:
        return agree, 1.0
    i = np.asarray(differ)
    p = src[i].astype(np.float64) @ T[:3, :3].T.astype(np.float64) \
        + T[:3, 3]
    t_run = np.asarray([run[k] for k in differ])
    t_pool = np.asarray([pool[k] for k in differ])
    d_run = ((p - tgt[t_run]) ** 2).sum(-1)
    d_pool = ((p - tgt[t_pool]) ** 2).sum(-1)
    ok = (d_run <= d_pool + EVAL_D2_NOISE) | ~held[t_pool]
    return agree, float(ok.mean())


def _corres_agreement(np, a, b):
    """Share of rows of the larger of two correspondence sets that both
    hold."""
    sa = {tuple(r) for r in np.asarray(a).tolist()}
    sb = {tuple(r) for r in np.asarray(b).tolist()}
    return len(sa & sb) / max(len(sa), len(sb), 1)


def _branch_pairs(np):
    """The CPU tests' Colored/GICP clouds, one a branch of
    `registration_icp` (tests/test_torch_colored_gicp_icp.py): name ->
    (source, target, target normals, radius)."""
    rng = np.random.default_rng(6)

    def unit(v):
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)

    def moved(tgt, ang, t):
        return ((tgt - np.float32(t)) @ _rot_z(np, ang)).astype(np.float32)

    xy = rng.uniform(-1, 1, size=(800, 2)).astype(np.float32)
    z = 0.25 * np.sin(2.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
    surf = np.column_stack([xy, z]).astype(np.float32)
    fx = 0.625 * np.cos(2.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
    fy = -0.375 * np.sin(2.5 * xy[:, 0]) * np.sin(1.5 * xy[:, 1])
    cube = rng.uniform(0, 0.42, size=(30000, 3)).astype(np.float32)
    two = np.concatenate([rng.uniform(0, 0.1, size=(15000, 3)),
                          rng.uniform(1.9, 2.0, size=(15000, 3))]).astype(
        np.float32)
    return {
        "brute force": (moved(surf, 0.03, [0.01, -0.015, 0.02]), surf,
                        unit(np.column_stack([-fx, -fy, np.ones_like(fx)])),
                        0.2),
        "roll grid": (moved(cube, 0.01, [0.003, -0.004, 0.002]), cube,
                      unit(rng.normal(size=cube.shape)), RADIUS),
        "cell grid": (moved(two, 0.002, [0.001, -0.001, 0.0005]), two,
                      unit(rng.normal(size=two.shape)), 0.01),
    }


def small_inputs(np, ctt, poolgrid, rungrid, tgt, tn, src, T_true, crit,
                 pt2pl):
    """Each path on the card against the same call on the CPU (the plain
    versions): pose within 1e-4, fitness within 1e-3, correspondences
    >= 99.9% equal, fitness >= 0.98 (the hash-grid case is held to the
    CPU path alone: its 32-point buckets drop most candidates there, in
    the reference as well)."""
    reg = ctt.registration
    pt2pt = reg.TransformationEstimationPointToPoint()
    sheet_src, sheet = _surface_pair(np)
    if poolgrid.plan_poolgrid(sheet, RADIUS, query_points=sheet_src)[
            "active_cells"] is None:
        raise AssertionError("the surface cloud did not compact its grid")
    m = 24000
    # 30k points in [0,0.43]^3, about the fallback cloud's density: the
    # pool plan is rejected, the run plan accepted
    t_fb, n_fb, s_fb, _ = _headline_clouds(np, 30000, side=0.43, seed=4)
    if poolgrid.plan_poolgrid(t_fb, RADIUS, query_points=s_fb,
                              est=2) is not None \
            or rungrid.plan_rungrid(t_fb, RADIUS, query_points=s_fb) is None:
        raise AssertionError("the 30k cloud does not take the fallback")
    fr_src, fr_tgt, fr_sigma, _ = _filterreg_pair(np, 40000, seed=3)
    few = reg.ICPConvergenceCriteria(REL_TOL, REL_TOL, 8)
    # targets every grid plan rejects (all points in a 0.15 cube): 21k
    # take the brute-force fallback, 250k the hash grid
    t_br, _, s_br, _ = _headline_clouds(np, 21000, side=0.15, seed=7)
    t_hg, _, s_hg, _ = _headline_clouds(np, 250000, side=0.15, seed=8)
    cases = [
        dict(case="pooled volume", kind="icp", s=src[:m], t=tgt[:m],
             n=tn[:m], est=pt2pl, cr=crit),
        dict(case="pooled surface", kind="icp", s=sheet_src, t=sheet,
             est=pt2pt, cr=crit),
        dict(case="brute-force ICP", kind="icp", s=src[:15000],
             t=tgt[:15000], n=tn[:15000], est=pt2pl, cr=crit),
        dict(case="evaluate grid", kind="evaluate", s=src[:m], t=tgt[:m]),
        dict(case="evaluate brute force", kind="evaluate", s=src[:15000],
             t=tgt[:15000]),
        dict(case="run-grid fallback", kind="icp", s=s_fb, t=t_fb, n=n_fb,
             est=pt2pl, cr=few),
        dict(case="grid FilterReg", kind="filterreg", s=fr_src, t=fr_tgt),
        dict(case="brute-force fallback", kind="icp", s=s_br, t=t_br,
             est=pt2pt, cr=few),
        dict(case="hash grid", kind="icp", s=s_hg, t=t_hg, est=pt2pt,
             cr=reg.ICPConvergenceCriteria(REL_TOL, REL_TOL, 3),
             own_fit=False),
    ]
    for name, (s_np, t_np, n_np, r) in _branch_pairs(np).items():
        cols = _color_field(np, t_np)
        cases += [
            dict(case=f"Colored ICP, {name}", kind="icp", s=s_np, t=t_np,
                 n=n_np, cols=cols, r=r,
                 est=reg.TransformationEstimationForColoredICP(), cr=crit),
            dict(case=f"GICP, {name}", kind="icp", s=s_np, t=t_np, r=r,
                 est=reg.TransformationEstimationForGeneralizedICP(),
                 cr=crit)]
    for cs in cases:
        out = {}
        r = cs.get("r", RADIUS)
        for name in ("cuda", "cpu"):
            s_pc = ctt.geometry.PointCloud(cs["s"], device=name)
            t_pc = ctt.geometry.PointCloud(cs["t"], device=name)
            t_pc.normals = cs.get("n")
            s_pc.colors = t_pc.colors = cs.get("cols")
            if cs["kind"] == "icp":
                out[name] = reg.registration_icp(
                    s_pc, t_pc, r, estimation=cs["est"], criteria=cs["cr"])
            elif cs["kind"] == "evaluate":
                out[name] = reg.evaluate_registration(s_pc, t_pc, r, T_true)
            else:
                out[name] = reg.registration_filterreg(
                    s_pc, t_pc, option=reg.FilterRegOption(
                        sigma_initial=fr_sigma, relative_likelihood=0.0,
                        max_iteration=5))
        a, b = out["cuda"], out["cpu"]
        d_pose = float(np.abs(a.transformation - b.transformation).max())
        if cs["kind"] == "filterreg":
            fit_gap, agree, fit = 0.0, 1.0, 1.0
            detail = (f"likelihood {a.likelihood:.6e} vs "
                      f"{b.likelihood:.6e}")
        else:
            fit_gap = abs(a.fitness - b.fitness)
            agree = _corres_agreement(np, a.correspondence_set,
                                      b.correspondence_set)
            fit = a.fitness if cs.get("own_fit", True) else 1.0
            detail = (f"fitness {a.fitness:.6f} vs {b.fitness:.6f}, "
                      f"correspondences agree on {agree:.6f}")
        print(f"small input ({cs['case']}, {len(cs['s'])} points): cuda vs "
              f"cpu pose gap {d_pose:.3e}, {detail}")
        if d_pose > 1e-4 or fit_gap > 1e-3 or agree < AGREE_MIN \
                or fit < 0.98:
            raise AssertionError(f"card and CPU paths disagree on the "
                                 f"{cs['case']} input")


def profile(torch, what, fn, loop_s, warm_up=True):
    """Device time by kernel over one run of `fn` (kernels only, not the
    operators that launch them), after a profiled warm-up run unless
    `fn` is warm already, and the device's busy share of the unprofiled
    run's wall time `loop_s`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    # the device's activity only: the host's operator events are not
    # read here, and recording them for the global-registration
    # pipeline's tens of thousands of launches took longer than the run
    acts = [ProfilerActivity.CUDA]
    if warm_up:
        with tprofile(activities=acts):
            fn()
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
        print(f"profile ({what}): the profiler saw no device time: not "
              f"measured")
        return
    top = "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in rows[:10])
    print(f"profile ({what}): kernels {busy_ms:.3f} ms over a "
          f"{loop_s * 1e3:.3f} ms loop, busy share "
          f"{busy_ms / (loop_s * 1e3):.3f}; top: {top}")


if __name__ == "__main__":
    main()
