"""The port's SLAM backend (cupoch_tpu_torch.slam: the pose graph,
bundle adjustment, checkpoints and RGB-D SLAM) against the JAX package
on the CPU, replicated and, over two gloo CPU ranks spawned once for
the file (`parallel.launch`, chip_smoke.py's phase-4m jobs at its test
sizes), sharded; the JAX package shards over two of its 8 virtual CPU
devices (tests/conftest.py).

Tolerances: the pose graph within 1e-3 and bundle adjustment within
2e-3 after scale alignment (tests/test_slam.py's, against the
reference's single-device run); RGB-D SLAM at 320x240 within 3e-3
(chip_smoke's card-against-CPU limit: hybrid odometry there moves the
keyframes by up to 1.9e-3 for last-bit rounding differences, between
the card and the CPU, between the packages at one thread and at eight;
at 160x120 by 5e-3);
the residuals within 1e-6; the port's closed-form Jacobians within
1e-4 of central differences in float64, the reference's float32
`jacfwd` within its own error against them (up to 5e-3 on the loop
graph: its log goes through arccos near 1), so over two iterations on
the loop graph the poses part by up to 6.6e-4; checkpoints read back
bit for bit across the packages.

The reference's Gauss-Newton wanders at its optimum when the edges'
rotations are exact (tests/test_slam.py's loop graph: its error sits
at a floor while rounding at log_so3's small-angle branch sends the
steps up to 5 cm, so two runs that differ in the last bit part after
2-3 iterations); that graph is held to the reference over the first two
iterations and by the drift criterion, and the parity runs use graphs
with rotational noise, as odometry gives.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke as cs
import test_slam as jts
import torch_port_bridge as bridge
import cupoch_tpu.slam as jslam
import cupoch_tpu_torch as ctt
import cupoch_tpu_torch.slam as tslam
from cupoch_tpu.camera import PinholeCameraIntrinsic as JIntrinsic
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import RGBDImage as JRGBDImage
from cupoch_tpu.slam import pose_graph as jpg
from cupoch_tpu.utility.transforms import exp_se3 as jexp
from cupoch_tpu_torch.parallel import launch
from cupoch_tpu_torch.slam import pose_graph as tpg
from cupoch_tpu_torch.utility.transforms import (exp_se3, inverse_transform,
                                                 log_se3)

CFG = cs.small_multi_config()
PG_TOL = 1e-3
BA_TOL = 2e-3
SLAM_TOL = cs.SMALL_SLAM_TOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the file: under six test workers of
    eight threads each, the port's many small ops spend their time in
    the thread pool (a 320x240 SLAM run took 560 s at eight threads
    under such load, 4.6 s at one; host run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_frames(tmp_path_factory):
    return cs.slam_frames(np, CFG, str(tmp_path_factory.mktemp("frames")))


@pytest.fixture(scope="module")
def ranks(small_frames):
    """Per rank {job: result} of one spawn of 2 gloo CPU ranks."""
    jobs = {"pose graph": launch.Job(cs.multi_pose_graph, (CFG,)),
            "ba": launch.Job(cs.multi_ba, (CFG,)),
            "slam": launch.Job(cs.multi_slam, small_frames + (CFG,))}
    out = launch.run_ranks(list(jobs.values()), 2, backend="gloo",
                           device="cpu")
    return [{k: v["result"] for k, v in r.items()}
            for r in cs._by_name(jobs, out)]


def _rotated(rng, graph, sigma=0.01):
    """The graph with each edge's measurement turned by N(0, sigma)."""
    for e in graph.edges:
        xi = np.zeros(6, np.float32)
        xi[:3] = rng.normal(0, sigma, 3)
        e.transformation = (e.transformation @ np.asarray(
            jexp(jnp.asarray(xi)))).astype(np.float32)
    return graph


def _copy_jax(g):
    h = jslam.PoseGraph()
    h.nodes = [jslam.PoseGraphNode(n.pose.copy()) for n in g.nodes]
    h.edges = list(g.edges)
    return h


def _poses(g):
    return np.stack([n.pose for n in g.nodes])


def _jax_sphere():
    _, init, src, tgt, meas = cs.sphere_graph(np, *CFG["rings"])
    g = jslam.PoseGraph()
    g.nodes = [jslam.PoseGraphNode(p) for p in init]
    g.edges = [jslam.PoseGraphEdge(int(s), int(t), m)
               for s, t, m in zip(src, tgt, meas)]
    return g


def _edge_inputs(g):
    src, tgt, zinv, info, w = tpg._edge_arrays(
        bridge.pose_graph(g), tslam.GlobalOptimizationOption(), 1)
    return _poses(g), src, tgt, zinv, info, w


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _central_differences(poses, src, tgt, zinv, eps=1e-6):
    """d r / d xi_j of r = log(Z^-1 T_i^-1 exp(xi_j) T_j) in float64."""
    P, Z = torch.tensor(poses).double(), torch.tensor(zinv).double()
    Ti, Tj = P[src], P[tgt]
    steps = torch.eye(6, dtype=torch.float64) * eps

    def r(xj):
        return log_se3(Z @ inverse_transform(Ti) @ (exp_se3(xj) @ Tj))

    n = len(src)
    return torch.stack([(r(steps[k].expand(n, 6)) - r(-steps[k].expand(n, 6)))
                        / (2 * eps) for k in range(6)], -1).numpy()


def test_torch_pose_graph_system_matches_jax(rng):
    """The residuals equal the reference's; the closed-form Jacobians
    hold to central differences in float64 within 1e-4, and to the
    reference's float32 `jacfwd` within that one's own error against
    them (up to 5e-3 here: its log goes through arccos near 1); H and b
    are the blocks' sums."""
    g = _rotated(rng, jts.make_loop_graph(rng)[0])
    poses, src, tgt, zinv, info, w = _edge_inputs(g)
    n, e = poses.shape[0], len(g.edges)
    src, tgt, zinv, info, w = src[:e], tgt[:e], zinv[:e], info[:e], w[:e]
    rj, Jij, Jjj, _ = jax.jit(jpg._edge_residual_jacobians)(
        jnp.asarray(poses), jnp.asarray(src.astype(np.int32)),
        jnp.asarray(tgt.astype(np.int32)), jnp.asarray(zinv),
        jnp.asarray(info), jnp.asarray(w))
    targs = tuple(torch.as_tensor(a) for a in (poses, src, tgt, zinv))
    rt, Jit, Jjt = tpg.edge_jacobians(*targs)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6)
    fd = _central_differences(poses, src, tgt, zinv)
    np.testing.assert_allclose(Jjt.numpy(), fd, atol=1e-4)
    np.testing.assert_array_equal(Jit.numpy(), -Jjt.numpy())
    ref_err = np.abs(np.asarray(Jjj) - fd).max()
    assert ref_err < 1e-2
    assert np.abs(Jjt.numpy() - np.asarray(Jjj)).max() <= ref_err + 1e-4
    assert np.abs(Jit.numpy() - np.asarray(Jij)).max() <= ref_err + 1e-4
    Ht, bt, et = tpg.normal_system(*targs, torch.as_tensor(info),
                                   torch.as_tensor(w), n)
    Wt = w[:, None, None] * info
    J = {"i": Jit.numpy().astype(np.float64), "j": Jjt.numpy().astype(
        np.float64)}
    H = np.zeros((n, 6, n, 6))
    b = np.zeros((n, 6))
    for k in range(e):
        for a, na in (("i", src[k]), ("j", tgt[k])):
            b[na] += J[a][k].T @ Wt[k] @ rt.numpy()[k]
            for c, nc in (("i", src[k]), ("j", tgt[k])):
                H[na, :, nc, :] += J[a][k].T @ Wt[k] @ J[c][k]
    H = H.reshape(6 * n, 6 * n)
    np.testing.assert_allclose(Ht.numpy(), H, atol=1e-6 * np.abs(H).max())
    np.testing.assert_allclose(bt.numpy(), b.reshape(-1),
                               atol=1e-6 * np.abs(b).max())
    r = rt.numpy().astype(np.float64)
    np.testing.assert_allclose(float(et), np.einsum("ek,ekl,el->", r, Wt, r),
                               rtol=1e-5)


def test_torch_pose_graph_exact_rotations_match_jax_then_reduce_drift(rng):
    graph, gt = jts.make_loop_graph(rng)
    gj2, gt2 = _copy_jax(graph), bridge.pose_graph(graph)
    jslam.global_optimization(gj2, jslam.GlobalOptimizationOption(
        max_iteration=2))
    tslam.global_optimization(gt2, tslam.GlobalOptimizationOption(
        max_iteration=2), device="cpu")
    np.testing.assert_allclose(_poses(gt2), _poses(gj2), atol=PG_TOL)
    # tests/test_slam.py's criterion at its 15 iterations
    before = jts.ate(graph, gt)
    g15 = bridge.pose_graph(graph)
    tslam.global_optimization(g15, tslam.GlobalOptimizationOption(
        max_iteration=15), device="cpu")
    assert jts.ate(g15, gt) < 0.6 * before
    np.testing.assert_allclose(g15.nodes[0].pose, graph.nodes[0].pose,
                               atol=1e-3)


@pytest.mark.parametrize("graph", ["loop", "sphere"])
def test_torch_pose_graph_matches_jax(rng, graph):
    if graph == "loop":
        g = _rotated(rng, jts.make_loop_graph(rng)[0])
    else:
        g = _jax_sphere()
    gp = bridge.pose_graph(g)
    jslam.global_optimization(g, jslam.GlobalOptimizationOption(
        max_iteration=10))
    tslam.global_optimization(gp, tslam.GlobalOptimizationOption(
        max_iteration=10), device="cpu")
    np.testing.assert_allclose(_poses(gp), _poses(g), atol=PG_TOL)


def test_torch_pose_graph_sharded_matches_jax(ranks):
    a, b = (r["pose graph"][0] for r in ranks)
    np.testing.assert_array_equal(a, b)
    g = _jax_sphere()
    one = bridge.pose_graph(g)
    tslam.global_optimization(one, tslam.GlobalOptimizationOption(
        max_iteration=cs.PG_ITERS), device="cpu")
    np.testing.assert_allclose(a, _poses(one), atol=PG_TOL)
    jslam.global_optimization(
        g, jslam.GlobalOptimizationOption(max_iteration=cs.PG_ITERS),
        mesh=Mesh(np.asarray(jax.devices()[:2]), (jslam.EDGE_AXIS,)))
    np.testing.assert_allclose(a, _poses(g), atol=PG_TOL)
    gt, init = cs.sphere_graph(np, *CFG["rings"])[:2]
    assert cs.translation_ate(np, a, gt) < \
        cs.PG_ATE_RATIO * cs.translation_ate(np, init, gt)


def test_torch_pose_graph_empty_and_padding():
    g = tslam.PoseGraph()
    assert tslam.global_optimization(g, device="cpu") is g
    g.nodes = [tslam.PoseGraphNode() for _ in range(3)]
    g.edges = [tslam.PoseGraphEdge(0, 1), tslam.PoseGraphEdge(1, 2)]
    src, tgt, zinv, info, w = tpg._edge_arrays(
        g, tslam.GlobalOptimizationOption(), 4)
    assert src.shape == (4,)
    assert (src[2:] == 0).all() and (tgt[2:] == 0).all() \
        and (w[2:] == 0).all()


# ---------------------------------------------------------------------------
# bundle adjustment
# ---------------------------------------------------------------------------

def test_torch_ba_matches_jax(rng):
    prob, gt_poses, _ = jts.make_ba_problem(rng)
    pj, xj, _ = jslam.bundle_adjustment(prob, iterations=10)
    tprob = bridge.ba_problem(prob)
    pt, xt, _ = tslam.bundle_adjustment(tprob, iterations=10, device="cpu")
    rmse0 = tslam.reprojection_rmse(tprob, device="cpu")
    assert rmse0 == pytest.approx(jslam.reprojection_rmse(prob), rel=1e-6)
    assert tslam.reprojection_rmse(tprob, pt, xt) < 0.05 * rmse0
    assert cs.scale_aligned_gap(np, pt.numpy(), np.asarray(pj)) < BA_TOL
    assert cs.scale_aligned_gap(np, pt.numpy(), gt_poses) < 5e-3


def test_torch_ba_schur_pieces_match_jax(rng):
    # the packages export the function under its module's name
    jba = importlib.import_module("cupoch_tpu.slam.bundle_adjustment")
    tba = importlib.import_module("cupoch_tpu_torch.slam.bundle_adjustment")
    prob, _, _ = jts.make_ba_problem(rng, n_pts=16)
    C = prob.poses.shape[0]
    Sj, gj, Hj, blj, Aj, ej = jba._local_schur(*prob[:4], prob.intrinsics,
                                               C, jnp.float32(1e-4))
    t = tba._on(bridge.ba_problem(prob), torch.device("cpu"))
    # in float64, as bundle_adjustment runs it
    St, gt_, Ht, blt, At, et = tba.local_schur(
        t.poses.double(), t.points.double(), t.obs_cam, t.obs_uv.double(),
        t.intrinsics.double(), C, 1e-4)
    St = St.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    Sj = np.asarray(Sj).reshape(6 * C, 6 * C)
    np.testing.assert_allclose(St.numpy(), Sj, atol=1e-5 * np.abs(Sj).max())
    np.testing.assert_allclose(gt_.reshape(-1).numpy(),
                               np.asarray(gj).reshape(-1),
                               atol=1e-5 * np.abs(np.asarray(gj)).max())
    Aj = np.asarray(Aj)
    np.testing.assert_allclose(At.numpy(), Aj, atol=1e-5 * np.abs(Aj).max())
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-5)


def test_torch_ba_sharded_matches_jax(ranks):
    (pa, xa, r0, r1, _, _), (pb, xb, *_) = (r["ba"] for r in ranks)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(xa, xb)
    assert r1 < cs.BA_RMSE_RATIO * r0
    C, L, n_obs, k = CFG["ba"]
    arrays = cs.ba_problem(np, C, L, n_obs, k)[:5]
    one, _, _ = tslam.bundle_adjustment(tslam.BAProblem(*arrays),
                                        cs.BA_ITERS, device="cpu")
    assert cs.scale_aligned_gap(np, pa, one.numpy()) < BA_TOL
    jprob = jslam.BAProblem(*(jnp.asarray(a) for a in arrays))
    pj, _, _ = jslam.bundle_adjustment(jprob, cs.BA_ITERS,
                                       mesh=jslam.make_block_mesh(2))
    assert cs.scale_aligned_gap(np, pa, np.asarray(pj)) < BA_TOL


def test_torch_ba_handles_missing_observations(rng):
    prob, _, _ = jts.make_ba_problem(rng, n_pts=32)
    obs_cam = np.asarray(prob.obs_cam).copy()
    obs_cam[::3, 1] = -1
    p2 = bridge.ba_problem(prob)._replace(obs_cam=obs_cam)
    poses, points, _ = tslam.bundle_adjustment(p2, iterations=8,
                                               device="cpu")
    assert np.isfinite(poses.numpy()).all()
    assert tslam.reprojection_rmse(p2, poses, points) < 1.0
    j2 = prob._replace(obs_cam=jnp.asarray(obs_cam))
    pj, _, _ = jslam.bundle_adjustment(j2, iterations=8)
    assert cs.scale_aligned_gap(np, poses.numpy(), np.asarray(pj)) < BA_TOL


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torch_checkpoints_read_across_packages(tmp_path, rng, writer):
    state = {"poses": rng.normal(size=(5, 4, 4)).astype(np.float32),
             "step": np.int64(7)}
    path = str(tmp_path / "slam_0.npz")
    save, load = (jslam.save_checkpoint, tslam.load_checkpoint) \
        if writer == "jax" else (tslam.save_checkpoint,
                                 jslam.load_checkpoint)
    assert save(path, state, {"frame": 7})
    back, meta = load(path)
    np.testing.assert_array_equal(back["poses"], state["poses"])
    assert int(back["step"]) == 7 and meta == {"frame": 7}
    assert tslam.latest_checkpoint(str(tmp_path)) == path
    assert tslam.latest_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torch_slam_checkpoint_read_across_packages(tmp_path, writer):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [1, 2, 3]
    intr = (64, 48, 50, 50, 32, 24)
    mods = (jslam, tslam) if writer == "jax" else (tslam, jslam)
    cams = {jslam: JIntrinsic, tslam: ctt.camera.PinholeCameraIntrinsic}
    first = mods[0].RGBDSlam(cams[mods[0]](*intr))
    first.pose_graph.nodes += [mods[0].PoseGraphNode(np.eye(4)),
                               mods[0].PoseGraphNode(T)]
    first.pose_graph.edges.append(mods[0].PoseGraphEdge(0, 1, T,
                                                        uncertain=True))
    first.trajectory = [np.eye(4, dtype=np.float32), T]
    first.cur_pose = T
    first.frame_id, first._since_opt = 42, 1
    path = str(tmp_path / "slam.npz")
    assert first.save(path)
    second = mods[1].RGBDSlam(cams[mods[1]](*intr))
    assert second.restore(path)
    assert (second.frame_id, second._since_opt) == (42, 1)
    assert len(second.pose_graph.nodes) == 2
    e = second.pose_graph.edges[0]
    assert (e.source_node_id, e.target_node_id, e.uncertain) == (0, 1, True)
    np.testing.assert_array_equal(e.transformation, T)
    np.testing.assert_array_equal(second.cur_pose, T)
    np.testing.assert_array_equal(np.stack(second.trajectory),
                                  np.stack(first.trajectory))
    assert second.prev_frame is None


# ---------------------------------------------------------------------------
# RGB-D SLAM
# ---------------------------------------------------------------------------

def _slam_runs(mod, intr, frame, n, tmp_path):
    """chip_smoke.multi_slam's two runs through package `mod` (the same
    API in both): (whole, resumed)."""
    o = cs.slam_option(ctt, CFG)
    opt = mod.SlamOption(
        keyframe_interval=o.keyframe_interval,
        loop_closure_interval=o.loop_closure_interval,
        loop_closure_min_gap=o.loop_closure_min_gap,
        optimize_every_n_keyframes=o.optimize_every_n_keyframes)
    kw = {} if mod is jslam else {"device": "cpu"}
    s = CFG["save_frame"]
    whole = mod.RGBDSlam(intr, opt, **kw)
    for k in range(n):
        whole.process_frame(frame(k))
    whole.optimize()
    first = mod.RGBDSlam(intr, opt, **kw)
    for k in range(s + 1):
        first.process_frame(frame(k))
    path = str(tmp_path / f"{mod.__name__}.npz")
    first.save(path)
    again = mod.RGBDSlam(intr, opt, **kw)
    again.restore(path)
    for k in range(s + 1, n):
        again.process_frame(frame(k))
    again.optimize()
    return whole, again


@pytest.fixture(scope="module")
def slam_pair(small_frames, tmp_path_factory):
    """Both packages' runs on the same frames: the JAX package's RGB-D
    images, carried to the port by torch_port_bridge (each package's
    own factory rounds the colour differently in the last bit)."""
    intr_dict, path = small_frames
    frames = cs.load_frames(np, path)
    jframes = [JRGBDImage.create_from_color_and_depth(JImage(c), JImage(d))
               for c, d in frames]
    tmp = tmp_path_factory.mktemp("slam")
    j = _slam_runs(jslam, JIntrinsic.from_dict(intr_dict),
                   jframes.__getitem__, len(frames), tmp)
    t = _slam_runs(tslam, ctt.camera.PinholeCameraIntrinsic.from_dict(
        intr_dict), lambda k: bridge.rgbd(jframes[k]), len(frames), tmp)
    return j, t


def _graph_state(slam):
    g = slam.pose_graph
    return (np.stack([n.pose for n in g.nodes]),
            [(e.source_node_id, e.target_node_id, e.uncertain)
             for e in g.edges], np.stack(slam.trajectory))


@pytest.mark.parametrize("run", [0, 1], ids=["whole", "resumed"])
def test_torch_slam_matches_jax(slam_pair, run):
    (kj, ej, tj), (kt, et, tt) = (_graph_state(pkg[run])
                                  for pkg in slam_pair)
    assert ej == et
    # a resumed run has no loop-closure candidates: frames are not saved
    assert any(u for *_, u in ej) == (run == 0)
    np.testing.assert_allclose(kt, kj, atol=SLAM_TOL)
    np.testing.assert_allclose(tt, tj, atol=SLAM_TOL)


def test_torch_slam_restore_equals_save(ranks):
    out = ranks[0]["slam"]
    for key, v in out["saved"].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(out["restored"][key]))
    cs.check_multi_slam(np, out, CFG["slam_t_max"], "RGBDSlam")


def test_torch_slam_ranks_hold_equal_graphs(ranks):
    a, b = (r["slam"] for r in ranks)
    for run in ("whole", "resumed"):
        for key in a[run]:
            np.testing.assert_array_equal(np.asarray(a[run][key]),
                                          np.asarray(b[run][key]))
