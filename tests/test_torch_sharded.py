"""The port's multi-rank paths (cupoch_tpu_torch.parallel: the mesh and
its collectives, the launcher, the ring-sharded pooled ICP and the
point-sharded run-grid ICP; bench.scaling's collective split) against
the JAX package on the CPU.

The port's ranks are gloo processes on the CPU, spawned once a rank
count for the file (`parallel.launch`), running chip_smoke.py's phase-4m
jobs at its test sizes (`small_multi_config`); the JAX package runs its
shard_map forms on meshes of as many of its 8 virtual CPU devices
(tests/conftest.py). Tolerances: tests/test_sharded.py's, pose within
1e-3 and fitness within 5e-3 (psum adds in another order than JAX's);
plans, query bins and the epilogue's correspondences equal, tables
within 2^-15 (the port's one f32 table against the JAX scan + scan_lo),
GN sums within 1e-5 of their largest term.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import torch_port_bridge as bridge
from cupoch_tpu.knn import poolgrid as jpg
from cupoch_tpu.parallel import make_point_mesh as jax_point_mesh
from cupoch_tpu.parallel import ring_sharded_registration_icp as jax_ring
from cupoch_tpu.parallel import sharded_registration_icp as jax_point
from cupoch_tpu.registration import fused_icp as jicp
from cupoch_tpu.registration.estimation import (
    TransformationEstimationType as JET,
)
from cupoch_tpu_torch.bench import scaling
from cupoch_tpu_torch.knn import poolgrid as tpg
from cupoch_tpu_torch.knn import poolgrid_slot
from cupoch_tpu_torch.parallel import collectives, launch, sharded
from cupoch_tpu_torch.registration import fused_icp as ticp
from cupoch_tpu_torch.registration.estimation import (
    TransformationEstimationType as TET,
)

CFG = cs.small_multi_config()
RADIUS = cs.RADIUS
POSE_TOL = cs.SHARDED_POSE_TOL
FIT_TOL = cs.SHARDED_FIT_TOL
FOREIGN = {"jax", "jaxlib", "cupoch_tpu", "conftest", "torch_port_bridge"}


def _jobs(D):
    jobs = {"collectives": launch.Job(cs.multi_collectives),
            "ring": launch.Job(cs.multi_ring, (CFG,)),
            "packages": launch.Job(launch.loaded_packages)}
    if D == 2:
        jobs["point"] = launch.Job(cs.multi_point, (CFG,))
        jobs["split"] = launch.Job(
            scaling.collective_split, (),
            {"points_per_device": 1024, "max_iteration": 3, "reps": 1})
    return jobs


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
def ranks():
    """{D: per rank {job: result}} of one spawn of D gloo CPU ranks for
    D = 2 and 4, started together."""
    started = {D: (_jobs(D), launch.start_ranks(
        list(_jobs(D).values()), D, backend="gloo", device="cpu"))
        for D in (2, 4)}
    return {D: [{k: v["result"] for k, v in r.items()}
                for r in cs._by_name(jobs, handle.join())]
            for D, (jobs, handle) in started.items()}


@pytest.fixture(scope="module")
def headline():
    return cs._headline_clouds(np, CFG["points"], side=CFG["side"])


@pytest.fixture(scope="module")
def fallback():
    return cs._headline_clouds(np, CFG["points"], side=CFG["fallback_side"])


def _single_pool(tgt, tn, src):
    """The port's single-device pooled loop on the pair."""
    attrs, code = ticp.make_target_attrs(
        TET.PointToPlane, torch.as_tensor(tgt), torch.as_tensor(tn))
    plan = tpg.plan_poolgrid(tgt, RADIUS, query_points=src, est=code)
    grid = tpg.make_poolgrid(
        torch.as_tensor(tgt), attrs, plan["origin"], plan["cell_size"],
        plan["dims"], plan["cap"], plan["kc"], est=code, tile=plan["tile"],
        active_cells=plan["active_cells"])
    n = src.shape[0]
    return ticp.icp_core_pool(
        torch.as_tensor(src), torch.ones(n, dtype=torch.bool),
        torch.zeros((n, 0)), grid, torch.eye(4), RADIUS,
        plan["rebin_margin"], 1e-6, 1e-6, plan["qp"], TET.PointToPlane,
        cs.ITERS)


# ---------------------------------------------------------------------------
# mesh, collectives, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 4])
def test_torch_collectives_match_definition(ranks, D):
    if D == 1:
        outs = [launch.to_numpy(cs.multi_collectives(
            sharded.make_point_mesh(1, device="cpu")))]
    else:
        outs = [r["collectives"] for r in ranks[D]]
    assert len(outs) == D
    cs.check_collectives(np, outs)


def test_torch_mesh_size_and_backend_checks():
    mesh = sharded.make_point_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, None)
    x = torch.arange(3.0)
    assert mesh.psum(x) is x and mesh.ppermute(x) is x
    with pytest.raises(ValueError):
        sharded.make_point_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        launch.start_ranks([], 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError):
        launch.start_ranks([], 2, backend="mpi", device="cpu")
    assert collectives.shard_rows(1001, mesh) == (1008, 1008, 0)


def test_torch_rank_failure_fails_the_call():
    empty = np.zeros((0, 3), np.float32)
    job = launch.Job(sharded.ring_sharded_registration_icp,
                     (empty[:8] + 1.0, empty, empty, RADIUS))
    with pytest.raises(Exception, match="unsuitable for a pooled grid"):
        launch.run_ranks([job], 2, backend="gloo", device="cpu")


def test_torch_ranks_import_no_jax(ranks):
    for D, rs in ranks.items():
        for r in rs:
            loaded = set(r["packages"])
            assert "cupoch_tpu_torch" in loaded
            assert not loaded & FOREIGN, loaded & FOREIGN
            assert not [m for m in loaded if m.startswith("test_")]


# ---------------------------------------------------------------------------
# ring plan, grid, bins and epilogue
# ---------------------------------------------------------------------------

def _ring_case(rng, layout):
    if layout == "dense":
        tgt = rng.uniform(size=(5000, 3)).astype(np.float32)
    else:
        v = rng.normal(size=(6000, 3))
        tgt = (1.0 + 0.95 * v / np.linalg.norm(v, axis=1, keepdims=True)) \
            .astype(np.float32)
    tn = rng.normal(size=tgt.shape).astype(np.float32)
    tn /= np.linalg.norm(tn, axis=1, keepdims=True)
    src = (tgt[: tgt.shape[0] * 3 // 4]
           + np.float32([0.004, -0.006, 0.002])).astype(np.float32)
    return tgt, tn, src


@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("D", [2, 4])
def test_torch_ring_plan_and_grid_match_jax(rng, D, layout):
    tgt, tn, src = _ring_case(rng, layout)
    attrs_j, code = jicp.make_target_attrs(JET.PointToPlane,
                                           jnp.asarray(tgt), jnp.asarray(tn))
    pj = jpg.plan_poolgrid(tgt, RADIUS, query_points=src, est=code, shards=D)
    pt = tpg.plan_poolgrid(tgt, RADIUS, query_points=src, est=code, shards=D)
    assert (pj["active_cells"] is not None) == (layout == "compact")
    for k in ("dims", "cap", "kc", "qp", "tile", "shards", "n_active"):
        assert pj[k] == pt[k], k
    np.testing.assert_array_equal(pj["origin"], pt["origin"])
    if layout == "compact":
        np.testing.assert_array_equal(pj["active_cells"],
                                      pt["active_cells"])
    gj = jpg.make_poolgrid(
        jnp.asarray(tgt), attrs_j, pj["origin"], pj["cell_size"],
        pj["dims"], pj["cap"], pj["kc"], est=code, tile=pj["tile"],
        shards=D, active_cells=pj["active_cells"])
    attrs_t, _ = ticp.make_target_attrs(TET.PointToPlane,
                                        torch.as_tensor(tgt),
                                        torch.as_tensor(tn))
    gt = tpg.make_poolgrid(
        torch.as_tensor(tgt), attrs_t, pt["origin"], pt["cell_size"],
        pt["dims"], pt["cap"], pt["kc"], est=code, tile=pt["tile"],
        shards=D, active_cells=pt["active_cells"])
    assert gt.n_tiles == gj.n_tiles and gt.n_tiles % D == 0
    for r in range(D):
        ref = bridge.pool_grid_shard(gj, r, D).table.numpy()
        got = sharded.shard_pool_table(
            tpg.PoolGrid(gt.table, gt.binfields, gt.origin, gt.cell_size,
                         gt.off, gt.dims, gt.cap, gt.kc, gt.est, gt.tile),
            SimpleNamespace(size=D, rank=r)).table.numpy()
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -15, atol=1e-6)
    np.testing.assert_allclose(gt.binfields.numpy(), np.asarray(gj.binfields),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("D", [2, 4])
def test_torch_ring_bins_match_jax(rng, D):
    tgt, tn, src = _ring_case(rng, "dense")
    plan = jpg.plan_poolgrid(tgt, RADIUS, query_points=src, shards=D)
    G = -(-int(np.prod(plan["dims"])) // (plan["tile"] * D)) * D
    n_pad, n_local, _ = collectives.shard_rows(
        src.shape[0], SimpleNamespace(size=D, rank=0))
    src_pad = np.zeros((n_pad, 3), np.float32)
    src_pad[:src.shape[0]] = src
    mask = np.arange(n_pad) < src.shape[0]
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.01, -0.02, 0.005]
    for r in range(D):
        sl = slice(r * n_local, (r + 1) * n_local)
        qj, ij, nj = jpg.bin_queries_pool(
            jnp.asarray(src_pad[sl]), jnp.asarray(T),
            jnp.asarray(plan["origin"]), jnp.float32(plan["cell_size"]),
            plan["dims"], plan["qp"], plan["tile"],
            mask=jnp.asarray(mask[sl]), shards=D)
        qt, it, nt = tpg.bin_queries_pool(
            torch.as_tensor(src_pad[sl]), torch.as_tensor(T),
            torch.as_tensor(plan["origin"]),
            torch.tensor(plan["cell_size"]), plan["dims"], plan["qp"],
            plan["tile"], mask=torch.as_tensor(mask[sl]), shards=D)
        assert qt.shape[0] == G
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert int(nt) == int(nj)
        # cell centres within 1 ulp at unit scale: XLA fuses origin +
        # (cell + 0.5) * h into an FMA (tests/test_torch_poolgrid.py)
        qt, qj = qt.numpy(), np.asarray(qj)
        cc = [4, 5, 6]
        rest = [c for c in range(qt.shape[1]) if c not in cc]
        np.testing.assert_array_equal(qt[:, rest], qj[:, rest])
        assert np.abs(qt[:, cc] - qj[:, cc]).max() <= 2.0 ** -23


def test_torch_ring_shard_epilogue_matches_jax(rng):
    """Rank 1's first round at D = 2: the slot pass on its shard of the
    table, and the port's epilogue against the reference's with tile0 =
    the shard's first global supertile (which it does not read)."""
    D, rank = 2, 1
    tgt, tn, src = _ring_case(rng, "dense")
    attrs_j, code = jicp.make_target_attrs(JET.PointToPlane,
                                           jnp.asarray(tgt), jnp.asarray(tn))
    plan = jpg.plan_poolgrid(tgt, RADIUS, query_points=src, est=code,
                             shards=D)
    gj = jpg.make_poolgrid(
        jnp.asarray(tgt), attrs_j, plan["origin"], plan["cell_size"],
        plan["dims"], plan["cap"], plan["kc"], est=code, tile=plan["tile"],
        shards=D)
    Gd = gj.n_tiles // D
    rows = slice(rank * Gd * gj.kc, (rank + 1) * Gd * gj.kc)
    shard_j = jpg.PoolGrid(gj.scan[rows], gj.scan_lo[rows], gj.binfields,
                           gj.origin, gj.cell_size, gj.off, gj.dims, gj.cap,
                           gj.kc, gj.est, gj.tile)
    shard_t = bridge.pool_grid_shard(gj, rank, D)
    eye = jnp.eye(4, dtype=jnp.float32)
    qpool_j, _, _ = jpg.bin_queries_pool(
        jnp.asarray(src), eye, gj.origin, gj.cell_size, gj.dims, plan["qp"],
        gj.tile, shards=D)
    block_j = qpool_j.reshape(D, Gd, *qpool_j.shape[1:])[rank]
    block_t = torch.as_tensor(np.array(block_j))
    params_j = jpg.make_params(eye, jnp.float32(RADIUS) ** 2, gj)
    params_t = torch.as_tensor(np.array(params_j))
    assert int((block_t[:, 3] >= 0).sum()) > 100
    for corres in (True, False):
        slot_j = jpg._slot_xla(shard_j, block_j, params_j, exact=corres)
        slot_t = poolgrid_slot.slot_plain(shard_t, block_t, params_t)
        valid = block_t[:, 3] >= 0
        same = float(((slot_t == torch.as_tensor(np.array(slot_j))
                       .to(torch.int32)) & valid).sum()) / int(valid.sum())
        assert same >= (0.995 if corres else 0.97), same
        out_j = jpg._epilogue(shard_j, block_j, slot_j, params_j, code,
                              corres, tile0=Gd)
        # the port's epilogue on the JAX winners: the gather is the same
        out_t = tpg._epilogue(shard_t, block_t,
                              torch.as_tensor(np.array(slot_j)), params_t,
                              code, corres)
        if corres:
            np.testing.assert_array_equal(out_t[1].numpy(),
                                          np.asarray(out_j[1]))
            np.testing.assert_allclose(out_t[0].numpy(),
                                       np.asarray(out_j[0]), rtol=1e-6,
                                       atol=1e-9)
        else:
            ref = np.asarray(out_j)[0]
            np.testing.assert_allclose(out_t.numpy(), ref,
                                       atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the sharded ICP loops
# ---------------------------------------------------------------------------

def test_torch_ring_icp_one_rank_equals_pool_loop(headline):
    tgt, tn, src, T_true = headline
    T, fit, rmse, it, _ = sharded.ring_sharded_registration_icp(
        src, tgt, tn, RADIUS, sharded.make_point_mesh(1, device="cpu"),
        max_iteration=cs.ITERS)
    Ts, _, fits, rmses, its, _ = _single_pool(tgt, tn, src)
    np.testing.assert_array_equal(T, Ts.numpy())
    assert (fit, rmse, it) == (float(fits), float(rmses), its)
    assert np.abs(T - T_true).max() < cs.POSE_TOL


@pytest.mark.parametrize("D", [2, 4])
def test_torch_ring_icp_matches_jax(ranks, headline, D):
    tgt, tn, src, T_true = headline
    outs = [r["ring"] for r in ranks[D]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[0], outs[0][0])
    T, fit, rmse, it, _ = outs[0]
    assert fit > 0.99 and np.abs(T - T_true).max() < cs.POSE_TOL
    Ts, _, fits, _, _, _ = _single_pool(tgt, tn, src)
    assert np.abs(T - Ts.numpy()).max() < POSE_TOL
    assert abs(fit - float(fits)) < FIT_TOL
    if D == 2:
        Tj, fitj, _, _, _ = jax_ring(src, tgt, tn, RADIUS, jax_point_mesh(D),
                                     max_iteration=cs.ITERS)
        assert np.abs(T - Tj).max() < POSE_TOL
        assert abs(fit - fitj) < FIT_TOL


def test_torch_point_sharded_icp_matches_jax(ranks, fallback):
    tgt, tn, src, T_true = fallback
    outs = [r["point"] for r in ranks[2]]
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    T, fit, rmse, it, _ = outs[0]
    assert fit > 0.99 and np.abs(T - T_true).max() < cs.POSE_TOL
    Tj, fitj, _, _, _ = jax_point(src, tgt, tn, RADIUS, jax_point_mesh(2),
                                  max_iteration=cs.ITERS)
    assert np.abs(T - Tj).max() < POSE_TOL and abs(fit - fitj) < FIT_TOL
    T1, fit1, _, _, _ = sharded.sharded_registration_icp(
        src, tgt, tn, RADIUS, sharded.make_point_mesh(1, device="cpu"),
        max_iteration=cs.ITERS)
    assert np.abs(T - T1).max() < POSE_TOL and abs(fit - fit1) < FIT_TOL


def test_torch_sharded_transform(rng):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [1.0, 2.0, 3.0]
    pts = rng.uniform(size=(10, 3)).astype(np.float32)
    out = sharded.sharded_transform(
        sharded.make_point_mesh(device="cpu"))(T, pts)
    np.testing.assert_allclose(out.numpy(), pts + T[:3, 3], rtol=1e-6)


def test_torch_collective_split_runs(ranks):
    a, b = (r["split"] for r in ranks[2])
    assert a == b
    assert a["devices"] == 2 and a["backend"] == "gloo"
    assert a["with_collectives_s"] > 0 and a["without_collectives_s"] > 0
    assert a["ranks_on_card"] == 0 and a["device"] == "cpu"
