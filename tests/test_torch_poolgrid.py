"""PyTorch port of the pooled grid (cupoch_tpu_torch.knn.poolgrid)
against the JAX package on the CPU.

The same numpy inputs, made from the `rng` seed, go through both
packages. The JAX side runs its plain slot mirror (`use_pallas=False`),
as tests/test_poolgrid.py runs it on the CPU; the port's slot pass on
CPU tensors runs its plain version `slot_plain`, which agrees bit for
bit with the CUDA kernel.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from cupoch_tpu.knn import poolgrid as jpg
from cupoch_tpu.registration import fused_icp as jicp
from cupoch_tpu.registration.estimation import (
    TransformationEstimationType as JET,
)
from cupoch_tpu_torch.knn import poolgrid as tpg
from cupoch_tpu_torch.knn import poolgrid_slot
from cupoch_tpu_torch.registration import fused_icp as ticp
from cupoch_tpu_torch.registration.estimation import (
    TransformationEstimationType as TET,
)

RADIUS = 0.06
ESTS = ["PointToPoint", "PointToPlane", "SymmetricMethod"]


def _cloud(rng, n):
    return rng.uniform(size=(n, 3)).astype(np.float32)


def _normals(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _shell(rng, n):
    """Points on a sphere shell: a surface cloud whose plan compacts."""
    return (1.0 + 0.95 * _normals(rng, n)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_grid(tgt, attrs_j, plan, est_code, active=False):
    return jpg.make_poolgrid(
        jnp.asarray(tgt), attrs_j, plan["origin"], plan["cell_size"],
        plan["dims"], plan["cap"], plan["kc"], est=est_code,
        tile=plan["tile"],
        active_cells=plan["active_cells"] if active else None)


def _torch_grid(tgt, attrs_t, plan, est_code, active=False):
    return tpg.make_poolgrid(
        _t(tgt), attrs_t, plan["origin"], plan["cell_size"],
        plan["dims"], plan["cap"], plan["kc"], est=est_code,
        tile=plan["tile"],
        active_cells=plan["active_cells"] if active else None)


def _from_jax(g):
    return tpg.PoolGrid.from_numpy(
        np.asarray(g.scan), np.asarray(g.scan_lo), np.asarray(g.binfields),
        np.asarray(g.origin), np.asarray(g.cell_size), np.asarray(g.off),
        g.dims, g.cap, g.kc, g.est, g.tile,
        n_dropped=np.asarray(g.n_dropped),
        cell_map=None if g.cell_map is None else np.asarray(g.cell_map),
        device="cpu")


def _jax_table_f32(g):
    """The JAX scan + scan_lo re-laid out cell-major [C_pad, KC, 4]."""
    s = np.asarray(g.scan).astype(np.float32) \
        + np.asarray(g.scan_lo).astype(np.float32)
    G = s.shape[0] // g.kc
    return s.reshape(G, g.kc, g.tile, 4).transpose(0, 2, 1, 3) \
        .reshape(G * g.tile, g.kc, 4)


def _setup(rng, est_name, m=4000, n=3000):
    tgt = _cloud(rng, m)
    tn = _normals(rng, m)
    src = _cloud(rng, n)
    attrs_j, est_code = jicp.make_target_attrs(
        JET[est_name], jnp.asarray(tgt), jnp.asarray(tn))
    plan = jpg.plan_poolgrid(tgt, RADIUS, margin=0.25, query_points=src,
                             est=est_code)
    grid_j = _jax_grid(tgt, attrs_j, plan, est_code)
    eye_j = jnp.eye(4, dtype=jnp.float32)
    extra_j = jnp.asarray(tn[:n]) if est_name == "SymmetricMethod" \
        else None
    n_extra = jpg.n_query_extra(est_code)
    qpool_j, qidx_j, _ = jpg.bin_queries_pool(
        jnp.asarray(src), eye_j, grid_j.origin, grid_j.cell_size,
        grid_j.dims, plan["qp"], plan["tile"], extra=extra_j,
        n_extra=n_extra)
    params_j = jpg.make_params(eye_j, jnp.float32(RADIUS) ** 2, grid_j)
    return dict(tgt=tgt, tn=tn, src=src, plan=plan, est=est_code,
                grid_j=grid_j, qpool_j=qpool_j, qidx_j=qidx_j,
                params_j=params_j, extra=extra_j, n_extra=n_extra)


def _scatter(qidx, vals, n, fill):
    out = np.full(n, fill, np.float64)
    qi = np.asarray(qidx).reshape(-1)
    v = np.asarray(vals).reshape(-1)
    ok = qi >= 0
    out[qi[ok]] = v[ok]
    return out


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cloud", ["volume", "surface"])
def test_torch_plan_identical(rng, cloud):
    if cloud == "volume":
        tgt = _cloud(rng, 4000)
    else:
        tgt = _shell(rng, 6000)
    src = tgt + np.float32([0.004, -0.003, 0.002])
    pj = jpg.plan_poolgrid(tgt, RADIUS, query_points=src,
                           est=jpg.EST_PT2PL)
    pt = tpg.plan_poolgrid(tgt, RADIUS, query_points=src,
                           est=tpg.EST_PT2PL)
    assert pj is not None and pt is not None
    assert (pt["active_cells"] is None) == (cloud == "volume")
    assert pj.keys() == pt.keys()
    for k in pj:
        if k == "active_cells" and pj[k] is not None:
            np.testing.assert_array_equal(pj[k], pt[k])
        else:
            np.testing.assert_array_equal(np.asarray(pj[k]),
                                          np.asarray(pt[k]), err_msg=k)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_torch_build_matches_jax(rng, layout):
    if layout == "dense":
        tgt = _cloud(rng, 4000)
    else:
        tgt = _shell(rng, 6000)
    tn = _normals(rng, tgt.shape[0])
    est = JET.PointToPlane
    attrs_j, code = jicp.make_target_attrs(est, jnp.asarray(tgt),
                                           jnp.asarray(tn))
    attrs_t, code_t = ticp.make_target_attrs(TET.PointToPlane, _t(tgt),
                                             _t(tn))
    assert code == code_t
    plan = jpg.plan_poolgrid(tgt, RADIUS, query_points=tgt, est=code)
    compact = layout == "compact"
    assert (plan["active_cells"] is not None) == compact
    gj = _jax_grid(tgt, attrs_j, plan, code, active=compact)
    gt = _torch_grid(tgt, attrs_t, plan, code, active=compact)
    bj = np.asarray(gj.binfields)
    bt = gt.binfields.numpy()
    np.testing.assert_array_equal(bt[:, -1], bj[:, -1])
    np.testing.assert_allclose(bt, bj, rtol=1e-6, atol=1e-6)
    assert int(gt.n_dropped) == int(gj.n_dropped)
    ref = _jax_table_f32(gj)
    assert gt.table.shape == ref.shape
    np.testing.assert_allclose(gt.table.numpy(), ref, rtol=2.0 ** -15,
                               atol=1e-6)
    assert float(gt.off) == float(gj.off)
    if compact:
        np.testing.assert_array_equal(gt.cell_map.numpy(),
                                      np.asarray(gj.cell_map))


def test_torch_build_overflow_drop_count(rng):
    # one dense clump forces per-cell cap overflow (tests/test_poolgrid.py
    # test_overflow_reported): both packages count the same drops
    tgt = np.concatenate([
        _cloud(rng, 2000),
        np.float32([[0.5, 0.5, 0.5]]) + rng.normal(
            size=(3000, 3)).astype(np.float32) * 1e-4])
    plan = jpg.plan_poolgrid(tgt, 0.05, margin=0.25, cap_percentile=90.0)
    assert plan is not None
    gj = jpg.make_poolgrid(
        jnp.asarray(tgt), jnp.zeros((tgt.shape[0], 0), jnp.float32),
        plan["origin"], plan["cell_size"], plan["dims"], plan["cap"],
        plan["kc"])
    gt = tpg.make_poolgrid(
        _t(tgt), torch.zeros((tgt.shape[0], 0)), plan["origin"],
        plan["cell_size"], plan["dims"], plan["cap"], plan["kc"])
    assert int(gj.n_dropped) > 0
    assert int(gt.n_dropped) == int(gj.n_dropped)


def test_torch_state_conversion_round_trip(rng):
    s = _setup(rng, "PointToPlane", m=2000, n=1500)
    gj = s["grid_j"]
    gt = _from_jax(gj)
    # back to the JAX lanes-major layout
    G = gt.n_tiles
    back = gt.table.numpy().reshape(G, gt.tile, gt.kc, 4) \
        .transpose(0, 2, 1, 3).reshape(G * gt.kc, gt.tile * 4)
    np.testing.assert_array_equal(
        back, np.asarray(gj.scan).astype(np.float32)
        + np.asarray(gj.scan_lo).astype(np.float32))
    np.testing.assert_array_equal(gt.binfields.numpy(),
                                  np.asarray(gj.binfields))
    np.testing.assert_array_equal(gt.origin.numpy(), np.asarray(gj.origin))
    assert float(gt.cell_size) == float(gj.cell_size)
    assert float(gt.off) == float(gj.off)
    assert int(gt.n_dropped) == int(gj.n_dropped)
    assert (gt.dims, gt.cap, gt.kc, gt.est, gt.tile) == \
        (gj.dims, gj.cap, gj.kc, gj.est, gj.tile)
    assert gt.cell_map is None and gj.cell_map is None


# ---------------------------------------------------------------------------
# query binning
# ---------------------------------------------------------------------------

def test_torch_bin_queries_matches_jax(rng):
    s = _setup(rng, "SymmetricMethod")
    gj, plan, src = s["grid_j"], s["plan"], s["src"]
    gt = _from_jax(gj)
    ang = 0.01
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                 [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    T[:3, 3] = [0.003, -0.002, 0.001]
    qj, ij, ndj = jpg.bin_queries_pool(
        jnp.asarray(src), jnp.asarray(T), gj.origin, gj.cell_size,
        gj.dims, plan["qp"], plan["tile"], extra=s["extra"],
        n_extra=s["n_extra"])
    qt, it, ndt = tpg.bin_queries_pool(
        _t(src), _t(T), gt.origin, gt.cell_size, gt.dims, plan["qp"],
        plan["tile"], extra=_t(np.asarray(s["extra"])),
        n_extra=s["n_extra"])
    assert qt.shape == qj.shape
    assert int(ndt) == int(ndj)
    n = src.shape[0]
    qj, qt = np.asarray(qj), qt.numpy()
    # per source query, scattered back to source order: coordinates,
    # tag and extras equal, cell centre within 1 ulp at unit scale (XLA
    # fuses origin + (cell + 0.5) * h into one FMA on the CPU; the port
    # rounds the product and the sum apiece). XLA's CPU fusion may also
    # round a bin position on a cell boundary into the other cell, so
    # >= 99.9% of queries must agree.
    agree = np.ones(n, bool)
    for ch in range(qj.shape[1]):
        a = _scatter(ij, qj[:, ch], n, np.nan)
        b = _scatter(it, qt[:, ch], n, np.nan)
        tol = 2.0 ** -23 if ch in (4, 5, 6) else 0.0
        agree &= np.abs(a - b) <= tol
    assert agree.mean() >= 0.999


# ---------------------------------------------------------------------------
# slot pass + epilogue
# ---------------------------------------------------------------------------

def test_torch_corres_pass_matches_jax(rng):
    s = _setup(rng, "PointToPlane")
    gj, n = s["grid_j"], s["src"].shape[0]
    gt = _from_jax(gj)
    qt = _t(s["qpool_j"])
    pt = _t(s["params_j"])
    d2j, idxj = jpg.fused_pool_query(gj, s["qpool_j"], s["params_j"],
                                     s["est"], True, use_pallas=False)
    d2t, idxt = tpg.fused_pool_query(gt, qt, pt, s["est"], True)
    d2j = _scatter(s["qidx_j"], d2j, n, np.inf)
    d2t = _scatter(s["qidx_j"], d2t.numpy(), n, np.inf)
    ij = _scatter(s["qidx_j"], idxj, n, -1)
    it = _scatter(s["qidx_j"], idxt.numpy(), n, -1)
    found = np.isfinite(d2j)
    assert (found == np.isfinite(d2t)).all()
    same = found & (ij == it)
    assert same.sum() >= 0.995 * found.sum()
    np.testing.assert_allclose(d2t[same], d2j[same], atol=1e-6)


@pytest.mark.parametrize("est_name", ESTS)
def test_torch_epilogue_sums_match_jax(rng, est_name):
    s = _setup(rng, est_name, m=3000, n=2000)
    gj = s["grid_j"]
    gt = _from_jax(gj)
    slotf = jpg._slot_xla(gj, s["qpool_j"], s["params_j"], exact=True)
    sj = jpg._epilogue(gj, s["qpool_j"], slotf, s["params_j"], s["est"],
                       False)
    st = tpg._epilogue(gt, _t(s["qpool_j"]), _t(slotf).to(torch.int32),
                       _t(s["params_j"]), s["est"], False)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj)[0], rtol=2e-5,
                               atol=1e-4)


def test_torch_slot_plain_chunks_and_pad_lanes(rng):
    """slot_plain gives the same slots whatever its chunking, gives
    empty pool lanes slot 0 (as the TPU kernel does), and never picks
    a pad slot past 27*cap when a real candidate exists."""
    s = _setup(rng, "PointToPoint", m=2000, n=1500)
    gt = _from_jax(s["grid_j"])
    qt, pt = _t(s["qpool_j"]), _t(s["params_j"])
    full = poolgrid_slot.slot_pass(gt, qt, pt)
    old = poolgrid_slot._PLAIN_CHUNK_BYTES
    try:
        poolgrid_slot._PLAIN_CHUNK_BYTES = 1
        one = poolgrid_slot.slot_plain(gt, qt, pt)
    finally:
        poolgrid_slot._PLAIN_CHUNK_BYTES = old
    assert torch.equal(full, one)
    assert full.dtype == torch.int32
    empty = qt[:, 3] < 0
    assert (full[empty] == 0).all()
    assert (full[~empty] < 27 * gt.cap).all()


def test_torch_slot_pass_checks_inputs(rng):
    s = _setup(rng, "PointToPoint", m=2000, n=1500)
    gt = _from_jax(s["grid_j"])
    qt, pt = _t(s["qpool_j"]), _t(s["params_j"])
    with pytest.raises(TypeError):
        poolgrid_slot.slot_pass(gt, qt.double(), pt)
    with pytest.raises(ValueError):
        poolgrid_slot.slot_pass(gt, qt[:-1].contiguous(), pt)
    with pytest.raises(ValueError):
        poolgrid_slot.slot_pass(gt, qt[:, :, ::2], pt)
    before = poolgrid_slot.launches
    poolgrid_slot.slot_pass(gt, qt, pt)
    assert poolgrid_slot.launches == before   # CPU: no kernel launch


# ---------------------------------------------------------------------------
# kernel 1's built edge cases (chip_smoke.slot_edge_case; chip_smoke.py
# holds the CUDA kernel to slot_plain on the same input)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _slot_edge():
    """(case, slot_plain's slots, the JAX mirror's slots), both [G, QP]."""
    case = chip_smoke.slot_edge_case(np)
    grid_t, qt, pt = chip_smoke.slot_edge_grid(torch, tpg, case, "cpu")
    T, KC = case["tile"], case["kc"]
    G = case["qpool"].shape[0]
    # the JAX grid's lanes-major bf16 table, every value exact in bf16
    # (the empty slots' 3e18 as 2^61: both far above any real score)
    scan = case["table"].reshape(G, T, KC, 4).transpose(0, 2, 1, 3) \
        .reshape(G * KC, 4 * T)
    scan = np.where(scan == np.float32(3e18), np.float32(2.0 ** 61), scan)
    assert (np.asarray(jnp.asarray(scan, jnp.bfloat16), np.float32)
            == scan).all()
    grid_j = jpg.PoolGrid(
        jnp.asarray(scan, jnp.bfloat16), jnp.zeros(scan.shape, jnp.bfloat16),
        jnp.zeros((1, 4)), jnp.zeros(3), jnp.float32(1.0),
        jnp.float32(case["params"][13]), (4, 4, 2 * G), case["cap"], KC, 0,
        T)
    want = jpg._slot_xla(grid_j, jnp.asarray(case["qpool"]),
                         jnp.asarray(case["params"]), exact=True)
    return (case, poolgrid_slot.slot_plain(grid_t, qt, pt).numpy(),
            np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("part", ["one_cell", "small_cells", "equal_keys",
                                  "empty_row", "empty_lanes"])
def test_torch_slot_plain_built_cases_match_jax(part):
    """slot_plain against the JAX mirror `_slot_xla` on kernel 1's built
    cases: every valid lane's slot equal (the scores are exact, so the
    keys are too); equal keys go to the lower slot (slot 4, not 9), a row
    without a real slot gives slot 0, and tag -1 lanes get slot 0, as the
    kernel's header says (the mirror scores them against cell 0)."""
    case, got, want = _slot_edge()
    g, lanes = case["parts"][part]
    valid = case["qpool"][g, 3] >= 0
    np.testing.assert_array_equal(got[g][lanes & valid],
                                  want[g][lanes & valid])
    assert (got[g][~valid] == 0).all()
    if part == "equal_keys":
        assert lanes.sum() == 9 and (got[g][lanes] == 4).all()
    elif part == "empty_row":
        assert lanes.sum() == 1 and (got[g][lanes] == 0).all()
    elif part == "empty_lanes":
        assert not valid.any()
    else:
        assert (lanes & valid).sum() >= 83

