"""PyTorch port of the run grid (cupoch_tpu_torch.knn.rungrid and its
two passes, rungrid_fused and rungrid_gmm) against the JAX package on
the CPU.

The same numpy inputs, made from the `rng` seed, go through both
packages. The JAX side runs its plain mirrors (`_fused_query_xla`,
`_gmm_moments_xla`: `use_pallas=False`, its CPU default); the port's
wrappers on CPU tensors run their plain versions `fused_plain` and
`gmm_plain`, which the CUDA kernels match on the card (chip_smoke.py).
Where a pass is compared, the port runs on the JAX grid and queries
(converted with `RunGrid.from_numpy`), so only the pass differs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from cupoch_tpu.knn import bruteforce as jbf
from cupoch_tpu.knn import rungrid as jrg
from cupoch_tpu.registration import fused_icp as jicp
from cupoch_tpu.registration.estimation import (
    TransformationEstimationType as JET,
)
from cupoch_tpu_torch.knn import rungrid as trg
from cupoch_tpu_torch.knn import rungrid_fused, rungrid_gmm
from cupoch_tpu_torch.registration import fused_icp as ticp
from cupoch_tpu_torch.registration.estimation import (
    TransformationEstimationType as TET,
)

RADIUS = 0.07
ESTS = ["PointToPoint", "PointToPlane", "SymmetricMethod"]


def _cloud(rng, n):
    return rng.uniform(size=(n, 3)).astype(np.float32)


def _normals(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _t(a):
    return torch.as_tensor(np.array(a))


def _pose(ang=0.01, t=(0.002, -0.001, 0.003)):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                 [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def _from_jax(g):
    return trg.RunGrid.from_numpy(
        *(np.asarray(x) for x in (g.cand, g.attrp, g.negidx, g.bounds,
                                  g.pack_lohi, g.origin, g.cell_size)),
        g.dims, g.cap, g.kc, g.est, device="cpu")


def _attrs(est_name, tgt, tn):
    """(JAX attrs, torch attrs, estimator code); est_name None: a
    correspondence-only grid."""
    if est_name is None:
        n = tgt.shape[0]
        return jnp.zeros((n, 0), jnp.float32), torch.zeros((n, 0)), 0
    aj, code = jicp.make_target_attrs(JET[est_name], jnp.asarray(tgt),
                                      jnp.asarray(tn))
    at, code_t = ticp.make_target_attrs(TET[est_name], _t(tgt), _t(tn))
    assert code == code_t
    return aj, at, code


def _setup(rng, est_name, m=3000, n=2000, margin=0.25, kc=True):
    tgt = _cloud(rng, m)
    tn = _normals(rng, m)
    src = _cloud(rng, n)
    aj, at, code = _attrs(est_name, tgt, tn)
    plan = jrg.plan_rungrid(tgt, RADIUS, margin=margin, query_points=src,
                            nch=aj.shape[1])
    kcp = plan["kc"] if kc else None
    gj = jrg.make_rungrid(jnp.asarray(tgt), aj, plan["origin"],
                          plan["cell_size"], plan["dims"], plan["cap"],
                          est=code, kc=kcp)
    sym = est_name == "SymmetricMethod"
    extra = _normals(rng, n) if sym else None
    qsj, qij = jrg.bin_queries(
        jnp.asarray(src), jnp.asarray(src), gj.origin, gj.cell_size, gj.dims,
        plan["qcap"], extra=None if extra is None else jnp.asarray(extra),
        n_extra=3 if sym else 0)
    pj = jrg.make_params(jnp.asarray(_pose()), jnp.float32(RADIUS) ** 2, gj)
    return dict(tgt=tgt, tn=tn, src=src, plan=plan, code=code, aj=aj, at=at,
                gj=gj, gt=_from_jax(gj), qsj=qsj, qij=qij, pj=pj,
                qs=_t(qsj), qi=_t(qij), p=_t(pj), extra=extra, kc=kcp)


def _by_index(g):
    """A grid's rows with their lanes ordered by original index (empty
    lanes last): (negidx, cand [Cp, KC, 4], attrp [Cp, KC, P])."""
    ni = np.asarray(g.negidx)
    o = np.argsort(-ni, axis=1, kind="stable")   # -index ascending
    cand = np.take_along_axis(np.asarray(g.cand), o[:, None, :], 2)
    attrp = np.take_along_axis(np.asarray(g.attrp), o[:, None, :], 2)
    return (np.take_along_axis(ni, o, 1), cand.transpose(0, 2, 1),
            attrp.transpose(0, 2, 1))


# ---------------------------------------------------------------------------
# plan, build, state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cloud", ["accepted", "rejected"])
def test_torch_rungrid_plan_identical(rng, cloud):
    tgt = _cloud(rng, 4000)
    if cloud == "rejected":
        # a dense cloud needs a cell cap above 128
        tgt = _cloud(rng, 30000) * 0.2
    src = tgt[:3000] + np.float32([0.004, -0.003, 0.002])
    pj = jrg.plan_rungrid(tgt, RADIUS, query_points=src, nch=4)
    pt = trg.plan_rungrid(tgt, RADIUS, query_points=src, nch=4)
    if cloud == "rejected":
        assert pj is None and pt is None
        return
    assert pj is not None and pj.keys() == pt.keys()
    for k in pj:
        np.testing.assert_array_equal(np.asarray(pj[k]), np.asarray(pt[k]),
                                      err_msg=k)


@pytest.mark.parametrize("est_name", [None] + ESTS)
def test_torch_rungrid_build_matches_jax(rng, est_name):
    """The port's build against the JAX build, row by row with lanes
    ordered by original index: the lane sort is stable in the port and
    not in the JAX package, and a 1-ulp difference in a cell centre
    (XLA fuses origin + (cell + 0.5) * h into an FMA on the CPU) can
    swap two near-equal lanes, or move one across the kc cut. Rows with
    the same candidates: coordinates within 1e-6, packed 16-bit fields
    equal or one quantum apart."""
    s = _setup(rng, est_name, kc=est_name != "PointToPoint")
    plan, gj = s["plan"], s["gj"]
    gt = trg.make_rungrid(_t(s["tgt"]), s["at"], plan["origin"],
                          plan["cell_size"], plan["dims"], plan["cap"],
                          est=s["code"], kc=s["kc"])
    assert (gt.dims, gt.cap, gt.kc, gt.est) == (gj.dims, gj.cap, gj.kc,
                                                 gj.est)
    for name in ("cand", "attrp", "negidx", "bounds"):
        assert tuple(getattr(gt, name).shape) == getattr(gj, name).shape
    np.testing.assert_array_equal(gt.pack_lohi.numpy(),
                                  np.asarray(gj.pack_lohi))
    nj, cj, aj = _by_index(gj)
    nt, ct, at = _by_index(gt)
    same = (nj == nt).all(1)
    assert same.mean() >= 0.999
    assert (nt <= 0).sum() >= 0.999 * (nj <= 0).sum()
    real = (nj <= 0) & same[:, None]
    np.testing.assert_allclose(ct[real], cj[real], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ct[~(nj <= 0)], cj[~(nj <= 0)])
    for shift in (0, 16):
        fj = (aj[real] >> shift) & 0xFFFF
        ft = (at[real] >> shift) & 0xFFFF
        assert np.abs(fj - ft).max(initial=0) <= 1
    bj, bt = np.asarray(gj.bounds), gt.bounds.numpy()
    fin = np.isfinite(bj)
    fs = fin & same[:, None]
    assert (np.isfinite(bt) == fin)[same].all()
    np.testing.assert_allclose(bt[fs], bj[fs], rtol=0, atol=1e-6)


def test_torch_rungrid_state_conversion_round_trip(rng):
    gj = _setup(rng, "SymmetricMethod", m=1500, n=1000)["gj"]
    gt = _from_jax(gj)
    for name in ("cand", "attrp", "negidx", "bounds", "pack_lohi", "origin"):
        a = getattr(gt, name).numpy()
        b = np.asarray(getattr(gj, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert float(gt.cell_size) == float(gj.cell_size)
    assert (gt.dims, gt.cap, gt.kc, gt.est, gt.n_windows) == \
        (gj.dims, gj.cap, gj.kc, gj.est, gj.n_windows)


def test_torch_rungrid_bin_queries_matches_jax(rng):
    """Per source query: the same cell and slot, coordinates and extras
    equal; >= 99.9% agree (XLA's fused binning transform may round a
    position on a cell boundary into the other cell)."""
    s = _setup(rng, "SymmetricMethod")
    gj, plan, src = s["gj"], s["plan"], s["src"]
    T = _pose()
    pos_j = jnp.asarray(src) @ jnp.asarray(T[:3, :3]).T + T[:3, 3]
    qj, ij = jrg.bin_queries(jnp.asarray(src), pos_j, gj.origin,
                             gj.cell_size, gj.dims, plan["qcap"],
                             extra=jnp.asarray(s["extra"]), n_extra=3)
    gt = s["gt"]
    qt, it = trg.bin_queries(_t(src), _t(src) @ _t(T[:3, :3]).T
                             + _t(T[:3, 3]), gt.origin, gt.cell_size,
                             gt.dims, plan["qcap"], extra=_t(s["extra"]),
                             n_extra=3)
    assert qt.shape == qj.shape and it.dtype == torch.int32
    ij, it, qj, qt = np.asarray(ij), it.numpy(), np.asarray(qj), qt.numpy()
    n = src.shape[0]
    where_j = np.full(n, -1)
    where_t = np.full(n, -1)
    where_j[ij[ij >= 0]] = np.flatnonzero(ij.reshape(-1) >= 0)
    where_t[it[it >= 0]] = np.flatnonzero(it.reshape(-1) >= 0)
    agree = where_j == where_t
    assert agree.mean() >= 0.999
    flat_j = qj.transpose(0, 2, 1).reshape(-1, qj.shape[1])
    flat_t = qt.transpose(0, 2, 1).reshape(-1, qt.shape[1])
    k = where_j[agree & (where_j >= 0)]
    np.testing.assert_array_equal(flat_t[k], flat_j[k])
    # empty slots: the cell centre (pad rows: the origin), within 1 ulp
    empty = (ij < 0) & (it < 0)
    np.testing.assert_allclose(
        qt.transpose(0, 2, 1)[empty][:, :3],
        qj.transpose(0, 2, 1)[empty][:, :3], rtol=0, atol=2.0 ** -23)


# ---------------------------------------------------------------------------
# the fused pass (kernel 2's plain version) and the 1-NN query
# ---------------------------------------------------------------------------

def test_torch_fused_corres_matches_jax(rng):
    s = _setup(rng, "PointToPlane")
    d2j, nij = jrg.fused_query(s["gj"], s["qsj"], s["qij"], s["pj"],
                               jrg.EST_NONE, True, use_pallas=False)
    d2t, nit = rungrid_fused.fused_query(s["gt"], s["qs"], s["qi"], s["p"],
                                         trg.EST_NONE, True)
    d2j, nij = np.asarray(d2j), np.asarray(nij)
    d2t, nit = d2t.numpy(), nit.numpy()
    fin = np.isfinite(d2j)
    assert fin.sum() > 1000
    assert (np.isfinite(d2t) == fin).all()
    assert (nit[~fin] == 1.0).all()
    assert (nit == nij)[fin].mean() >= 0.999
    np.testing.assert_allclose(d2t[fin], d2j[fin], rtol=0, atol=1e-6)


@pytest.mark.parametrize("est_name", ESTS)
def test_torch_fused_gn_sums_match_jax(rng, est_name):
    """The summed GN (Kabsch for PT2PT) row; the JAX mirror returns one
    row per tile of 8 cells, the port their sum (rtol 1e-4 of the row's
    largest magnitude)."""
    s = _setup(rng, est_name)
    sj = np.asarray(jnp.sum(jrg.fused_query(
        s["gj"], s["qsj"], s["qij"], s["pj"], s["code"], False,
        use_pallas=False), 0))
    st = rungrid_fused.fused_query(s["gt"], s["qs"], s["qi"], s["p"],
                                   s["code"], False)
    assert st.shape == (trg.N_SUMS,)
    np.testing.assert_allclose(st.numpy(), sj, rtol=0,
                               atol=1e-4 * np.abs(sj).max())
    count = 0 if est_name == "PointToPoint" else 27
    assert st[count] == sj[count] and sj[count] > 1000


def test_torch_query_nn_rungrid_matches_jax_and_bruteforce(rng):
    tgt = _cloud(rng, 3000)
    q = _cloud(rng, 600)
    r = 0.08
    plan = jrg.plan_rungrid(tgt, r, margin=0.0)
    gj = jrg.make_rungrid(jnp.asarray(tgt), jnp.zeros((3000, 0)),
                          plan["origin"], plan["cell_size"], plan["dims"],
                          plan["cap"])
    ij, dj = jrg.query_nn_rungrid(gj, jnp.asarray(q), r, plan["qcap"])
    gt = trg.make_rungrid(_t(tgt), torch.zeros((3000, 0)), plan["origin"],
                          plan["cell_size"], plan["dims"], plan["cap"])
    it, dt = rungrid_fused.query_nn_rungrid(gt, _t(q), r, plan["qcap"])
    ij, dj, it, dt = np.asarray(ij), np.asarray(dj), it.numpy(), dt.numpy()
    assert it.dtype == np.int32 and it.shape == (600,)
    np.testing.assert_array_equal(it >= 0, ij >= 0)
    assert (it == ij).mean() >= 0.999
    ok = it >= 0
    np.testing.assert_allclose(dt[ok], dj[ok], rtol=0, atol=1e-6)
    assert np.isinf(dt[~ok]).all()
    # the exact brute force within r: same distances; same index but
    # on exact ties
    bi, bd = jbf.knn_search(jnp.asarray(q), jnp.asarray(tgt), 1)
    bi, bd = np.asarray(bi)[:, 0], np.asarray(bd)[:, 0]
    inr = bd <= r * r
    np.testing.assert_array_equal(ok, inr)
    np.testing.assert_allclose(dt[ok], bd[ok], rtol=0, atol=2e-6)
    assert (it[ok] == bi[ok]).mean() >= 0.999


# ---------------------------------------------------------------------------
# the Gaussian-moment pass (kernel 3's plain version)
# ---------------------------------------------------------------------------

def test_torch_gmm_moments_match_jax(rng):
    """Both the centred moments of the pass and the world-frame moments
    of `gmm_moments`, held to the JAX mirror at rtol 2e-5, atol 1e-5,
    as tests/test_filterreg.py holds the Pallas kernel to it."""
    s = _setup(rng, None, margin=0.0)
    sigma = 0.03
    pj = jrg.make_params(jnp.asarray(_pose()), jnp.float32(RADIUS) ** 2,
                         s["gj"], inv_2s2=jnp.float32(1 / (2 * sigma ** 2)))
    p = _t(pj)
    raw_j = jrg._gmm_moments_xla(s["gj"], s["qsj"], s["qij"], pj)
    raw_t = rungrid_gmm.gmm_pass(s["gt"], s["qs"], s["qi"], p)
    for a, b in zip(raw_j, raw_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=1e-5)
    world_j = jrg.gmm_moments(s["gj"], s["qsj"], s["qij"], pj,
                              use_pallas=False)
    world_t = rungrid_gmm.gmm_moments(s["gt"], s["qs"], s["qi"], p)
    assert world_t[1].shape == world_j[1].shape
    for a, b in zip(world_j, world_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=1e-5)
    assert float(world_t[0].sum()) > 100.0


def test_torch_rungrid_wrappers_check_inputs(rng):
    """A CPU tensor runs the plain version and leaves the launch counts
    unchanged; the plain versions give the same result whatever their
    chunking; a bad dtype, shape or layout raises."""
    s = _setup(rng, "PointToPlane", m=1500, n=1000)
    gt, qs, qi, p = s["gt"], s["qs"], s["qi"], s["p"]
    before = dict(rungrid_fused.launches), rungrid_gmm.launches
    full = rungrid_fused.fused_query(gt, qs, qi, p, trg.EST_NONE, True)
    sums = rungrid_fused.fused_query(gt, qs, qi, p, trg.EST_PT2PL, False)
    mom = rungrid_gmm.gmm_pass(gt, qs, qi, p)
    assert (dict(rungrid_fused.launches), rungrid_gmm.launches) == before
    # the plain versions again in chunks of `step` cells (the whole grid
    # is one chunk above): at least 3 chunks, the last one ragged
    cp, qcap = qs.shape[0], qs.shape[2]
    step = cp // 4 + 1
    assert cp // step >= 3 and cp % step and step > 1
    olds = rungrid_fused._PLAIN_CHUNK_BYTES, rungrid_gmm._PLAIN_CHUNK_BYTES
    try:
        rungrid_fused._PLAIN_CHUNK_BYTES = step * qcap * gt.kc * 4
        rungrid_gmm._PLAIN_CHUNK_BYTES = step * qcap * gt.kc * 4
        one = rungrid_fused.fused_query(gt, qs, qi, p, trg.EST_NONE, True)
        sums1 = rungrid_fused.fused_query(gt, qs, qi, p, trg.EST_PT2PL,
                                          False)
        mom1 = rungrid_gmm.gmm_pass(gt, qs, qi, p)
    finally:
        rungrid_fused._PLAIN_CHUNK_BYTES, rungrid_gmm._PLAIN_CHUNK_BYTES = \
            olds
    assert all(torch.equal(a, b) for a, b in zip(full, one))
    assert all(torch.equal(a, b) for a, b in zip(mom, mom1))
    torch.testing.assert_close(sums1, sums, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        rungrid_fused.fused_query(gt, qs.double(), qi, p, trg.EST_NONE, True)
    with pytest.raises(TypeError):
        rungrid_gmm.gmm_pass(gt, qs, qi.long(), p)
    with pytest.raises(ValueError):
        rungrid_fused.fused_query(gt, qs[:-1].contiguous(), qi, p,
                                  trg.EST_NONE, True)
    with pytest.raises(ValueError):
        rungrid_gmm.gmm_pass(gt, qs[:, :, ::2], qi[:, ::2], p)
    with pytest.raises(ValueError):   # a GN pass for another estimator
        rungrid_fused.fused_query(gt, qs, qi, p, trg.EST_SYM, False)


# ---------------------------------------------------------------------------
# kernel 2's built edge cases (chip_smoke.fused_edge_case; chip_smoke.py
# holds the CUDA kernel to fused_plain on the same input)
# ---------------------------------------------------------------------------

def _fused_edge(case):
    """(port grid, qsoa, qidx, params), (JAX grid, qsoa, qidx, params)."""
    port = chip_smoke.fused_edge_grid(torch, trg, case, "cpu")
    gj = jrg.RunGrid(*(jnp.asarray(case[k]) for k in (
        "cand", "attrp", "negidx", "bounds", "pack_lohi", "origin",
        "cell_size")), case["dims"], 8, case["kc"], jrg.EST_PT2PL)
    pj = jrg.make_params(jnp.eye(4, dtype=jnp.float32),
                         jnp.float32(case["r2"]), gj)
    return port, (gj, jnp.asarray(case["qsoa"]), jnp.asarray(case["qidx"]),
                  pj)


@pytest.mark.parametrize("mode", ["corres", "gn"])
def test_torch_fused_plain_built_cases_match_jax(mode):
    """fused_plain against the JAX mirror `_fused_query_xla` on kernel 2's
    built cases (near-equal |e| gate, exact ties across windows, threads
    and within a thread, more queries than a pass, rows without a lane
    or a query), with test_torch_fused_*'s tolerances; the corres winners
    follow the kernel header's contract: the tie goes to the smallest
    index, and only the farther query of the gate case finds its lane."""
    case = chip_smoke.fused_edge_case(np)
    port, jax_in = _fused_edge(case)
    if mode == "corres":
        d2t, nit = (x.numpy() for x in rungrid_fused.fused_query(
            *port, trg.EST_NONE, True))
        d2j, nij = (np.asarray(x) for x in jrg.fused_query(
            *jax_in, jrg.EST_NONE, True, use_pallas=False))
        fin = np.isfinite(d2j)
        assert (np.isfinite(d2t) == fin).all() and fin.sum() >= 12
        np.testing.assert_array_equal(nit, nij)
        np.testing.assert_allclose(d2t[fin], d2j[fin], rtol=0, atol=1e-6)
        ties = case["ties"]
        assert nit[ties["tie_cross"][:2]] == -7.0
        assert nit[ties["tie_thread"][:2]] == -12.0
        cell, slot, (lane,) = ties["gate"]
        assert nit[cell, slot] == case["negidx"][cell, lane]
        assert np.isinf(d2t[cell, 1])             # A: nothing within r
        assert np.isinf(d2t[3, 0]) and nit[3, 0] == 1.0   # no real lane
        assert np.isfinite(d2t[2]).sum() >= 5     # the 20-query cell
    else:
        st = rungrid_fused.fused_query(*port, trg.EST_PT2PL, False).numpy()
        sj = np.asarray(jnp.sum(jrg.fused_query(
            *jax_in, jrg.EST_PT2PL, False, use_pallas=False), 0))
        np.testing.assert_allclose(st, sj, rtol=0,
                                   atol=1e-4 * np.abs(sj).max())
        assert st[27] == sj[27] and sj[27] >= 8


@pytest.mark.parametrize("mode", ["corres", "gn"])
def test_torch_fused_plain_tie_rule(mode):
    """The tie rule of csrc/rungrid_fused.cu's header on the built exact
    ties: an exact tie takes, per channel, the largest word over the tied
    lanes (corres: -index, so the smallest index). Giving every tied lane
    that word leaves fused_plain's result bit for bit the same."""
    case = chip_smoke.fused_edge_case(np)
    moved = {k: v.copy() if isinstance(v, np.ndarray) else v
             for k, v in case.items()}
    for name in ("tie_cross", "tie_thread"):
        cell, _, lanes = case["ties"][name]
        words = case["attrp"][cell][:, lanes]
        assert (words[:, 0] != words[:, 1]).all()
        moved["attrp"][cell][:, lanes] = words.max(1, keepdims=True)
        moved["negidx"][cell, lanes] = case["negidx"][cell, lanes].max()
    a, _ = _fused_edge(case)
    b, _ = _fused_edge(moved)
    if mode == "corres":
        for x, y in zip(rungrid_fused.fused_query(*a, trg.EST_NONE, True),
                        rungrid_fused.fused_query(*b, trg.EST_NONE, True)):
            assert torch.equal(x, y)
    else:
        assert torch.equal(
            rungrid_fused.fused_query(*a, trg.EST_PT2PL, False),
            rungrid_fused.fused_query(*b, trg.EST_PT2PL, False))
