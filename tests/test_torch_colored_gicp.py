"""PyTorch port of Colored ICP and Generalized ICP's building blocks
against the JAX package on the CPU: the closed-form 3x3 eigen helpers,
GICP covariances, the colour gradient, the generic loop's Colored/GICP
updates and the pooled grid's Colored/GICP epilogue sums. Normal
estimation is in tests/test_torch_normals.py, the end-to-end
registrations in tests/test_torch_colored_gicp_icp.py.

Several of these quantities are ill-conditioned in f32: the closed-form
eigenvalues of nearly equal pairs, the normal of a flat neighbourhood
(its eigenvalue gap is tiny), the half-turn of `rotation_e1_to_x` near
an antiparallel vector, and the colour gradient's 3x3 solve. Where XLA
contracts products into FMAs on the CPU, the two packages then differ
by what that rounding is worth, so those cases hold the port to the
reference's own accuracy against an f64 computation, as stated in each.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.knn import poolgrid as jpg
from cupoch_tpu.registration import colored_icp as jcol
from cupoch_tpu.registration import estimation as jest
from cupoch_tpu.registration import fused_icp as jicp
from cupoch_tpu.registration import generalized_icp as jgicp
from cupoch_tpu.registration.estimation import (
    TransformationEstimationType as JET,
)
from cupoch_tpu.utility import eigen as jeigen
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
import cupoch_tpu_torch.knn as tknn
from cupoch_tpu_torch.knn import KDTreeSearchParamRadius as TRadius
from cupoch_tpu_torch.knn import poolgrid as tpg
from cupoch_tpu_torch.registration import colored_icp as tcol
from cupoch_tpu_torch.registration import estimation as test_
from cupoch_tpu_torch.registration import fused_icp as ticp
from cupoch_tpu_torch.registration import generalized_icp as tgicp
from cupoch_tpu_torch.utility import eigen as teigen


def _cloud(rng, n):
    return rng.uniform(size=(n, 3)).astype(np.float32)


def _normals(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _psd(rng, n, scale=0.01, eps=1e-3):
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return (np.einsum("nij,nkj->nik", a, a) * scale
            + np.eye(3, dtype=np.float32) * eps).astype(np.float32)


def _sheet(rng, n, side=1.0):
    """A wavy sheet with a smooth colour field (tests/test_icp_variants.py's
    surface, scaled to `side`)."""
    xy = rng.uniform(0, side, size=(n, 2)).astype(np.float32)
    z = 0.25 * np.sin(2.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    c = 0.5 + 0.4 * np.sin(4.0 * pts[:, :1]) * np.cos(3.0 * pts[:, 1:2])
    return pts, np.repeat(c, 3, axis=1).astype(np.float32)


def _sheet_normals(pts):
    """Unit normals of `_sheet`'s surface z = f(x, y)."""
    x, y = pts[:, 0], pts[:, 1]
    fx = 0.25 * 2.5 * np.cos(2.5 * x) * np.cos(1.5 * y)
    fy = -0.25 * 1.5 * np.sin(2.5 * x) * np.sin(1.5 * y)
    v = np.column_stack([-fx, -fy, np.ones_like(x)])
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _align_sign(a, b):
    """b's rows flipped to point the way a's do."""
    s = np.sign((a * b).sum(-1, keepdims=True))
    return b * np.where(s == 0, 1.0, s)


# ---------------------------------------------------------------------------
# eigen helpers, covariances, normals
# ---------------------------------------------------------------------------

def test_torch_symeig3x3_and_sqrtm_match_jax(rng):
    """Eigenvalues within 1e-5 (relative to the largest) plus twice the
    reference's own error against f64 `eigvalsh` (the trigonometric
    formula loses digits on nearly equal pairs), eigenvectors up to sign
    within 1e-4 where the eigenvalues are apart, sqrtm within 1e-5 of its
    largest entry plus twice the reference's largest error in that
    matrix; plus
    isotropic and rank-deficient matrices."""
    A = _psd(rng, 500, scale=1.0, eps=0.0)
    A[0] = np.eye(3) * 2.0
    A[1] = np.diag([0.0, 1.0, 1.0])
    vj, Vj = (np.asarray(x) for x in jeigen.symeig3x3(jnp.asarray(A)))
    vt, Vt = (x.numpy() for x in teigen.symeig3x3(torch.as_tensor(A)))
    scale = np.abs(vj).max(-1, keepdims=True)
    ref_err = np.abs(vj - np.linalg.eigvalsh(A.astype(np.float64)))
    assert (np.abs(vt - vj) <= 1e-5 * scale + 2.0 * ref_err).all()
    gap = np.diff(vj, axis=-1)
    apart = (gap > 1e-2 * scale).all(-1)
    for i in range(3):
        a, b = Vj[apart, :, i], Vt[apart, :, i]
        np.testing.assert_allclose(_align_sign(a, b), a, atol=1e-4)
    Sj = np.asarray(jeigen.sqrtm_psd3(jnp.asarray(A)))
    St = teigen.sqrtm_psd3(torch.as_tensor(A)).numpy()
    w, V = np.linalg.eigh(A.astype(np.float64))
    S64 = np.einsum("nij,nj,nkj->nik", V, np.sqrt(np.maximum(w, 0)), V)
    ref_err = np.abs(Sj - S64).max((-2, -1), keepdims=True)
    size = np.maximum(1.0, np.abs(Sj).max((-2, -1), keepdims=True))
    assert (np.abs(St - Sj) <= 1e-5 * size + 2.0 * ref_err).all()


def test_torch_rotation_and_gicp_covariances_match_jax(rng):
    n = _normals(rng, 300)
    n[0] = [1.0, 0.0, 0.0]
    n[1] = [-1.0, 0.0, 0.0]          # antiparallel: the half-turn branch
    Rj = np.asarray(jeigen.rotation_e1_to_x(jnp.asarray(n)))
    Rt = teigen.rotation_e1_to_x(torch.as_tensor(n)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    # R e1 = n, to the reference's own accuracy (it loses digits as n
    # nears -e1, through the factor 1 / (1 + n_x))
    assert (np.abs(Rt[:, :, 0] - n)
            <= np.abs(Rj[:, :, 0] - n) + 1e-6).all()
    Cj = np.asarray(jgicp.covariances_from_normals(jnp.asarray(n), 1e-3))
    Ct = tgicp.covariances_from_normals(torch.as_tensor(n), 1e-3).numpy()
    np.testing.assert_allclose(Ct, Cj, atol=1e-6)
    np.testing.assert_allclose(np.einsum("ni,nij,nj->n", n, Ct, n), 1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("n", [3000, 25000])
def test_torch_compute_color_gradient_matches_jax(rng, n):
    """The colour gradient on both sides of the 20k brute-force limit
    (the radius search at 25000 points is the run-grid k-NN; that sheet
    is 3x wider, so both see about 22 neighbours within r 0.05), with
    the sheet's own normals.

    Its 3x3 system weighs the normal direction by (nn - 1)^2 against
    in-plane sums of squared offsets, a condition number near 1e4, so
    f32 rounding alone moves the result by about 1e-3 of its scale (the
    reference's error against f64 reaches that too). The port agrees
    with the reference within 1e-4 of the scale at the median, within
    3e-3 on >= 99.9% of points, and is no less accurate against the
    same computation in f64 (99th percentile within 1.5x)."""
    pts, cols = _sheet(rng, n, side=1.0 if n < 20000 else 3.0)
    nrm = _sheet_normals(pts)
    pj = JPointCloud(jnp.asarray(pts))
    pj.normals, pj.colors = jnp.asarray(nrm), jnp.asarray(cols)
    pt = TPointCloud(pts, device="cpu")
    pt.normals, pt.colors = nrm, cols
    r = 0.05
    gj = np.asarray(jcol.compute_color_gradient(pj, r, 30))
    gt = tcol.compute_color_gradient(pt, r, 30).numpy()
    assert np.isfinite(gj).all() and np.isfinite(gt).all()
    scale = np.abs(gj).max()
    diff = np.abs(gt - gj).max(-1)
    assert np.median(diff) <= 1e-4 * scale
    assert (diff <= 3e-3 * scale).mean() >= 0.999
    idx, _ = tknn.search_neighbors(pt.points, pt.points,
                                   TRadius(r, 30))
    g64 = tcol._color_gradient_kernel(
        pt.points.double(), pt.normals.double(),
        tcol.intensity(pt.colors).double(), idx).numpy()
    err_t = np.quantile(np.abs(gt - g64).max(-1), 0.99)
    err_j = np.quantile(np.abs(gj - g64).max(-1), 0.99)
    assert err_t <= 1.5 * err_j + 1e-6 * scale


# ---------------------------------------------------------------------------
# updates of the generic loop and the pooled epilogue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("est_name", ["ColoredICP", "GeneralizedICP"])
def test_torch_colored_gicp_updates_match_jax(rng, est_name):
    """update_colored / update_gicp on the same pairs (4x4 within 2e-5)."""
    m = 400
    tgt = _cloud(rng, m)
    src = tgt + rng.normal(scale=0.003, size=(m, 3)).astype(np.float32)
    w = (rng.uniform(size=m) > 0.2).astype(np.float32)
    if est_name == "ColoredICP":
        args = (src, tgt, _normals(rng, m),
                rng.uniform(size=m).astype(np.float32),
                rng.uniform(size=m).astype(np.float32),
                rng.normal(size=(m, 3)).astype(np.float32), w)
        sq = (np.float32(0.968) ** 0.5, np.float32(0.032) ** 0.5)
        Uj = jest.update_colored(*(jnp.asarray(a) for a in args),
                                 *(jnp.float32(s) for s in sq))
        Ut = test_.update_colored(*(torch.as_tensor(a) for a in args),
                                  *(float(s) for s in sq))
    else:
        args = (src, _psd(rng, m), tgt, _psd(rng, m), w)
        Uj = jest.update_gicp(*(jnp.asarray(a) for a in args))
        Ut = test_.update_gicp(*(torch.as_tensor(a) for a in args))
    assert Ut.dtype == torch.float32
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=2e-5)


@pytest.mark.parametrize("est_name", ["ColoredICP", "GeneralizedICP"])
def test_torch_pool_epilogue_colored_gicp_matches_jax(rng, est_name):
    """The pooled epilogue's Colored / GICP sums on the inputs of
    tests/test_poolgrid.py's interpret-parity case, with the same
    (JAX XLA) slots fed to both epilogues: rtol 3e-5, atol 2e-4."""
    m, n = 3000, 2000
    tgt = _cloud(rng, m)
    tn = _normals(rng, m)
    src = _cloud(rng, n)
    est_code = jpg.EST_COLORED if est_name == "ColoredICP" else jpg.EST_GICP
    if est_name == "ColoredICP":
        aux = {"intensity": rng.uniform(size=m).astype(np.float32),
               "gradient": rng.normal(size=(m, 3)).astype(np.float32)}
        src_extra = rng.uniform(size=(n, 1)).astype(np.float32)
        extra = (np.float32(0.98), np.float32(0.2))
    else:
        aux = {"cov": _psd(rng, m)}
        src_extra = np.asarray(jicp.cov_upper6(jnp.asarray(_psd(rng, n))))
        extra = (np.float32(0.0), np.float32(0.0))
    aj, _ = jicp.make_target_attrs(
        JET[est_name], jnp.asarray(tgt), jnp.asarray(tn),
        {k: jnp.asarray(v) for k, v in aux.items()})
    at, _ = ticp.make_target_attrs(
        test_.TransformationEstimationType[est_name], torch.as_tensor(tgt),
        torch.as_tensor(tn), {k: torch.as_tensor(v) for k, v in aux.items()})
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    plan = jpg.plan_poolgrid(tgt, 0.06, margin=0.25, query_points=src,
                             est=est_code)
    gj = jpg.make_poolgrid(jnp.asarray(tgt), aj, plan["origin"],
                           plan["cell_size"], plan["dims"], plan["cap"],
                           plan["kc"], est=est_code, tile=plan["tile"])
    eye = jnp.eye(4, dtype=jnp.float32)
    qpool, _, _ = jpg.bin_queries_pool(
        jnp.asarray(src), eye, gj.origin, gj.cell_size, gj.dims,
        plan["qp"], plan["tile"], extra=jnp.asarray(src_extra),
        n_extra=jpg.n_query_extra(est_code))
    pj = jpg.make_params(eye, jnp.float32(0.06) ** 2, gj, extra[0],
                         extra[1])
    slotf = jpg._slot_xla(gj, qpool, pj, exact=True)
    sj = np.asarray(jpg._epilogue(gj, qpool, slotf, pj, est_code, False))[0]
    gt = tpg.PoolGrid.from_numpy(
        np.asarray(gj.scan), np.asarray(gj.scan_lo),
        np.asarray(gj.binfields), np.asarray(gj.origin),
        np.asarray(gj.cell_size), np.asarray(gj.off), gj.dims, gj.cap,
        gj.kc, gj.est, gj.tile, device="cpu")
    pt = tpg.make_params(torch.eye(4), torch.tensor(0.06) ** 2, gt,
                         *extra)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    st = tpg._epilogue(gt, torch.tensor(np.asarray(qpool)),
                       torch.tensor(np.asarray(slotf)).to(torch.int32), pt,
                       est_code, False)
    assert st[27] > 100      # the count slot: real correspondences
    np.testing.assert_allclose(st.numpy(), sj, rtol=3e-5, atol=2e-4)
