"""PyTorch port of the pooled-grid ICP path (cupoch_tpu_torch
.registration) against the JAX package on the CPU, plus the port's
import hygiene.

The JAX GN passes score in one bf16 pass and flip about 2% of winners
(cupoch_tpu/knn/poolgrid.py:133-141); the port's score in f32. So the
loops are compared by their converged pose and fitness, never by
per-iteration sums.
"""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import cupoch_tpu.registration as jreg
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.knn import poolgrid as jpg
from cupoch_tpu.registration import fused_icp as jicp
from cupoch_tpu.registration.estimation import (
    TransformationEstimationType as JET,
)
import cupoch_tpu_torch.registration as treg
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.knn import poolgrid as tpg
from cupoch_tpu_torch.registration import fused_icp as ticp
from cupoch_tpu_torch.registration.estimation import (
    TransformationEstimationType as TET,
)
from cupoch_tpu_torch.utility import eigen as teigen
from cupoch_tpu_torch.utility import transforms as ttf
from cupoch_tpu.utility import eigen as jeigen
from cupoch_tpu.utility import transforms as jtf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ESTS = ["PointToPoint", "PointToPlane", "SymmetricMethod"]


def _cloud(rng, n):
    return rng.uniform(size=(n, 3)).astype(np.float32)


def _normals(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _rigid_pair(rng, m, ang, t):
    tgt = _cloud(rng, m)
    tn = _normals(rng, m)
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.float32(t)
    # with row-vector sources src = (tgt - t) @ R, the aligning
    # transform is [R | t]
    src = (tgt - t) @ R
    Tgt = np.eye(4, dtype=np.float32)
    Tgt[:3, :3] = R
    Tgt[:3, 3] = t
    return tgt, tn, src, Tgt


# ---------------------------------------------------------------------------
# utility
# ---------------------------------------------------------------------------

def test_torch_solve_jacobian_system_matches_jax(rng):
    J = rng.normal(size=(50, 6)).astype(np.float32)
    r = rng.normal(size=50).astype(np.float32) * 0.01
    JTJ = (J.T @ J).astype(np.float32)
    JTr = (J.T @ r).astype(np.float32)
    okj, Tj = jeigen.solve_jacobian_system(jnp.asarray(JTJ),
                                           jnp.asarray(JTr))
    okt, Tt = teigen.solve_jacobian_system(torch.as_tensor(JTJ),
                                           torch.as_tensor(JTr))
    assert bool(okj) and bool(okt)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6)
    # a singular system falls back to the identity in both
    okj, Tj = jeigen.solve_jacobian_system(jnp.zeros((6, 6)),
                                           jnp.asarray(JTr))
    okt, Tt = teigen.solve_jacobian_system(torch.zeros(6, 6),
                                           torch.as_tensor(JTr))
    assert not bool(okj) and not bool(okt)
    np.testing.assert_array_equal(Tt.numpy(), np.asarray(Tj))


def test_torch_transforms_match_jax(rng):
    x = (rng.normal(size=6) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        ttf.transform_vector6_to_matrix4(torch.as_tensor(x)).numpy(),
        np.asarray(jtf.transform_vector6_to_matrix4(jnp.asarray(x))),
        atol=1e-6)
    T = np.array(jtf.transform_vector6_to_matrix4(jnp.asarray(x)))
    p = _cloud(rng, 100)
    np.testing.assert_allclose(
        ttf.transform_points(torch.as_tensor(T), torch.as_tensor(p)).numpy(),
        np.asarray(jtf.transform_points(jnp.asarray(T), jnp.asarray(p))),
        atol=1e-6)


@pytest.mark.parametrize("est_name", ESTS)
def test_torch_update_from_sums_matches_jax(rng, est_name):
    """The host-side Kabsch / GN updates from reduced sums."""
    tgt, tn, src, _ = _rigid_pair(rng, 500, 0.01, [0.002, -0.001, 0.003])
    s = np.zeros(32, np.float32)
    if est_name == "PointToPoint":
        s[0] = 500
        s[1:4] = src.sum(0)
        s[4:7] = tgt.sum(0)
        s[7:16] = (src.T @ tgt).reshape(-1)
    else:
        J = np.concatenate([np.cross(src, tn), tn], -1)
        r = ((src - tgt) * tn).sum(-1)
        s[:21] = (J.T @ J)[np.triu_indices(6)]
        s[21:27] = J.T @ r
    Uj = jicp._update_from_sums(JET[est_name], jnp.asarray(s))
    Ut = ticp._update_from_sums(TET[est_name], torch.as_tensor(s))
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=2e-5)


# ---------------------------------------------------------------------------
# the ICP loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("est_name", ESTS)
def test_torch_icp_core_pool_matches_jax(rng, est_name):
    m = 6000
    tgt, tn, src, Tgt = _rigid_pair(rng, m, 0.015, [0.004, -0.006, 0.002])
    radius = 0.05
    mask = np.ones(m, bool)
    attrs_j, code = jicp.make_target_attrs(JET[est_name], jnp.asarray(tgt),
                                           jnp.asarray(tn))
    plan = jpg.plan_poolgrid(tgt, radius, query_points=src, est=code)
    gj = jpg.make_poolgrid(
        jnp.asarray(tgt), attrs_j, plan["origin"], plan["cell_size"],
        plan["dims"], plan["cap"], plan["kc"], est=code,
        tile=plan["tile"], mask=jnp.asarray(mask))
    Tj, idxj, fitj, rmsej, itj, _ = jicp.icp_core_pool(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(tn), gj,
        jnp.eye(4, dtype=jnp.float32), jnp.float32(radius),
        plan["rebin_margin"], jnp.float32(1e-6), jnp.float32(1e-6),
        plan["qp"], JET[est_name], 20, use_pallas=False)

    attrs_t, _ = ticp.make_target_attrs(TET[est_name], torch.as_tensor(tgt),
                                        torch.as_tensor(tn))
    gt = tpg.make_poolgrid(
        torch.as_tensor(tgt), attrs_t, plan["origin"], plan["cell_size"],
        plan["dims"], plan["cap"], plan["kc"], est=code,
        tile=plan["tile"], mask=torch.as_tensor(mask))
    Tt, idxt, fitt, rmset, itt, nqt = ticp.icp_core_pool(
        torch.as_tensor(src), torch.as_tensor(mask), torch.as_tensor(tn),
        gt, torch.eye(4), radius, plan["rebin_margin"], 1e-6, 1e-6,
        plan["qp"], TET[est_name], 20)

    Tt = Tt.numpy()
    assert np.abs(Tt - Tgt).max() < 5e-4
    assert np.abs(Tt - np.asarray(Tj)).max() < 1e-3
    assert abs(float(fitt) - float(fitj)) < 5e-3
    assert float(fitt) > 0.99
    assert 0 < itt <= 20
    assert idxt.shape == (m,) and idxt.dtype == torch.int32


def test_torch_registration_icp_matches_jax(rng):
    """The public entry on a target above the brute-force threshold, so
    both packages take the pooled-grid branch."""
    m = 24000
    tgt, tn, src, Tgt = _rigid_pair(rng, m, 0.01, [0.003, -0.004, 0.002])
    radius = 0.05
    jt, js = JPointCloud(jnp.asarray(tgt)), JPointCloud(jnp.asarray(src))
    jt.normals = jnp.asarray(tn)
    tt = TPointCloud(tgt, device="cpu")
    ts = TPointCloud(src, device="cpu")
    tt.normals = tn
    assert m > jreg.registration._GRID_THRESHOLD
    rj = jreg.registration_icp(
        js, jt, radius,
        estimation=jreg.TransformationEstimationPointToPlane(),
        criteria=jreg.ICPConvergenceCriteria(max_iteration=20))
    rt = treg.registration_icp(
        ts, tt, radius,
        estimation=treg.TransformationEstimationPointToPlane(),
        criteria=treg.ICPConvergenceCriteria(max_iteration=20))
    assert np.abs(rt.transformation - Tgt).max() < 5e-4
    assert np.abs(rt.transformation - rj.transformation).max() < 1e-3
    assert abs(rt.fitness - rj.fitness) < 5e-3
    assert abs(rt.inlier_rmse - rj.inlier_rmse) < 1e-4
    assert rt.n_dropped_target == rj.n_dropped_target
    assert rt.n_dropped_queries == rj.n_dropped_queries
    assert 0 < rt.iterations <= 20
    cj = {tuple(r) for r in rj.correspondence_set}
    ct = {tuple(r) for r in rt.correspondence_set}
    assert len(cj & ct) >= 0.995 * max(len(cj), len(ct))


def test_torch_registration_icp_unported_branches_raise(rng):
    small = TPointCloud(_cloud(rng, 1000), device="cpu")
    with pytest.raises(NotImplementedError, match="brute-force"):
        treg.registration_icp(small, small, 0.05)
    big = TPointCloud(_cloud(rng, 21000), device="cpu")
    with pytest.raises(NotImplementedError, match="ColoredICP"):
        treg.registration_icp(
            big, big, 0.05,
            estimation=treg.TransformationEstimationForColoredICP())


def test_torch_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPointCloud(np.zeros((4, 3), np.float32))


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_torch_port_imports_no_jax():
    code = ("import sys; import cupoch_tpu_torch, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'cupoch_tpu' "
            "or m.startswith('cupoch_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
