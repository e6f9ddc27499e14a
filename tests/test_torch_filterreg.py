"""PyTorch port of FilterReg (cupoch_tpu_torch.registration.filterreg)
against the JAX package on the CPU: the dense E-step through the public
entry, and the run-grid E-step (kernel 3's plain version on the CPU)
through the grid EM loop, on the same numpy inputs (pose 1e-4,
likelihood rtol 1e-3)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import cupoch_tpu.registration as jreg
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.knn import rungrid as jrg
from cupoch_tpu.registration import filterreg as jfr
import cupoch_tpu_torch.registration as treg
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.knn import rungrid as trg
from cupoch_tpu_torch.registration import filterreg as tfr


def _pair(rng, n, angle, t):
    tgt = rng.uniform(size=(n, 3)).astype(np.float32)
    R = np.asarray([[np.cos(angle), -np.sin(angle), 0],
                    [np.sin(angle), np.cos(angle), 0], [0, 0, 1]],
                   np.float32)
    t = np.asarray(t, np.float32)
    # src = (tgt - t) @ R  <=>  tgt = R src + t
    return (tgt - t) @ R, tgt, R, t


@pytest.mark.parametrize("path", ["dense", "grid"])
def test_torch_filterreg_matches_jax(rng, path):
    if path == "dense":
        src, tgt, _, _ = _pair(rng, 400, 0.05, (0.02, -0.03, 0.01))
        # noise keeps the converged likelihood well above f32 rounding
        tgt = tgt + 0.003 * rng.normal(size=tgt.shape).astype(np.float32)
        pair_j = JPointCloud(jnp.asarray(src)), JPointCloud(jnp.asarray(tgt))
        pair_t = TPointCloud(src, device="cpu"), TPointCloud(tgt, device="cpu")
        # to convergence: the same pose. As sigma shrinks the weights
        # grow sensitive and the likelihoods drift apart (0.5% after
        # 26-30 iterations, from 1e-5 over the first 3), so they are
        # compared over 4 iterations below.
        rj = jreg.registration_filterreg(
            *pair_j, option=jreg.FilterRegOption(sigma_initial=0.05))
        rt = treg.registration_filterreg(
            *pair_t, option=treg.FilterRegOption(sigma_initial=0.05))
        np.testing.assert_allclose(rt.transformation, rj.transformation,
                                   rtol=0, atol=1e-4)
        assert 0 < rt.iterations <= 30
        opt = dict(sigma_initial=0.05, relative_likelihood=0.0,
                   max_iteration=4)
        rj = jreg.registration_filterreg(*pair_j,
                                         option=jreg.FilterRegOption(**opt))
        rt = treg.registration_filterreg(*pair_t,
                                         option=treg.FilterRegOption(**opt))
        Tj, lj, Tt, lt = rj.transformation, rj.likelihood, \
            rt.transformation, rt.likelihood
        assert rt.iterations == 4
    else:
        # the grid EM loop called directly, as tests/test_filterreg.py
        # drives it, for 8 iterations
        n = 3000
        tgt = rng.uniform(size=(n, 3)).astype(np.float32)
        src = tgt - np.float32([0.02, -0.015, 0.01])
        sigma0 = 0.08
        trunc = 3.0 * sigma0
        plan = jrg.plan_rungrid(tgt, trunc, margin=0.25, query_points=src)
        args = (plan["origin"], plan["cell_size"], plan["dims"], plan["cap"])
        gj = jrg.make_rungrid(jnp.asarray(tgt), jnp.zeros((n, 0)), *args)
        gt = trg.make_rungrid(torch.as_tensor(tgt), torch.zeros((n, 0)),
                              *args)
        Tj, lj = jfr._filterreg_core_grid(
            jnp.asarray(src), jnp.ones(n, bool), gj,
            jnp.eye(4, dtype=jnp.float32), jnp.float32(sigma0),
            jnp.float32(1e-4), jnp.float32(1e-6), jnp.float32(trunc),
            plan["rebin_margin"], plan["qcap"], 8)
        Tt, lt, it = tfr._filterreg_core_grid(
            torch.as_tensor(src), torch.ones(n, dtype=torch.bool), gt,
            np.eye(4, dtype=np.float32), sigma0, 1e-4, 1e-6, trunc,
            plan["rebin_margin"], plan["qcap"], 8)
        Tt = Tt.numpy()
        assert it == 8
    np.testing.assert_allclose(Tt, np.asarray(Tj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-3)


def test_torch_filterreg_recovers_small_motion(rng):
    """The port alone, as tests/test_filterreg.py's small-motion case;
    plus max_iteration=0 returns the initial pose, and an empty cloud
    raises."""
    src, tgt, R, t = _pair(rng, 400, 0.05, (0.02, -0.03, 0.01))
    res = treg.registration_filterreg(
        TPointCloud(src, device="cpu"), TPointCloud(tgt, device="cpu"),
        option=treg.FilterRegOption(sigma_initial=0.05))
    T = res.transformation
    np.testing.assert_allclose(T[:3, :3], R, atol=0.02)
    np.testing.assert_allclose(T[:3, 3], t, atol=0.02)
    assert isinstance(res, treg.FilterRegResult) and res.likelihood > 0
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = t
    res0 = treg.registration_filterreg(
        TPointCloud(src, device="cpu"), TPointCloud(tgt, device="cpu"),
        init=init, option=treg.FilterRegOption(max_iteration=0))
    np.testing.assert_array_equal(res0.transformation, init)
    assert res0.iterations == 0 and res0.likelihood == 0.0
    with pytest.raises(RuntimeError):
        treg.registration_filterreg(TPointCloud(device="cpu"),
                                    TPointCloud(device="cpu"))
