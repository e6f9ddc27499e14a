"""FilterReg probabilistic GMM registration (cupoch
registration/filterreg.h, filterreg.cu, permutohedral.h).

The Gaussian transform of the E-step (per model point: sum w, sum w y,
sum w |y|^2 over the target points y) is computed densely with
`torch.matmul` over model tiles for small inputs (`_gaussian_moments`),
and in linear time over the run grid with kernel 3 for large ones
(`rungrid_gmm.gmm_moments`, truncated at 3 sigma_initial), in place of
cupoch's permutohedral lattice.

The EM loop is a host loop. Sigma stays on the device; each iteration
reads one small tensor: the Kabsch statistics of the current E-step
together with the likelihood of the iteration before. So the
convergence test on that likelihood runs one E-step late, and the last
E-step of a converged run is discarded; pose, likelihood and iteration
count are those of the JAX package's `lax.while_loop`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..knn import rungrid, rungrid_gmm
from ..utility import console
from ..utility.shape import bucket_size, pad_axis0, valid_mask
from ..utility.transforms import transform_points
from .fused_icp import _binning
from .kabsch import N_STATS, kabsch_solve, kabsch_stats

_OUTLIER_CONSTANT = 0.2  # permutohedral.h
_TILE = 4096
_GRID_THRESHOLD = 20000
_HOST = torch.device("cpu")


class FilterRegOption:
    """cupoch filterreg.h (same defaults)."""

    def __init__(self, sigma_initial: float = 0.1, sigma_min: float = 1e-4,
                 relative_likelihood: float = 1e-6,
                 max_iteration: int = 30):
        self.sigma_initial = float(sigma_initial)
        self.sigma_min = float(sigma_min)
        self.relative_likelihood = float(relative_likelihood)
        self.max_iteration = int(max_iteration)


class FilterRegResult:
    """cupoch filterreg.h, plus the number of EM iterations run."""

    def __init__(self, transformation=None, likelihood: float = 0.0,
                 iterations: int = 0):
        self.transformation = (np.eye(4, dtype=np.float32)
                               if transformation is None
                               else np.asarray(transformation, np.float32))
        self.likelihood = float(likelihood)
        self.iterations = int(iterations)


def _gaussian_moments(model, tgt, tgt_mask, inv_2s2):
    """Dense Gaussian transform: per model point the moments (M0, M1,
    M2) over all target points, one [tile, M] block at a time."""
    x2 = (tgt * tgt).sum(-1)
    m0s, m1s, m2s = [], [], []
    for i in range(0, model.shape[0], _TILE):
        tile = model[i:i + _TILE]
        d2 = ((tile * tile).sum(-1)[:, None] + x2[None, :]
              - 2.0 * (tile @ tgt.T))
        w = torch.where(tgt_mask[None, :], torch.exp(-d2 * inv_2s2), 0.0)
        m0s.append(w.sum(-1))
        m1s.append(w @ tgt)
        m2s.append(w @ x2)
    return torch.cat(m0s), torch.cat(m1s), torch.cat(m2s)


def _weights(m0, M1, M2, valid):
    """E-step: the target point, weight and normalised second moment per
    model point (cupoch filterreg.cu)."""
    good = (m0 >= 1e-2) & valid
    safe = m0.clamp(min=1e-30)
    target_pt = torch.where(good[..., None], M1 / safe[..., None], 0.0)
    m2n = torch.where(good, M2 / safe, 0.0)
    weight = torch.where(good, m0 / (m0 + _OUTLIER_CONSTANT), 0.0)
    return target_pt, weight, m2n


def _em_loop(init_T, sigma_initial, sigma_min, relative_likelihood,
             max_iteration: int, e_step, device):
    """The EM loop. `e_step(T, sigma)` gives (model [K, 3], target
    points [K, 3], weights [K], normalised M2 [K]) on `device`, sigma
    a device 0-d tensor. Returns (T host [4, 4], likelihood, iterations).
    """
    T = torch.as_tensor(init_T, dtype=torch.float32).to(_HOST)
    sigma = torch.tensor(sigma_initial, dtype=torch.float32, device=device)
    likelihood = torch.tensor(0.0)
    lik_dev = None
    i = 0
    while True:
        more = i < max_iteration
        if more:
            model, tp, w, m2 = e_step(T, sigma)
            parts = [kabsch_stats(model, tp, w)]
        else:
            parts = []
        if lik_dev is not None:
            parts.append(lik_dev.reshape(1))
        if not parts:
            break
        host = torch.cat(parts).to(_HOST)     # the iteration's one read
        if lik_dev is not None:
            lik = host[-1]
            delta = (likelihood - lik).abs()
            likelihood = lik
            if not bool(delta >= relative_likelihood):
                break
        if not more:
            break
        U = kabsch_solve(host[:N_STATS])
        T = U @ T
        i += 1
        Ud = U.to(device)
        model_new = transform_points(Ud, model)
        # sigma update (cupoch ComputeSigma, permutohedral.inl)
        y2 = (model_new * model_new).sum(-1)
        upper = (w * (y2 - 2.0 * (tp * model_new).sum(-1) + m2)).sum()
        divisor = w.sum().clamp(min=1e-6)
        sigma_new = torch.sqrt((upper / (divisor * 3.0)).clamp(min=0.0))
        use_new = torch.isfinite(sigma_new) & (sigma_new > sigma_min)
        sigma = torch.where(use_new, sigma_new, sigma)
        # likelihood (cupoch GetRegistrationResult, filterreg.cu)
        r = w[:, None] * (model_new - tp)
        lik_dev = (r * r).sum()
    return T, float(likelihood), i


def _filterreg_core(src, src_mask, tgt, tgt_mask, init_T, sigma_initial,
                    sigma_min, relative_likelihood, max_iteration: int):
    """EM loop with the dense E-step (cupoch RegistrationFilterReg)."""

    def e_step(T, sigma):
        model = transform_points(T.to(src.device), src)
        inv_2s2 = 1.0 / (2.0 * sigma * sigma)
        m0, m1, m2 = _gaussian_moments(model, tgt, tgt_mask, inv_2s2)
        tp, w, m2n = _weights(m0, m1, m2, src_mask)
        return model, tp, w, m2n

    return _em_loop(init_T, sigma_initial, sigma_min, relative_likelihood,
                    max_iteration, e_step, src.device)


def _filterreg_core_grid(src, src_mask, grid, init_T, sigma_initial,
                         sigma_min, relative_likelihood, trunc_radius,
                         rebin_margin, qcap: int, max_iteration: int):
    """EM loop with the E-step over the run grid (kernel 3): O(N + M) an
    iteration. The truncation radius is 3 sigma_initial; sigma only
    shrinks during EM, so one grid serves the whole loop. Model points
    are re-binned when the motion since binning exceeds the margin."""
    r2 = torch.tensor(trunc_radius, dtype=torch.float32) ** 2
    binned = _binning(
        lambda T: rungrid.bin_queries(
            src, transform_points(T.to(src.device), src), grid.origin,
            grid.cell_size, grid.dims, qcap, mask=src_mask),
        src, src_mask, rebin_margin)

    def e_step(T, sigma):
        qsoa, qidx = binned(T)
        params = rungrid.make_params(T, r2, grid,
                                     inv_2s2=1.0 / (2.0 * sigma * sigma))
        m0, M1, M2 = rungrid_gmm.gmm_moments(grid, qsoa, qidx, params)
        tp, w, m2n = _weights(m0, M1, M2, qidx >= 0)
        # model points in bin order (original coordinates ride qsoa)
        q = qsoa[:, 0:3, :].transpose(1, 2).reshape(-1, 3)
        model = transform_points(T.to(q.device), q)
        return model, tp.reshape(-1, 3), w.reshape(-1), m2n.reshape(-1)

    return _em_loop(init_T, sigma_initial, sigma_min, relative_likelihood,
                    max_iteration, e_step, src.device)


def registration_filterreg(source, target, init=None,
                           option: Optional[FilterRegOption] = None
                           ) -> FilterRegResult:
    """cupoch RegistrationFilterReg, on the device of the two clouds."""
    if not source.has_points() or not target.has_points():
        console.log_error("Invalid source or target pointcloud.")
    if source.points.device != target.points.device:
        raise ValueError("source and target must lie on one device")
    option = option or FilterRegOption()
    init_T = (np.eye(4, dtype=np.float32) if init is None
              else np.asarray(init, np.float32))
    dev = source.points.device
    cap_s = bucket_size(len(source))
    cap_t = bucket_size(len(target))
    src = pad_axis0(source.points, cap_s)
    tgt = pad_axis0(target.points, cap_t)
    src_mask = valid_mask(len(source), cap_s, device=dev)
    tgt_mask = valid_mask(len(target), cap_t, device=dev)

    # linear-time grid E-step above the dense threshold
    if len(source) * len(target) > _GRID_THRESHOLD ** 2:
        trunc = 3.0 * option.sigma_initial
        src_t = transform_points(torch.as_tensor(init_T).to(dev),
                                 source.points)
        plan = rungrid.plan_rungrid(target.points, trunc, margin=0.25,
                                    query_points=src_t, nch=0)
        if plan is not None:
            grid = rungrid.make_rungrid(
                tgt, tgt.new_zeros((cap_t, 0)), plan["origin"],
                plan["cell_size"], plan["dims"], plan["cap"], mask=tgt_mask)
            T, lik, it = _filterreg_core_grid(
                src, src_mask, grid, init_T, option.sigma_initial,
                option.sigma_min, option.relative_likelihood, trunc,
                plan["rebin_margin"], plan["qcap"], option.max_iteration)
            return FilterRegResult(T.numpy(), lik, it)

    T, lik, it = _filterreg_core(
        src, src_mask, tgt, tgt_mask, init_T, option.sigma_initial,
        option.sigma_min, option.relative_likelihood, option.max_iteration)
    return FilterRegResult(T.numpy(), lik, it)
