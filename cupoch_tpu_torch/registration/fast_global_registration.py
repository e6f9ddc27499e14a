"""Fast Global Registration (Zhou, Park and Koltun, ECCV 2016;
counterpart of the JAX package's
`registration/fast_global_registration.py`; cupoch
fast_global_registration.{h,cu}).

Normalise both clouds, match features both ways and keep the mutual
pairs, keep the pairs of random 3-tuples whose edge lengths agree in
both clouds, then `iteration_number` Gauss-Newton steps of the scaled
Geman-McClure objective with graduated non-convexity, and score the
pose with `evaluate_registration`. The tuple draws come from a host
`torch.Generator` seeded with 0 (`tuple_draws`), so the card and the
CPU test the same tuples; the JAX package draws from `PRNGKey(0)`,
which cannot be reproduced here. The optimisation is a device loop
that reads nothing back until it ends.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utility import console
from ..utility.eigen import solve_linear_system_psd
from ..utility.transforms import (transform_points,
                                  transform_vector6_to_matrix4)
from .feature import Feature, _feature_nn
from .registration import RegistrationResult, evaluate_registration

TUPLE_SEED = 0


class FastGlobalRegistrationOption:
    """cupoch fast_global_registration.h (same defaults)."""

    def __init__(self, division_factor: float = 1.4,
                 use_absolute_scale: bool = False,
                 decrease_mu: bool = True,
                 maximum_correspondence_distance: float = 0.025,
                 iteration_number: int = 64, tuple_scale: float = 0.95,
                 maximum_tuple_count: int = 1000):
        self.division_factor = float(division_factor)
        self.use_absolute_scale = bool(use_absolute_scale)
        self.decrease_mu = bool(decrease_mu)
        self.maximum_correspondence_distance = float(
            maximum_correspondence_distance)
        self.iteration_number = int(iteration_number)
        self.tuple_scale = float(tuple_scale)
        self.maximum_tuple_count = int(maximum_tuple_count)


def tuple_draws(ncorr: int, n_trials: int) -> torch.Tensor:
    """[n_trials, 3] int64 correspondence indices below `ncorr`, drawn
    on the host from `TUPLE_SEED`."""
    g = torch.Generator().manual_seed(TUPLE_SEED)
    return torch.randint(0, ncorr, (n_trials, 3), generator=g)


def _tuple_test(pts_i, pts_j, corres, scale: float, rand):
    """cupoch compute_tuple_constraint_functor: each drawn 3-tuple of
    correspondences passes when every edge length agrees within
    `scale` in both clouds. Returns ([3 T, 2] pairs, [3 T] keep)."""
    tri = corres[rand]                                    # [T, 3, 2]
    pi = pts_i[tri[..., 0]]
    pj = pts_j[tri[..., 1]]
    li = torch.linalg.norm(pi - torch.roll(pi, -1, 1), dim=-1)
    lj = torch.linalg.norm(pj - torch.roll(pj, -1, 1), dim=-1)
    ok = ((li * scale < lj) & (lj < li / scale)).all(-1)
    return tri.reshape(-1, 2), ok.repeat_interleave(3)


def _optimize_pairwise(p, q, w_valid, par0: float, max_dist: float,
                       division_factor: float, iteration_number: int,
                       decrease_mu: bool) -> torch.Tensor:
    """Scaled Geman-McClure Gauss-Newton with a line process (cupoch
    OptimizePairwiseRegistration), aligning q onto p; [4, 4] on the
    device of p. Every step stays on the device: the 6x6 solve is
    `solve_linear_system_psd`, mu a 0-d tensor."""
    dev = p.device
    trans = torch.eye(4, device=dev)
    par = torch.tensor(par0, dtype=torch.float32, device=dev)
    zero = torch.zeros(q.shape[0], device=dev)
    mone = -torch.ones(q.shape[0], device=dev)
    for itr in range(iteration_number):
        qt = transform_points(trans, q)
        rpq = p - qt
        s = (par / ((rpq * rpq).sum(-1) + par)) ** 2 * w_valid
        J = torch.stack([
            torch.stack([zero, -qt[:, 2], qt[:, 1], mone, zero, zero], -1),
            torch.stack([qt[:, 2], zero, -qt[:, 0], zero, mone, zero], -1),
            torch.stack([-qt[:, 1], qt[:, 0], zero, zero, zero, mone], -1),
        ], 1)                                            # [K, 3, 6]
        Jw = J * s[:, None, None]
        JTJ = torch.einsum("kri,krj->ij", Jw, J)
        JTr = torch.einsum("kri,kr->i", Jw, rpq)
        # the reference solves (-JTJ) x = JTr; the same as JTJ x = -JTr
        _, x = solve_linear_system_psd(JTJ, -JTr)
        trans = transform_vector6_to_matrix4(x) @ trans
        if decrease_mu and itr % 4 == 0:
            par = torch.where(par > max_dist, par / division_factor, par)
    return trans


def fast_global_registration(source, target, source_feature: Feature,
                             target_feature: Feature,
                             option: FastGlobalRegistrationOption = None
                             ) -> RegistrationResult:
    """cupoch FastGlobalRegistration, on the device of the clouds: the
    pose T with T @ source ~ target, scored by `evaluate_registration`
    at `maximum_correspondence_distance`."""
    option = option or FastGlobalRegistrationOption()
    if (not source.has_points() or not target.has_points()
            or source_feature.is_empty() or target_feature.is_empty()):
        console.log_error("Invalid source or target pointcloud.")
    dev = source.points.device
    # normalise both clouds: X' = (X - mean) / scale_global
    mean_src = source.points.mean(0)
    mean_tgt = target.points.mean(0)
    src_c = source.points - mean_src
    tgt_c = target.points - mean_tgt
    scale = float(torch.maximum(torch.linalg.norm(src_c, dim=-1).max(),
                                torch.linalg.norm(tgt_c, dim=-1).max()))
    scale_global = 1.0 if option.use_absolute_scale else scale
    pts_n = [src_c / scale_global, tgt_c / scale_global]

    # match with the larger cloud as "i", and keep the mutual pairs
    swapped = len(target) > len(source)
    feats = [source_feature.data.T.to(dev), target_feature.data.T.to(dev)]
    fi, fj = (1, 0) if swapped else (0, 1)
    nn_ij = _feature_nn(feats[fi], feats[fj])
    nn_ji = _feature_nn(feats[fj], feats[fi])
    mutual = nn_ji[nn_ij] == torch.arange(nn_ij.shape[0], device=dev)
    i_idx = torch.nonzero(mutual)[:, 0]
    corres = torch.stack([i_idx, nn_ij[i_idx]], -1)
    console.log_debug("cross check: %d pairs remain", corres.shape[0])
    if corres.shape[0] < 3:
        console.log_warning("[FastGlobalRegistration] too few mutual "
                            "correspondences.")
        return RegistrationResult()

    # tuple test: the reference runs ncorr * 100 trials and keeps the
    # first maximum_tuple_count passing pairs; trials past what can
    # fill the cap are bounded, as in the JAX package
    n_trials = int(min(corres.shape[0] * 100,
                       max(10_000, option.maximum_tuple_count * 100)))
    rand = tuple_draws(corres.shape[0], n_trials).to(dev)
    pairs, keep = _tuple_test(pts_n[fi], pts_n[fj], corres,
                              option.tuple_scale, rand)
    pairs = pairs[keep][:option.maximum_tuple_count]
    console.log_debug("tuple constraint: %d pairs", pairs.shape[0])
    if swapped:
        pairs = pairs.flip(-1)          # back to (source idx, target idx)
    if pairs.shape[0] < 10:
        return RegistrationResult()

    # align the normalised target onto the normalised source; the
    # reference starts mu at scale_global
    trans = _optimize_pairwise(
        pts_n[0][pairs[:, 0]], pts_n[1][pairs[:, 1]],
        torch.ones(pairs.shape[0], device=dev), scale_global,
        option.maximum_correspondence_distance, option.division_factor,
        option.iteration_number, option.decrease_mu).cpu().numpy()

    # undo the normalisation and invert, so T @ source ~ target
    # (cupoch GetInvTransformationOriginalScale)
    R, t = trans[:3, :3], trans[:3, 3]
    T = np.zeros((4, 4), np.float32)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ (-R @ mean_tgt.cpu().numpy() + t * scale_global
                       + mean_src.cpu().numpy())
    T[3, 3] = 1.0
    return evaluate_registration(
        source, target, option.maximum_correspondence_distance, T)
