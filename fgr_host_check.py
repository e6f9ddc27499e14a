"""Fast Global Registration of the JAX package beside the port's, on
the down-sampled clouds and FPFH features that chip_smoke.py's phase 4g
saved (`chiprun_out/global_down.npz`), on the host's CPU.

Run from the root of the repository, on a machine with JAX, after a
chip_smoke.py run has written the file:

    JAX_PLATFORMS=cpu python3 fgr_host_check.py

It prints each package's pose error against the scene's true pose
(rotation angle, the move of the source's centroid, the largest gap of
the translation column; `chip_smoke.pose_errors`) and the port's gap to
the pose the card found. The JAX package's FGR runs its own steps
(mutual feature matches, tuple test on `PRNGKey(0)`, the GNC loop) up to
the pose; its closing `evaluate_registration` is left out (it only
scores the pose). Its feature matching runs in row tiles of 1024 to
bound the host's memory.
"""
import functools
import importlib
import sys

import numpy as np


def jax_fgr_pose(src, tgt, fs, ft, opt):
    """The JAX package's `fast_global_registration`, up to its pose."""
    import jax.numpy as jnp
    from cupoch_tpu.registration import feature as jfeat

    jfgr = importlib.import_module(
        "cupoch_tpu.registration.fast_global_registration")
    mean_src, mean_tgt = jnp.mean(src, 0), jnp.mean(tgt, 0)
    src_c, tgt_c = src - mean_src, tgt - mean_tgt
    scale = max(float(jnp.max(jnp.linalg.norm(src_c, axis=-1))),
                float(jnp.max(jnp.linalg.norm(tgt_c, axis=-1))))
    pts_n = [src_c / scale, tgt_c / scale]
    feats = [jnp.asarray(fs.T), jnp.asarray(ft.T)]
    fi, fj = (1, 0) if len(tgt) > len(src) else (0, 1)
    nn = functools.partial(jfeat._feature_nn, tile=1024)
    nn_ij, nn_ji = nn(feats[fi], feats[fj]), nn(feats[fj], feats[fi])
    i_idx = np.nonzero(np.asarray(jfgr._mutual_mask(nn_ij, nn_ji)))[0]
    corres = np.stack([i_idx, np.asarray(nn_ij)[i_idx]], -1) \
        .astype(np.int32)
    n_trials = int(min(len(corres) * 100,
                       max(10_000, opt.maximum_tuple_count * 100)))
    pairs, keep = jfgr._tuple_test(
        pts_n[fi], pts_n[fj], jnp.asarray(corres),
        jnp.float32(opt.tuple_scale), n_trials)
    pairs = np.asarray(pairs)[np.asarray(keep)][:opt.maximum_tuple_count]
    if fi == 1:
        pairs = pairs[:, ::-1].copy()
    trans = np.asarray(jfgr._optimize_pairwise(
        pts_n[0][jnp.asarray(pairs[:, 0])], pts_n[1][jnp.asarray(pairs[:, 1])],
        jnp.ones(len(pairs), jnp.float32), jnp.float32(scale),
        jnp.float32(opt.maximum_correspondence_distance),
        jnp.float32(opt.division_factor), opt.iteration_number,
        opt.decrease_mu))
    R, t = trans[:3, :3], trans[:3, 3]
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ (-R @ np.asarray(mean_tgt) + t * scale
                       + np.asarray(mean_src))
    return T, len(corres), len(pairs)


def port_fgr_pose(src, tgt, fs, ft, v):
    """The port's `fast_global_registration` on the CPU, up to its
    pose (its closing score replaced by the pose itself)."""
    import cupoch_tpu_torch as ctt
    from cupoch_tpu_torch.registration.registration import \
        RegistrationResult

    tfgr = importlib.import_module(
        "cupoch_tpu_torch.registration.fast_global_registration")
    tfgr.evaluate_registration = \
        lambda source, target, dist, T: RegistrationResult(T)
    reg = ctt.registration
    return reg.fast_global_registration(
        ctt.geometry.PointCloud(src, device="cpu"),
        ctt.geometry.PointCloud(tgt, device="cpu"),
        reg.Feature(fs, device="cpu"), reg.Feature(ft, device="cpu"),
        reg.FastGlobalRegistrationOption(
            maximum_correspondence_distance=0.5 * v)).transformation


def main():
    import chip_smoke as cs
    from cupoch_tpu.registration import FastGlobalRegistrationOption

    d = np.load(sys.argv[1] if len(sys.argv) > 1
                else "chiprun_out/global_down.npz")
    _, T_true = cs.scene_motion(np)
    v = cs.GLOBAL_VOXEL
    opt = FastGlobalRegistrationOption(
        maximum_correspondence_distance=0.5 * v)
    Tj, n_mutual, n_pairs = jax_fgr_pose(d["src"], d["tgt"], d["fs"],
                                         d["ft"], opt)
    Tp = port_fgr_pose(d["src"], d["tgt"], d["fs"], d["ft"], v)

    def errs(T):
        return "rotation %.5f rad, centroid %.5f m, translation column " \
            "%.5f m" % cs.pose_errors(np, T, T_true, d["src_centroid"])

    print(f"JAX package (f32 feature matches, PRNGKey(0) draws; "
          f"{n_mutual} mutual pairs, {n_pairs} tuple pairs): {errs(Tj)}")
    print(f"port on the CPU: {errs(Tp)}; largest entry gap to the card's "
          f"pose {float(np.abs(Tp - d['fgr']).max()):.3e}")
    print(f"port on the card: {errs(d['fgr'])}")


if __name__ == "__main__":
    main()
