"""The port's rigid-transform helpers and masked reductions
(cupoch_tpu_torch.utility.{transforms,shape}) against the JAX package
on the same numpy inputs, on the CPU.

Tolerances: 2e-6 absolute on rotation and transform entries (f32
rounding of a few operations on unit-sized values, which XLA on the
CPU may contract into fused multiply-adds), 1e-5 on log-map vectors
of generic rotations. `log_so3` near 0 and near pi is ill-conditioned
in f32 in both packages: there the port is held to twice the
reference's own error against an f64 log map, plus 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from cupoch_tpu.utility import shape as jshape
from cupoch_tpu.utility import transforms as jtf
from cupoch_tpu_torch.utility import shape as tshape
from cupoch_tpu_torch.utility import transforms as ttf

ATOL = 2e-6


def _both(name, *args):
    j = np.asarray(getattr(jtf, name)(*(jnp.asarray(a) for a in args)))
    t = getattr(ttf, name)(*(torch.as_tensor(np.array(a))
                               for a in args)).numpy()
    return j, t


def _vecs(rng, n, scale=1.0):
    return (rng.normal(size=(n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("name,make", [
    ("hat", lambda r: _vecs(r, 64)),
    ("vee", lambda r: _vecs(r, 64 * 3).reshape(64, 3, 3)),
    ("exp_so3", lambda r: np.concatenate([_vecs(r, 64),
                                          _vecs(r, 8, 1e-5)])),
    ("exp_se3", lambda r: np.concatenate(
        [r.normal(size=(32, 6)), 1e-6 * r.normal(size=(4, 6))]
    ).astype(np.float32)),
    ("rotation_matrix_x", lambda r: r.uniform(-4, 4, 32).astype(np.float32)),
    ("rotation_matrix_y", lambda r: r.uniform(-4, 4, 32).astype(np.float32)),
    ("rotation_matrix_z", lambda r: r.uniform(-4, 4, 32).astype(np.float32)),
    ("rotation_from_axis_angle", lambda r: _vecs(r, 32)),
    ("rotation_from_quaternion",
     lambda r: r.normal(size=(32, 4)).astype(np.float32)),
    ("transform_vector6_to_matrix4",
     lambda r: r.normal(size=(32, 6)).astype(np.float32)),
])
def test_torch_transform_builders_match_jax(rng, name, make):
    j, t = _both(name, make(rng))
    np.testing.assert_allclose(t, j, atol=ATOL * max(1.0, np.abs(j).max()))


@pytest.mark.parametrize("order", ["XYZ", "YZX", "ZXY", "XZY", "ZYX", "YXZ"])
def test_torch_rotation_from_euler_matches_jax(rng, order):
    a = rng.uniform(-3, 3, size=(16, 3)).astype(np.float32)
    j = np.asarray(jtf.rotation_from_euler(order, jnp.asarray(a)))
    t = ttf.rotation_from_euler(order, torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(t, j, atol=ATOL)
    ref = Rotation.from_euler(order, a.astype(np.float64)).as_matrix()
    np.testing.assert_allclose(t, ref, atol=1e-5)


def _rotations(rng, n=32):
    return Rotation.random(n, random_state=np.random.RandomState(1)) \
        .as_matrix().astype(np.float32)


def test_torch_quaternion_and_inverse_match_jax(rng):
    R = _rotations(rng)
    j, t = _both("quaternion_from_rotation", R)
    np.testing.assert_allclose(t, j, atol=ATOL)
    T = np.asarray(jtf.exp_se3(jnp.asarray(
        rng.normal(size=(16, 6)).astype(np.float32))))
    j, t = _both("inverse_transform", T)
    np.testing.assert_allclose(t, j, atol=ATOL * np.abs(j).max())
    j, t = _both("make_transform", R[:16], _vecs(rng, 16))
    np.testing.assert_array_equal(t, j)


def test_torch_points_and_normals_transforms_match_jax(rng):
    T = np.asarray(jtf.exp_se3(jnp.asarray(
        rng.normal(size=(6,)).astype(np.float32))))
    p = _vecs(rng, 200)
    j, t = _both("transform_points", T, p)
    np.testing.assert_allclose(t, j, atol=ATOL * 4)
    j, t = _both("rotate_normals", T, p)
    np.testing.assert_allclose(t, j, atol=ATOL * 4)


def _log_so3_f64(R):
    return Rotation.from_matrix(R.astype(np.float64)).as_rotvec()


def test_torch_log_maps_match_jax(rng):
    """Generic rotations: log_so3 and log_se3 within 1e-5 of the
    reference's."""
    R = _rotations(rng, 64)
    j, t = _both("log_so3", R)
    ok = np.linalg.norm(j, axis=-1) < 3.0
    np.testing.assert_allclose(t[ok], j[ok], atol=1e-5)
    xi = (rng.normal(size=(32, 6)) * 0.5).astype(np.float32)
    T = np.asarray(jtf.exp_se3(jnp.asarray(xi)))
    j, t = _both("log_se3", T)
    np.testing.assert_allclose(t, j, atol=1e-5)
    np.testing.assert_allclose(t, xi, atol=1e-4)


@pytest.mark.parametrize("angle", [1e-7, 1e-4, 1e-3, 3.0, 3.1, 3.14159,
                                   np.pi])
def test_torch_log_so3_ill_conditioned_within_reference_error(rng, angle):
    """Near 0 and near pi: the port's error against the f64 log map is
    at most twice the reference's, plus 1e-6. Near pi the rotation
    vector's sign is ambiguous, so the vectors are compared up to it."""
    axes = _vecs(rng, 32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    R = Rotation.from_rotvec(axes.astype(np.float64) * angle).as_matrix() \
        .astype(np.float32)
    truth = _log_so3_f64(R)
    j, t = _both("log_so3", R)

    def err(w):
        return np.minimum(np.abs(w - truth).max(-1),
                          np.abs(w + truth).max(-1))

    assert (err(t) <= 2.0 * err(j) + 1e-6).all(), (err(t), err(j))


def test_torch_masked_helpers_match_jax(rng):
    x = rng.normal(size=(50, 3)).astype(np.float32)
    m = rng.uniform(size=50) > 0.4
    m2 = np.broadcast_to(m[:, None], x.shape)
    for name in ("masked_min", "masked_max", "masked_sum", "masked_mean"):
        for axis in (None, 0):
            j = np.asarray(getattr(jshape, name)(jnp.asarray(x),
                                                 jnp.asarray(m2), axis=axis))
            t = getattr(tshape, name)(torch.as_tensor(x),
                                      torch.as_tensor(m2.copy()),
                                      dim=axis).numpy()
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    j = np.asarray(jshape.moveaxis_mask(jnp.asarray(m), jnp.asarray(x)))
    t = tshape.moveaxis_mask(torch.as_tensor(m), torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        tshape.compact_by_mask(torch.as_tensor(x), m).numpy(),
        jshape.compact_by_mask(x, m))
