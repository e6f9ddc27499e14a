"""`PointCloud.estimate_normals` and `estimate_covariances` of the
PyTorch port against the JAX package on the CPU, on both sides of the
20k brute-force limit (the tolerances are explained in
tests/test_torch_colored_gicp.py's module note)."""
import numpy as np
import jax.numpy as jnp
import pytest

from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.knn import KDTreeSearchParamKNN as JKNN
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.knn import KDTreeSearchParamKNN as TKNN

from test_torch_colored_gicp import _align_sign, _sheet


@pytest.mark.parametrize("n", [3000, 25000])
def test_torch_estimate_normals_and_covariances_match_jax(rng, n):
    """Covariances within 1e-6 on >= 99.9% of points (99.5% at 25000,
    where the two searches' distances, rounded differently, change the
    15th neighbour on about 0.3% of points), and normals up to sign
    within 1e-4. Both sides search by brute force at 3000 points; at
    25000 the port takes its run-grid k-NN, the JAX package brute force
    (its grid plan counts the zero rows that pad the cloud, see
    `knn_search_grid`): both are exact k-NN.

    The port sums each neighbour list in order with one rounding a
    product, as the reference's compiled code does, so a point whose
    list comes back in the same order gets the same covariance bit for
    bit. The two searches round distances differently, which reorders
    near-equal neighbours on a few percent of points; there the
    summation order alone moves the covariance by up to about 1e-6, and
    the normal of a flat neighbourhood by up to 2e-6 / (its eigenvalue
    gap) (the Davis-Kahan bound), so those points are held to the
    larger of 1e-4 and that bound."""
    pts, _ = _sheet(rng, n)
    pj = JPointCloud(jnp.asarray(pts))
    pt = TPointCloud(pts, device="cpu")
    pj.estimate_normals(JKNN(15))
    pt.estimate_normals(TKNN(15))
    nj, nt = np.asarray(pj.normals), pt.normals.numpy()
    assert nt.shape == nj.shape
    err = np.abs(_align_sign(nj, nt) - nj).max(-1)
    pj.estimate_covariances(JKNN(15))
    pt.estimate_covariances(TKNN(15))
    cj, ct = np.asarray(pj.covariances), pt.covariances.numpy()
    assert (np.abs(ct - cj).max((-2, -1)) <= 1e-6).mean() \
        >= (0.999 if n < 20000 else 0.995)
    lam = np.linalg.eigvalsh(cj.astype(np.float64))
    bound = 2e-6 / np.maximum(lam[:, 1] - lam[:, 0], 1e-30)
    assert (err <= 1e-4).mean() >= (0.999 if n < 20000 else 0.95)
    assert (err <= np.maximum(1e-4, bound)).all()
