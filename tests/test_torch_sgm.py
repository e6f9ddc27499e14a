"""The port's semi-global matching (cupoch_tpu_torch.imageproc.sgm)
against the JAX package on the same numpy inputs, on the CPU, at 64x48
with disp_size 32 or less: tests/test_sgm.py's shifted-texture pairs.

The pipeline is integer from the census on, so every stage is held
bit-equal: the census, the cost volume (min_disp 0 and 3), each of the
six scan paths (straight and diagonal, both directions), the 4- and
8-path sums, winner-takes-all with the uniqueness and left-right checks
(lr_max_diff 1, 2 and -1), and the whole `compute_disparity` and
`process_frame`. The disparity's point cloud is held to the JAX
package's within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cupoch_tpu.camera import PinholeCameraIntrinsic as JIntrinsic
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.imageproc import SemiGlobalMatching as JSGM
from cupoch_tpu.imageproc import SGMOption as JOption
from cupoch_tpu.imageproc import sgm as jsgm
from cupoch_tpu_torch.geometry import Image as TImage
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud
from cupoch_tpu_torch.imageproc import SemiGlobalMatching as TSGM
from cupoch_tpu_torch.imageproc import SGMOption as TOption
from cupoch_tpu_torch.imageproc import sgm as tsgm
from torch_port_bridge import intrinsic as to_port_intrinsic
from torch_port_bridge import sgm_option

H, W = 48, 64
P1, P2 = 10, 120


def make_pair(disp, seed=0):
    """Constant-disparity pair, right[x - d] == left[x], uint8."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, size=(H, W + 48)).astype(np.float32)
    tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, 1, 0)) / 3.0
    left = tex[:, 24:24 + W]
    right = tex[:, 24 + disp:24 + disp + W]
    return left.astype(np.uint8), right.astype(np.uint8)


def _two_layer_pair():
    l4, r4 = make_pair(4, 1)
    l12, r12 = make_pair(12, 2)
    return (np.concatenate([l4[:, :W // 2], l12[:, W // 2:]], 1),
            np.concatenate([r4[:, :W // 2], r12[:, W // 2:]], 1))


@pytest.fixture(scope="module")
def census():
    left, right = _two_layer_pair()
    jl = np.asarray(jsgm._census97(jnp.asarray(left, jnp.float32)))
    jr = np.asarray(jsgm._census97(jnp.asarray(right, jnp.float32)))
    return left, right, jl, jr


@pytest.fixture(scope="module")
def cost(census):
    _, _, jl, jr = census
    return np.asarray(jsgm._cost_volume(jnp.asarray(jl), jnp.asarray(jr),
                                        32, 0))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_torch_census_bit_equal(census):
    left, right, jl, jr = census
    for img, want in ((left, jl), (right, jr)):
        got = tsgm._census97(torch.from_numpy(img.astype(np.float32)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(jl.max()) < 2 ** 31 and int(jl.max()) > 2 ** 28


def test_torch_popcount_bit_equal():
    x = np.random.default_rng(3).integers(0, 2 ** 31, 4096,
                                          dtype=np.int64)
    x[:3] = (0, 2 ** 31 - 1, 0x55555555)
    want = np.asarray(jsgm._popcount32(jnp.asarray(x.astype(np.uint32))))
    got = tsgm._popcount32(torch.from_numpy(x.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("min_disp", [0, 3])
def test_torch_cost_volume_bit_equal(census, min_disp):
    _, _, jl, jr = census
    want = np.asarray(jsgm._cost_volume(jnp.asarray(jl), jnp.asarray(jr),
                                        32, min_disp))
    got = tsgm._cost_volume(_t(jl.astype(np.int32)), _t(jr.astype(np.int32)),
                            32, min_disp)
    assert got.dtype == torch.int32 and got.shape == (H, W, 32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shift", [0, 1, -1])
def test_torch_scan_path_bit_equal(cost, reverse, shift):
    want = np.asarray(jsgm._aggregate_scan(jnp.asarray(cost), jnp.int32(P1),
                                           jnp.int32(P2), reverse, shift))
    got = tsgm._aggregate_scan(_t(cost), P1, P2, reverse, shift)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_paths", [4, 8])
def test_torch_aggregate_bit_equal(cost, num_paths):
    want = np.asarray(jsgm._aggregate(jnp.asarray(cost), jnp.int32(P1),
                                      jnp.int32(P2), num_paths))
    got = tsgm._aggregate(_t(cost), P1, P2, num_paths)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("min_disp,lr_max_diff", [(0, 1), (3, -1), (0, 2)])
def test_torch_winner_takes_all_bit_equal(cost, min_disp, lr_max_diff):
    S = np.asarray(jsgm._aggregate(jnp.asarray(cost), jnp.int32(P1),
                                   jnp.int32(P2), 8))
    want = np.asarray(jsgm._select_disparity(
        jnp.asarray(S), jnp.float32(0.95), min_disp, lr_max_diff))
    got = tsgm._select_disparity(_t(S), 0.95, min_disp, lr_max_diff)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.3 < (want > 0).mean() < 1.0


@pytest.mark.parametrize("num_paths,min_disp,lr_max_diff,disp_size",
                         [(8, 0, 1, 32), (4, 0, 1, 32), (8, 2, -1, 16),
                          (4, 3, 2, 24)])
def test_torch_compute_disparity_bit_equal(census, num_paths, min_disp,
                                           lr_max_diff, disp_size):
    left, right, _, _ = census
    want = np.asarray(jsgm.compute_disparity(
        jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32),
        P1, P2, 0.95, disp_size, num_paths, min_disp, lr_max_diff))
    got = tsgm.compute_disparity(torch.from_numpy(left.astype(np.float32)),
                                 torch.from_numpy(right.astype(np.float32)),
                                 P1, P2, 0.95, disp_size, num_paths,
                                 min_disp, lr_max_diff)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path_type", [TOption.ScanPath8, TOption.ScanPath4])
def test_torch_process_frame_matches_jax(path_type):
    left, right = make_pair(6)
    jopt = JOption(W, H, disp_size=JOption.DisparitySize64,
                   path_type=path_type)
    want = JSGM(jopt).process_frame(JImage(left[..., None]),
                                    JImage(right[..., None])).to_numpy()
    got = TSGM(sgm_option(jopt)).process_frame(
        TImage(left[..., None], device="cpu"),
        TImage(right[..., None], device="cpu"))
    assert got.data.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.to_numpy(), want)
    inner = want[8:-8, 24:-8, 0]
    valid = inner > 0
    assert valid.mean() > 0.5
    assert (np.abs(inner[valid].astype(int) - 6) <= 1).mean() > 0.9


def test_torch_sgm_rejects_invalid_options():
    with pytest.raises(RuntimeError):
        TSGM(TOption()).process_frame(          # width / height 0
            TImage(np.zeros((4, 4, 1), np.uint8), device="cpu"),
            TImage(np.zeros((4, 4, 1), np.uint8), device="cpu"))
    with pytest.raises(RuntimeError):
        TSGM(TOption(8, 4)).process_frame(      # not the option's size
            TImage(np.zeros((4, 4, 1), np.uint8), device="cpu"),
            TImage(np.zeros((4, 4, 1), np.uint8), device="cpu"))


def test_torch_disparity_to_point_cloud_matches_jax():
    left, right = make_pair(8)
    jopt = JOption(W, H, disp_size=JOption.DisparitySize64)
    jdisp = JSGM(jopt).process_frame(JImage(left[..., None]),
                                     JImage(right[..., None]))
    tdisp = TSGM(sgm_option(jopt)).process_frame(
        TImage(left[..., None], device="cpu"),
        TImage(right[..., None], device="cpu"))
    jin = JIntrinsic(W, H, 50.0, 50.0, W / 2, H / 2)
    color = np.repeat(left[..., None], 3, -1)
    jp = JPointCloud.create_from_disparity(jdisp, JImage(color), jin, jin,
                                           baseline=0.1)
    tin = to_port_intrinsic(jin)
    tp = TPointCloud.create_from_disparity(
        tdisp, TImage(color, device="cpu"), tin, tin, baseline=0.1)
    assert len(tp) == len(jp) > 0
    np.testing.assert_allclose(tp.points.numpy(), np.asarray(jp.points),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.colors.numpy(), np.asarray(jp.colors),
                               atol=1e-6)
    z = tp.points.numpy()[:, 2]
    assert abs(np.median(z) - 50 * 0.1 / 8) < 0.1
