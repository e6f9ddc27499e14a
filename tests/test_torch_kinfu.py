"""The port's KinectFusion pipeline (cupoch_tpu_torch.kinfu) against
the JAX package on the same frames, on the CPU: three frames of
tests/test_kinfu.py's room corner at 64x48 (two levels, a 64^3 volume
over 4 m, brute-force ICP), and two frames of chip_smoke.py's room at
64x48 with the option of its card-against-CPU check.

The port refines a raycast's crossing over more steps than the
reference (ROADMAP Queue 3; test_torch_tsdf.py holds both against the
reference), so the port runs here with the reference's refinement
(`tsdf_ops.REFINE_STEPS` = 1) and the unmodified JAX pipeline.

Tolerances: every frame's pose within 1e-4 per entry; the model
pyramid's sizes equal; the volume's weights equal on >= 99.99% of the
voxels and never a frame apart, and its tsdf within 1e-4 on >= 99.9%
of them (the poses differ by up to about 2e-5 m after ICP, which moves
a voxel's sdf by that much over the 0.2 m truncation, and sends a few
voxels to the neighbouring pixel's depth or across the truncation's
edge: one voxel of 262144 on the room).
"""
import numpy as np
import pytest

import chip_smoke as cs
import cupoch_tpu_torch as ctt
import test_kinfu as corner
from cupoch_tpu.camera import PinholeCameraIntrinsic as JIntrinsic
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import RGBDImage as JRGBDImage
from cupoch_tpu.kinfu import KinfuOption as JOption
from cupoch_tpu.kinfu import KinfuPipeline as JPipeline
from cupoch_tpu_torch.kinfu import KinfuOption as TOption
from cupoch_tpu_torch.kinfu import KinfuPipeline as TPipeline
from cupoch_tpu_torch.integration import tsdf_ops as ttsdf
from cupoch_tpu_torch.kinfu import Pipeline
from torch_port_bridge import intrinsic as to_port_intrinsic
from torch_port_bridge import rgbd as to_port_rgbd


def _port_option(jopt):
    return TOption(**{k: v for k, v in vars(jopt).items()})


def _run(jpipe, tpipe, frames):
    for k, jr in enumerate(frames):
        assert jpipe.process_frame(jr)
        assert tpipe.process_frame(to_port_rgbd(jr))
        assert tpipe.frame_id == jpipe.frame_id == k + 1
        np.testing.assert_allclose(tpipe.cur_pose, jpipe.cur_pose,
                                   atol=1e-4)
        assert [len(m) for m in tpipe.model_pyramid] == \
            [len(m) for m in jpipe.model_pyramid]
    dw = np.abs(tpipe.volume.weight.numpy() - np.asarray(jpipe.volume.weight))
    assert dw.max() <= 1.0 and (dw == 0.0).mean() >= 0.9999
    gap = np.abs(tpipe.volume.tsdf.numpy() - np.asarray(jpipe.volume.tsdf))
    assert (gap <= 1e-4).mean() >= 0.999


def test_torch_kinfu_corner_matches_jax(monkeypatch):
    monkeypatch.setattr(ttsdf, "REFINE_STEPS", 1)
    jopt = corner.small_option()
    jpipe = JPipeline(corner.intrinsic(), jopt)
    tpipe = TPipeline(to_port_intrinsic(corner.intrinsic()),
                      _port_option(jopt), device="cpu")
    frames = []
    for k in range(3):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.02 * k, -0.01 * k, 0.015 * k]
        frames.append(corner.make_rgbd(corner.render_scene_depth(
            pose, corner.CORNER)))
    _run(jpipe, tpipe, frames)
    assert np.linalg.norm(tpipe.cur_pose[:3, 3] - [0.04, -0.02, 0.03]) \
        < 0.015


def test_torch_kinfu_room_matches_jax(monkeypatch):
    """chip_smoke.py's card-against-CPU configuration, on the CPU
    against the reference."""
    monkeypatch.setattr(ttsdf, "REFINE_STEPS", 1)
    PS = ctt.camera.PinholeCameraIntrinsicParameters.PrimeSenseDefault
    tin = ctt.camera.PinholeCameraIntrinsic(PS).scale(0.1)
    topt = cs.small_kinfu_option(ctt)
    jopt = JOption(**{k: v for k, v in vars(topt).items()})
    jpipe = JPipeline(JIntrinsic.from_dict(tin.to_dict()), jopt)
    tpipe = TPipeline(tin, topt, device="cpu")
    frames = []
    for k in (0, 2):
        c, d = cs.room_frame(np, ctt, k, tin, "cpu")
        frames.append(JRGBDImage.create_from_color_and_depth(
            JImage(c.data.numpy()), JImage(d.data.numpy()),
            convert_rgb_to_intensity=False))
    _run(jpipe, tpipe, frames)
    mj = jpipe.extract_triangle_mesh()
    mt = tpipe.extract_triangle_mesh()
    assert len(mt.vertices) == len(np.asarray(mj.vertices)) > 0


def test_torch_kinfu_reset_and_empty_frame():
    jopt = corner.small_option()
    pipe = Pipeline(to_port_intrinsic(corner.intrinsic()),
                    _port_option(jopt), device="cpu")
    assert not pipe.process_frame(ctt.geometry.RGBDImage(device="cpu"))
    assert pipe.frame_id == 0
    depth = corner.render_plane_depth(np.eye(4, dtype=np.float32),
                                      corner.NORMAL_, corner.D)
    assert pipe.process_frame(to_port_rgbd(corner.make_rgbd(depth)))
    assert pipe.frame_id == 1 and float(pipe.volume.weight.max()) == 1.0
    assert all(m is not None and len(m) > 0 for m in pipe.model_pyramid)
    pcd = pipe.extract_point_cloud()
    assert len(pcd) > 0
    err = np.abs(pcd.points.numpy() @ corner.NORMAL_ - corner.D)
    assert np.median(err) < 0.05
    pipe.reset()
    assert pipe.frame_id == 0
    np.testing.assert_array_equal(pipe.cur_pose, np.eye(4))
    assert all(m is None for m in pipe.model_pyramid)
    assert float(pipe.volume.weight.max()) == 0.0


def test_torch_kinfu_defaults_match_jax():
    assert vars(TOption()).keys() == vars(JOption()).keys()
    for k, v in vars(JOption()).items():
        np.testing.assert_array_equal(np.asarray(getattr(TOption(), k)),
                                      np.asarray(v))


@pytest.mark.parametrize("make", [
    lambda: ctt.geometry.Image(np.zeros((4, 4), np.float32)),
    lambda: ctt.geometry.RGBDImage(),
    lambda: ctt.integration.UniformTSDFVolume(1.0, 8, 0.1),
    lambda: TPipeline(to_port_intrinsic(corner.intrinsic()),
                      TOption(tsdf_resolution=8)),
], ids=["Image", "RGBDImage", "UniformTSDFVolume", "KinfuPipeline"])
def test_torch_rgbd_entry_points_need_a_device(make):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
