"""The raycast kernel (`csrc/tsdf_raycast.cu`, through
`integration.tsdf_ops.raycast`) on the card, bit for bit against its
plain version `raycast_plain` on the same card: points, normals and
colours compared as int32 (NaN where there is no hit), and the steps.
On KinFu's 512^3 volume integrated from the trajectory's first frames
(`chip_smoke.raycast_volume`): at KinFu's four level shapes, 640x480
down to 80x60; from a camera outside the volume, so that some rays miss
it; with a `max_steps` too short for the rays to stop; and with
`REFINE_STEPS` = 1. Each call launches the kernel once and makes no
stop test. Skips without a CUDA card; imports no JAX, so it runs on the
card's machine:

    python -m pytest --noconftest tests/test_torch_raycast_card.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
import cupoch_tpu_torch as ctt
from cupoch_tpu_torch.integration import tsdf_ops
from cupoch_tpu_torch.utility import trace


@pytest.fixture(scope="module")
def room():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return chip_smoke.raycast_volume(np, torch, ctt, torch.device("cuda"))


def _pose(shift=(0.0, 0.0, 0.0)):
    pose = chip_smoke.rgbd_pose(np, chip_smoke.RAYCAST_FRAMES).copy()
    pose[:3, 3] += shift
    return pose


def _held(args):
    """The kernel's raycast of `args` against the plain one, traced: one
    launch, no stop test, the same steps counted. Returns the kernel's
    output."""
    trace.reset_launch_counts()
    trace.enable(reset=True)
    try:
        got = tsdf_ops.raycast(*args)
        torch.cuda.synchronize()
        c = trace.counters()
    finally:
        trace.disable()
    want = tsdf_ops.raycast_plain(*args)
    torch.cuda.synchronize()
    assert c["launches.tsdf_raycast"] == 1
    assert c.get("tsdf.stop_checks", 0) == 0
    assert c["tsdf.march_steps"] == got[3]
    assert chip_smoke.raycast_equal(torch, got, want), (got[3], want[3])
    return got


@pytest.mark.card
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_kernel_matches_plain_at_kinfu_levels(room, level):
    vol, intr = room
    lvl = intr.scale(0.5 ** level)
    got = _held(chip_smoke.raycast_args(np, torch, vol, lvl, _pose()))
    hit = torch.isfinite(got[0]).all(-1)
    assert got[0].shape == (lvl.width * lvl.height, 3)
    assert bool(hit.any()) and not bool(hit.all())
    assert got[3] < chip_smoke.raycast_args(np, torch, vol, lvl,
                                            _pose())[10]


@pytest.mark.card
def test_kernel_matches_plain_from_outside_the_volume(room):
    """A camera 3.5 m to the side of and 6 m behind the first one, outside
    the volume's [-4, 4]^3: the rays to its right miss the volume."""
    vol, intr = room
    args = chip_smoke.raycast_args(np, torch, vol, intr.scale(0.5),
                                   _pose((3.5, 0.0, -6.0)))
    rays = tsdf_ops._rays(*args[3:8], vol.resolution, args[8], args[9])
    t_far, ray0 = rays[5], rays[6]
    assert bool((ray0 > t_far).any()) and bool((ray0 < t_far).any())
    _held(args)


@pytest.mark.card
def test_kernel_matches_plain_when_max_steps_is_short(room):
    vol, intr = room
    args = chip_smoke.raycast_args(np, torch, vol, intr.scale(0.5),
                                   _pose(), max_steps=20)
    assert _held(args)[3] == 20


@pytest.mark.card
def test_kernel_matches_plain_at_the_references_refinement(room,
                                                           monkeypatch):
    monkeypatch.setattr(tsdf_ops, "REFINE_STEPS", 1)
    vol, intr = room
    for level in (0, 3):
        _held(chip_smoke.raycast_args(np, torch, vol,
                                      intr.scale(0.5 ** level), _pose()))


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take(room):
    vol, intr = room
    args = list(chip_smoke.raycast_args(np, torch, vol, intr.scale(0.125),
                                        _pose()))
    for i, bad in ((0, vol.tsdf[:, :, :-1]), (1, vol.weight.double()),
                   (2, vol.color.transpose(0, 1))):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            tsdf_ops.raycast(*wrong)
