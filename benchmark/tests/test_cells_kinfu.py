"""`kinfu640.handheld` driven on the CPU at a small size (80x60 frames
of `small.py`, two pyramid levels, a 64^3 volume) with the timed path
broken underneath: `correct` has to come out false when a frame's pose
is altered, when one frame's integration is skipped and when every
second frame raises; sound, it comes out true."""
import itertools

import pytest
import torch

import cupoch_tpu_torch as ctt
from benchmark import run
from benchmark.lib import registry

from .small import CAMERA, SECONDS, SEED

torch.set_num_threads(2)

NAME = "kinfu640.handheld"
# limits at this size, between the sound readings (rot 1e-6, shift 2e-6,
# volume 0) and the faults' (PERF.md, section 2)
TRAFFIC = {"warm_frames": 3,
           "limits": {"rot_gap": 1e-4, "shift_gap": 1e-4,
                      "volume_gap": 1e-3}}


def _run(seconds=SECONDS):
    bench = registry.load_benchmark()
    cfg = registry.config(bench, "kinfu640")
    kinfu = dict(cfg["kinfu"], num_pyramid_levels=2, tsdf_resolution=64,
                 tsdf_length=6.4, sdf_trunc=0.3, icp_iterations=[10, 10])
    res, _ = run.run_cell(bench, registry.cell(bench, NAME), SEED, seconds,
                          0, device="cpu", overrides=TRAFFIC,
                          config_overrides={"camera": CAMERA,
                                            "kinfu": kinfu})
    return res


def _nth_call(cls, attr, n, broken):
    """`cls.attr` with its n-th call (from 0) replaced by `broken(real,
    self, *a)`."""
    real = getattr(cls, attr)
    calls = itertools.count()

    def patched(self, *a):
        if next(calls) == n:
            return broken(real, self, *a)
        return real(self, *a)
    return patched


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]


def _altered_pose(real, self, image):
    ok = real(self, image)
    self.cur_pose = self.cur_pose.copy()
    self.cur_pose[0, 3] += 0.01
    return ok


def _skipped_integration(real, self, *a):
    return self


@pytest.mark.parametrize("fault", ["pose", "integration"])
def test_fault_is_caught(fault, monkeypatch):
    if fault == "pose":
        cls, attr, broken = ctt.kinfu.KinfuPipeline, "process_frame", \
            _altered_pose
    else:
        cls, attr, broken = ctt.integration.UniformTSDFVolume, \
            "integrate", _skipped_integration
    monkeypatch.setattr(cls, attr, _nth_call(cls, attr, 2, broken))
    res = _run()
    assert not res["correct"], res["checks"]
    key = "shift_gap" if fault == "pose" else "volume_gap"
    assert res["checks"][key]["value"] > res["checks"][key]["limit"]


def test_failing_frames_are_caught(monkeypatch):
    """Every second frame raises at once: the failed frames count in no
    rate, and the run is not correct."""
    real = ctt.kinfu.KinfuPipeline.process_frame
    calls = itertools.count()

    def flaky(self, image):
        if next(calls) % 2:
            raise RuntimeError("a frame that fails fast")
        return real(self, image)
    monkeypatch.setattr(ctt.kinfu.KinfuPipeline, "process_frame", flaky)
    seconds = 1.0
    res = _run(seconds)
    assert res["failed"] >= 1 and not res["correct"]
    assert res["checks"]["failed_frames"] == {"value": res["failed"],
                                              "limit": 0}
    completed = res["attempted"] - res["failed"]
    assert res["metrics"]["frames_per_s"]["value"] <= completed / seconds
