"""Every cell driven on the CPU at a small size with the timed path
broken underneath: `correct` has to come out false for each fault the
cell can have (its state returned unchanged, half of its input left
out, its answer altered where it is produced, frames that fail fast);
sound, it comes out true. The look for a card is skipped (`run_cell`
on the CPU)."""
import itertools

import numpy as np
import pytest
import torch

import cupoch_tpu_torch as ctt
from benchmark import run
from benchmark.lib import registry

from .small import CELLS, SECONDS, SEED

torch.set_num_threads(2)


def _run(name, seconds=SECONDS):
    bench = registry.load_benchmark()
    traffic, config = CELLS[name]
    res, checks = run.run_cell(bench, registry.cell(bench, name), SEED,
                               seconds, 0, device="cpu", overrides=traffic,
                               config_overrides=config)
    return res


def _icp_fault(kind):
    real = ctt.registration.registration_icp

    def broken(source, target, dist, init, *a):
        if kind == "half":
            half = ctt.geometry.PointCloud(source.points[::2],
                                           device=source.device)
            return real(half, target, dist, init, *a)
        res = real(source, target, dist, init, *a)
        if kind == "unchanged":
            res.transformation = np.asarray(init, np.float32).copy()
        else:
            res.transformation = res.transformation.copy()
            res.transformation[0, 3] += 0.01
        return res
    return "registration", "registration_icp", broken


def _odometry_fault(kind):
    real = ctt.odometry.compute_rgbd_odometry

    def broken(src, tgt, intr, init, *a):
        if kind == "half":
            d = src.depth.data.clone()
            d[::2] = 0.0
            src = ctt.geometry.RGBDImage(src.color, ctt.geometry.Image(d))
            return real(src, tgt, intr, init, *a)
        ok, T, info = real(src, tgt, intr, init, *a)
        if kind == "unchanged":
            return ok, np.eye(4, dtype=np.float32), info
        T = T.copy()
        T[0, 3] += 0.01
        return ok, T, info
    return "odometry", "compute_rgbd_odometry", broken


FAULTS = {"scan_icp.room1m": _icp_fault, "scan_icp.room500k": _icp_fault,
          "rgbd640.odometry": _odometry_fault}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    assert _run(name)["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_fault_is_caught(name, kind, monkeypatch):
    module, attr, broken = FAULTS[name](kind)
    monkeypatch.setattr(getattr(ctt, module), attr, broken)
    res = _run(name)
    assert not res["correct"], res["checks"]


ENTRIES = {"scan_icp.room1m": ("registration", "registration_icp"),
           "scan_icp.room500k": ("registration", "registration_icp"),
           "rgbd640.odometry": ("odometry", "compute_rgbd_odometry")}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_failing_frames_are_caught(name, monkeypatch):
    """Every second call of the cell's entry (the first window frame's
    among them) raises at once: the failed frames count in no rate, and
    the run is not correct whichever frames the sample checks."""
    module, attr = ENTRIES[name]
    real = getattr(getattr(ctt, module), attr)
    calls = itertools.count()

    def flaky(*a):
        if next(calls) % 2:
            raise RuntimeError("a frame that fails fast")
        return real(*a)
    monkeypatch.setattr(getattr(ctt, module), attr, flaky)
    seconds = 1.0
    res = _run(name, seconds)
    assert res["failed"] >= 1 and not res["correct"]
    assert res["checks"]["failed_frames"] == {"value": res["failed"],
                                              "limit": 0}
    completed = res["attempted"] - res["failed"]
    assert res["metrics"]["frames_per_s"]["value"] <= completed / seconds
