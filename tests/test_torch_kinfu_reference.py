"""KinectFusion through `KinfuPipeline.process_frame` against the
benchmark's plain reference (`benchmark/reference/kinfu.py`) on four
frames of the benchmark's handheld room at 80x60 with seeded Kinect v1
noise, two pyramid levels and a 64^3 volume: once with the tracking
levels on brute force, as the port sends small targets, and once with
every grid plan refused and no brute-force fallback, so that each
level takes the hash grid. Then the KinFu spans, on and off.
"""
import numpy as np
import pytest
import torch

import cupoch_tpu_torch as ctt
from benchmark.drivers import kinfu as kinfu_driver
from benchmark.lib import registry
from cupoch_tpu_torch.knn import cellgrid, poolgrid, rollgrid, rungrid
from cupoch_tpu_torch.registration import registration
from cupoch_tpu_torch.utility import trace

SEED = 2 ** 31 + 4321
FRAMES = 4
SMALL_CAMERA = {"width": 80, "height": 60, "fx": 65.625, "fy": 65.625,
                "cx": 39.5625, "cy": 29.5625}
SMALL_KINFU = {"num_pyramid_levels": 2, "tsdf_resolution": 64,
               "tsdf_length": 6.4, "sdf_trunc": 0.3,
               "icp_iterations": [10, 10]}
# Widest gaps to the reference, each with its reason:
# - poses: both sides solve the same 6x6 systems from the same exact
#   correspondences; their sums round in another order (the port pads
#   the clouds and reduces on its own), 1e-6-2e-6 at this size, and a
#   pose carries into every later frame;
# - the volume: where the poses agree to 1e-5 m, a voxel's tsdf agrees
#   within 1e-4 (the sdf moves by 1e-5 / sdf_trunc) and its weight is the
#   same, but for the few voxels on the edge of a frame's view or of the
#   truncation band, which a pose 1e-6 m away may put on the other side:
#   at most 1e-3 of the observed voxels (1.2e-4 read), where a skipped
#   frame's integration moves every voxel it saw.
POSE_TOL = 2e-5
TSDF_TOL = 1e-4
VOLUME_SHARE = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell():
    bench = registry.load_benchmark()
    cfg = registry.config(bench, "kinfu640")
    cfg.update(camera=SMALL_CAMERA,
               kinfu=dict(cfg["kinfu"], **SMALL_KINFU))
    traffic = dict(registry.traffic("handheld"), volume_tsdf_tol=TSDF_TOL)
    return kinfu_driver.Cell(cfg, traffic, SEED, "cpu")


def _run(cell, frames=FRAMES):
    for i in range(frames):
        cell.prepare("window", i)
        assert cell.run()


def _hash_only(monkeypatch):
    """Every plan refuses and brute force takes no target: the hash
    grid serves every level, as it serves level 0 at 640x480."""
    for mod, name in ((poolgrid, "plan_poolgrid"), (rungrid, "plan_rungrid"),
                      (rollgrid, "plan_rollgrid"),
                      (cellgrid, "plan_cellgrid")):
        monkeypatch.setattr(mod, name, lambda *a, **k: None)
    monkeypatch.setattr(registration, "_GRID_THRESHOLD", 0)
    monkeypatch.setattr(registration, "_BRUTE_FALLBACK_MAX", 0)


@pytest.mark.parametrize("search", ["brute", "hash"])
def test_torch_kinfu_matches_the_plain_reference(search, monkeypatch):
    if search == "hash":
        _hash_only(monkeypatch)
    cell = _cell()
    trace.enable()
    try:
        _run(cell)
        branches = {s.attrs["branch"] for s in trace.spans()
                    if s.name == "kinfu.track.level"}
    finally:
        trace.disable()
    assert branches == {search}
    cell.release()
    limits = {"rot_gap": POSE_TOL, "shift_gap": POSE_TOL,
              "volume_gap": VOLUME_SHARE}
    got = {k: v for k, v, _ in cell.check(limits)}
    assert got["rot_gap"] <= POSE_TOL and got["shift_gap"] <= POSE_TOL, got
    assert got["volume_gap"] <= VOLUME_SHARE, got
    # the frames moved: the poses are not the identity
    assert np.abs(cell.records[-1]["T"][:3, 3]).max() > 0.01


def test_torch_kinfu_spans():
    """The KinFu spans, nested, with their attributes; nothing recorded
    with tracing off."""
    cell = _cell()
    trace.disable()
    trace.enable()
    try:
        _run(cell, 2)
        spans = trace.spans()
    finally:
        trace.disable()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    roots = by["kinfu.frame"]
    assert [(s.parent, s.attrs) for s in roots] == [
        (-1, {"frame": 0, "tracked": True}),
        (-1, {"frame": 1, "tracked": True})]
    parent = {s.index: s for s in spans}
    for name in ("kinfu.surface", "kinfu.track", "kinfu.integrate",
                 "kinfu.raycast"):
        for s in by[name]:
            assert parent[s.parent].name == "kinfu.frame"
    assert len(by["kinfu.surface"]) == len(by["kinfu.integrate"]) == 2
    assert len(by["kinfu.track"]) == 1          # frame 0 only integrates
    assert [s.attrs["level"] for s in by["kinfu.raycast"]] == [0, 1, 0, 1]
    levels = by["kinfu.track.level"]
    assert [s.attrs["level"] for s in levels] == [1, 0]
    for s in levels:
        assert parent[s.parent].name == "kinfu.track"
        a = s.attrs
        assert a["branch"] == "brute" and a["iterations"] >= 1
        assert a["points"] > 0 and a["target_points"] > 0
    icp = by["registration.icp"]
    assert [parent[s.parent].name for s in icp] == ["kinfu.track.level"] * 2
    c = trace.counters()
    assert c["tsdf.march_steps"] > 0 and c["tsdf.stop_checks"] > 0
    before = len(trace.spans())
    _run(cell, 1)
    assert len(trace.spans()) == before
    assert ctt.utility.trace.enabled() is False
