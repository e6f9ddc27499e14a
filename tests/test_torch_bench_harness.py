"""The port's benchmark harness (cupoch_tpu_torch.bench.harness), the
progress bar and the flat `utility` names, and the cases of
tests/test_bench_harness.py that read cupoch's RGB-D test data, rebuilt
on a sequence written here, against the JAX package on the CPU."""
import inspect
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
import cupoch_tpu.bench.harness as jharness
import cupoch_tpu.utility as jutil
import cupoch_tpu_torch as ctt
import cupoch_tpu_torch.utility as tutil
from cupoch_tpu.bench import ate as jate
from cupoch_tpu.io.trajectory_io import read_trajectory_log as jread_log
from cupoch_tpu_torch.bench import BenchResult, harness, time_op
from cupoch_tpu_torch.bench import ate as tate
from cupoch_tpu_torch.utility import ConsoleProgressBar

OPS = list(harness.OPS)
SMALL_RGBD = (60, 80)   # the odometry and KinFu frame of the CPU run


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcd_file(tmp_path, n=3000) -> str:
    pts = np.random.default_rng(0).uniform(size=(n, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.pcd")
    ctt.io.write_point_cloud(
        path, ctt.geometry.PointCloud(pts, device="cpu"))
    return path


def test_torch_harness_ops_match_jax(tmp_path, monkeypatch):
    """The same ops in the same order with the same details, with
    `time_op` replaced in both modules so that no op runs."""
    path = _pcd_file(tmp_path)
    seen = {"jax": [], "torch": []}

    def fake(key):
        def time_op(name, fn, reps=3, detail="", device=None):
            seen[key].append((name, detail))
            return BenchResult(name, 0.0, detail)
        return time_op

    monkeypatch.setattr(jharness, "time_op", fake("jax"))
    monkeypatch.setattr(harness, "time_op", fake("torch"))
    jharness.run_benchmarks(path, reps=1)
    out = harness.run_benchmarks(path, reps=1, device="cpu")
    assert seen["torch"] == seen["jax"]
    assert len(OPS) == 11
    assert [name for name, _ in seen["torch"]] == OPS
    assert [r.name for r in out] == OPS


def test_torch_time_op_returns_min(monkeypatch):
    calls = []
    clock = iter([0.0, 3.0, 10.0, 11.0, 20.0, 22.0])
    monkeypatch.setattr(harness.time, "perf_counter", lambda: next(clock))
    r = time_op("x", lambda: calls.append(1), reps=3, detail="d",
                device="cpu")
    assert (r.name, r.seconds, r.detail) == ("x", 1.0, "d")
    assert len(calls) == 4      # one untimed run, then three timed
    assert r.to_dict() == {"name": "x", "seconds": 1.0, "detail": "d"}


def test_torch_harness_runs_on_cpu_with_trace(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setattr(harness, "RGBD_SHAPE", SMALL_RGBD)
    trace = str(tmp_path / "trace")
    results = harness.main(["--pcd", _pcd_file(tmp_path), "--reps", "1",
                            "--trace", trace, "--device", "cpu"])
    assert [r.name for r in results] == OPS
    assert all(r.seconds > 0 for r in results)
    assert results[0].detail == "3000 pts"
    assert results[7].detail == "80x60 hybrid"
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == [r.to_dict() for r in results]
    with open(os.path.join(trace, harness.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names


def test_torch_harness_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        harness.run_benchmarks(reps=1)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        time_op("x", lambda: calls.append(1), 1, "d")
    assert calls == []


def test_torch_time_op_synchronises_the_card(monkeypatch):
    """Without `device`, `time_op` waits for the card's queue after the
    warm run and after every timed run."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    time_op("x", lambda: None, 2, "d")
    assert synced == [torch.device("cuda")] * 3


def test_torch_console_progress_bar(capsys):
    bar = ConsoleProgressBar(4, "load")
    bar += 1
    bar.step(3)
    err = capsys.readouterr().err
    assert err.startswith("\rload [") and err.endswith("] 100.0%\n")
    assert "=" * 40 in err and bar.count == 4
    quiet = ConsoleProgressBar(2, "q", active=False)
    quiet += 2
    assert capsys.readouterr().err == ""


def test_torch_utility_flat_names_match_jax():
    """The JAX package's 33 flat `utility` names, `is_tpu_available`
    replaced by `is_cuda_available`; the port adds `resolve_device`."""
    def flat(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and not inspect.ismodule(v)}

    assert len(flat(jutil)) == 33
    want = flat(jutil) - {"is_tpu_available"} | {"is_cuda_available",
                                                   "resolve_device"}
    assert flat(tutil) == want
    assert {n for n in tutil.__all__
            if not inspect.ismodule(getattr(tutil, n))} == want
    assert tutil.is_cuda_available() is torch.cuda.is_available()


def _sequence(tmp_path, frames=5):
    """A room sequence at 160x120 in cupoch's RGB-D test-data layout."""
    intr = ctt.camera.PinholeCameraIntrinsic(160, 120, 131.25, 131.25,
                                             79.5, 59.5)
    root = str(tmp_path / "testdata")
    _, gt = cs.write_rgbd_sequence(np, ctt, root, intr, frames)
    return root, gt


def test_torch_read_written_trajectory(tmp_path):
    """tests/test_bench_harness.py's bundled-trajectory case on a
    written log: 5 poses of rigid motions, read alike by both
    packages."""
    root, gt = _sequence(tmp_path)
    path = os.path.join(root, "rgbd", "trajectory.log")
    poses = ctt.io.read_trajectory_log(path)
    assert len(poses) == 5
    for T, J, G in zip(poses, jread_log(path), gt):
        assert T.shape == (4, 4)
        np.testing.assert_array_equal(T, np.asarray(J))
        np.testing.assert_allclose(T, G, atol=1e-6)
        np.testing.assert_allclose(T[3], [0, 0, 0, 1], atol=1e-6)
        R = T[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)


def test_torch_sequence_ate_within_bound(tmp_path):
    """tests/test_bench_harness.py's ATE case on a written sequence:
    both packages' odometry tracks the 5 frames within 1 cm."""
    root, _ = _sequence(tmp_path)
    ate, n, _ = tate.run_sequence(root, device="cpu")
    jate_m, jn = jate.run_sequence(root)
    assert n == jn == 5
    assert ate < 0.01 and jate_m < 0.01, (ate, jate_m)
