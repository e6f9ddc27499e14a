"""The port's demos (examples/torch_*_demo.py) run end to end on the
CPU at a small size, import neither jax nor the JAX package, and need a
card unless given --device cpu."""
import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

import cupoch_tpu_torch as ctt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = ("pipeline", "kinfu", "slam", "stereo")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    level = ctt.utility.get_verbosity_level()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    ctt.utility.set_verbosity_level(level)


def _demo(name):
    path = os.path.join(ROOT, "examples", f"torch_{name}_demo.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}_demo",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


@pytest.mark.parametrize("name", DEMOS)
def test_torch_demo_imports_only_the_port(name):
    _, path = _demo(name)
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= {"argparse", "glob", "os", "sys", "tempfile", "time",
                     "numpy", "chip_smoke", "cupoch_tpu_torch"}, roots


@pytest.mark.parametrize("name", DEMOS)
def test_torch_demo_needs_a_card_by_default(name, monkeypatch):
    mod, _ = _demo(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


def test_torch_pipeline_demo():
    mod, _ = _demo("pipeline")
    res = mod.main(["--device", "cpu", "--points", "3000"])
    assert res.fitness > 0.95


def test_torch_kinfu_demo(tmp_path):
    mod, _ = _demo("kinfu")
    out = str(tmp_path / "model.ply")
    pipe, errors = mod.main(["--device", "cpu", "--frames", "3", "--scale",
                             "0.1", "--resolution", "64", "--out", out])
    assert pipe.frame_id == 3 and max(errors) < 0.02, errors
    assert len(ctt.io.read_point_cloud(out, device="cpu")) > 1000


def test_torch_slam_demo(tmp_path):
    mod, _ = _demo("slam")
    state = str(tmp_path / "state.npz")
    slam, resumed, errors = mod.main(["--device", "cpu", "--frames", "5",
                                      "--scale", "0.25", "--state", state])
    assert len(slam.trajectory) == 5 and max(errors) < 0.05, errors
    assert resumed.frame_id == slam.frame_id == 5
    assert len(resumed.pose_graph.nodes) == len(slam.pose_graph.nodes)
    np.testing.assert_array_equal(np.stack(resumed.trajectory),
                                  np.stack(slam.trajectory))


def test_torch_stereo_demo():
    mod, _ = _demo("stereo")
    pcd, within = mod.main(["--device", "cpu", "--scale", "0.25",
                            "--disp", "64"])
    assert within > 0.9 and len(pcd) > 10_000
