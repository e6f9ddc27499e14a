"""The port's spans and counters (`cupoch_tpu_torch.utility.trace`) on
the CPU: nothing recorded when off, the span tree and counters when on,
the Chrome export on torch.profiler's clock, the spans of
`registration_icp` (pooled and run-grid branches, above the grid
threshold) and of `compute_rgbd_odometry` (chip_smoke's room at 80x60),
and results bit-identical with tracing on and off."""
import ctypes.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
import cupoch_tpu_torch as ctt
from cupoch_tpu_torch.parallel import launch
from cupoch_tpu_torch.registration import registration as regmod
from cupoch_tpu_torch.utility import nvcc, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.disable()
    yield
    trace.disable()


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def test_torch_trace_off_records_nothing():
    trace.enable(reset=True)
    trace.disable()
    assert not trace.enabled()
    s = trace.span("a", x=1)
    assert s is trace.NOOP and trace.span("b") is trace.NOOP
    with s:
        trace.set_attrs(y=2)
        trace.count("c", 3)
        x = torch.arange(4)
        assert trace.to_host(x) is x
    assert trace.spans() == []
    assert not {k for k in trace.counters()
                if not k.startswith(("launches.", "grid_cache."))}


def test_torch_trace_span_tree_attrs_and_counters():
    trace.enable(reset=True)
    with trace.span("root", a=1):
        with trace.span("child"):
            trace.set_attrs(b=2)
            with trace.span("leaf"):
                pass
        trace.set_attrs(c=3)
        trace.count("n")
        trace.count("n", 4)
    with trace.span("root2"):
        trace.to_host(torch.zeros(5, dtype=torch.float64))
    sp = trace.spans()
    assert [s.name for s in sp] == ["root", "child", "leaf", "root2",
                                    "host.read"]
    assert [s.parent for s in sp] == [-1, 0, 1, -1, 3]
    assert [s.call for s in sp] == [1, 1, 1, 2, 2]
    assert sp[0].attrs == {"a": 1, "c": 3} and sp[1].attrs == {"b": 2}
    assert sp[4].attrs == {"bytes": 40}
    for s in sp:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    c = trace.counters()
    assert c["n"] == 5 and c["host.reads"] == 1
    assert c["host.read_bytes"] == 40
    # reset forgets the records; disable keeps them
    trace.disable()
    assert len(trace.spans()) == 5
    trace.enable(reset=True)
    assert trace.spans() == [] and "n" not in trace.counters()


def test_torch_trace_spans_past_the_cap_are_dropped(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 2)
    trace.enable(reset=True)
    with trace.span("a"):
        with trace.span("b"):
            pass
        with trace.span("c"):
            trace.set_attrs(lost=True)
    assert [s.name for s in trace.spans()] == ["a", "b"]
    assert trace.dropped == 1
    assert "lost" not in trace.spans()[0].attrs
    trace.enable(reset=True)
    assert trace.dropped == 0


def test_torch_trace_planner_marks_refusals():
    @trace.planner("demo")
    def plan(ok):
        return {"cap": 8} if ok else None

    trace.enable(reset=True)
    assert plan(True) == {"cap": 8} and plan(False) is None
    sp = trace.spans()
    assert [(s.name, s.attrs) for s in sp] == [
        ("knn.plan", {"planner": "demo", "device": "cpu", "accepted": True,
                      "reads": 0}),
        ("knn.plan", {"planner": "demo", "device": "cpu", "accepted": False,
                      "reads": 0})]
    assert trace.counters()["knn.plan_refused.demo"] == 1
    assert plan.__name__ == "plan"


def test_torch_trace_counters_gather_the_ports_counters():
    """`launch_counts` moved here and stays importable from
    `parallel.launch`; `counters()` reads the launches and the grid
    cache where they live."""
    assert launch.launch_counts is trace.launch_counts
    assert launch.reset_launch_counts is trace.reset_launch_counts
    from cupoch_tpu_torch.knn import poolgrid_slot, rungrid
    trace.reset_launch_counts()
    poolgrid_slot.launches = 3
    rungrid.reset_grid_cache_stats()
    c = trace.counters()
    assert c["launches.slot"] == 3 and c["launches.fused_gn"] == 0
    assert c["grid_cache.hits"] == 0
    trace.reset_launch_counts()
    assert trace.counters()["launches.slot"] == 0


def test_torch_trace_kernel_load_marks_a_build(monkeypatch, tmp_path):
    libc = ctypes.util.find_library("c") or "libc.so.6"
    monkeypatch.setattr(nvcc, "_loaded", {})
    monkeypatch.setattr(nvcc, "_lib_path",
                        lambda name: str(tmp_path / f"lib{name}.so"))
    monkeypatch.setattr(nvcc, "build_all", lambda names: {names[0]: libc})
    trace.enable(reset=True)
    nvcc.load("demo")
    nvcc.load("demo")              # loaded once: no second span
    sp = trace.spans()
    assert [(s.name, s.attrs) for s in sp] == [
        ("kernel.load", {"kernel": "demo", "built": True})]
    assert trace.counters()["kernel.builds"] == 1


def test_torch_trace_chrome_export_lines_up_with_the_profiler(tmp_path):
    """A span around `x @ x` holds the profiler's `aten::mm` event, give
    or take 1 ms, in the merged file and in the spans' own file."""
    x = torch.randn(256, 256)
    x @ x
    trace.enable(reset=True)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with trace.span("mm"):
            x @ x
    trace.disable()
    ptrace = str(tmp_path / "profiler.json")
    prof.export_chrome_trace(ptrace)
    merged = str(tmp_path / "merged.json")
    alone = str(tmp_path / "spans.json")
    trace.export_chrome(merged, profiler_trace=ptrace)
    trace.export_chrome(alone)
    with open(merged) as fh:
        doc = json.load(fh)
    ev = doc["traceEvents"]
    mm = [e for e in ev if e.get("name") == "aten::mm"]
    sp = [e for e in ev if e.get("name") == "mm"
          and e.get("cat") == "cupoch_tpu_torch"]
    assert len(mm) == 1 and len(sp) == 1
    mm, sp = mm[0], sp[0]
    tol = 1e3                                      # us
    assert sp["ts"] - tol <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"] + tol
    assert sp["dur"] < mm["dur"] + 2 * tol
    with open(alone) as fh:
        own = json.load(fh)
    assert own["baseTimeNanoseconds"] == 0
    (e,) = [e for e in own["traceEvents"] if e["ph"] == "X"]
    shift = doc["baseTimeNanoseconds"] / 1e3
    assert abs(e["ts"] - (sp["ts"] + shift)) < 1.0
    assert e["args"] == {"call": 1, "parent": -1}


def test_torch_trace_environment_variable_writes_the_file(tmp_path):
    out = tmp_path / "spans.json"
    code = ("import cupoch_tpu_torch\n"
            "from cupoch_tpu_torch.utility import trace\n"
            "assert trace.enabled()\n"
            "with trace.span('operator', k=1):\n"
            "    pass\n")
    env = dict(os.environ, CUPOCH_TORCH_TRACE=str(out))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=300)
    ev = [e for e in json.loads(out.read_text())["traceEvents"]
          if e["ph"] == "X"]
    assert [(e["name"], e["args"]["k"]) for e in ev] == [("operator", 1)]


def _rigid_pair(branch):
    """A target with normals and a source 0.01 rad and a few mm away: 24k
    points in the unit cube (the pooled grid), 30k in [0, 0.43]^3 (every
    pool cell over its cap: the run grid), or 3000 in [0, 0.2]^3 (under
    the grid threshold: brute force)."""
    rng = np.random.default_rng(7)
    m, scale = {"pool": (24000, 1.0), "run": (30000, 0.43),
                "brute": (3000, 0.2)}[branch]
    tgt = rng.uniform(size=(m, 3)).astype(np.float32) * scale
    tn = rng.normal(size=(m, 3)).astype(np.float32)
    tn /= np.linalg.norm(tn, axis=1, keepdims=True)
    a = 0.01
    R = np.asarray([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float32)
    t = np.float32([0.003, -0.004, 0.002]) * scale
    src = ((tgt - t) @ R).astype(np.float32)
    target = ctt.geometry.PointCloud(tgt, device="cpu")
    target.normals = tn
    return ctt.geometry.PointCloud(src, device="cpu"), target


def _icp(source, target):
    return ctt.registration.registration_icp(
        source, target, 0.05,
        estimation=ctt.registration.TransformationEstimationPointToPlane(),
        criteria=ctt.registration.ICPConvergenceCriteria(max_iteration=4))


@pytest.mark.parametrize("branch", ["pool", "run", "brute"])
def test_torch_trace_registration_icp_spans(branch):
    """`registration.icp` holds the plans, the build and the loop (brute
    force: the loop alone); the iterations counted equal the result's,
    one branch is counted, and the result is bit-identical with tracing
    off."""
    source, target = _rigid_pair(branch)
    assert (len(target) > regmod._GRID_THRESHOLD) == (branch != "brute")
    off = _icp(source, target)
    trace.enable(reset=True)
    on = _icp(source, target)
    trace.disable()
    np.testing.assert_array_equal(on.transformation, off.transformation)
    assert on.fitness == off.fitness and on.inlier_rmse == off.inlier_rmse
    np.testing.assert_array_equal(on.correspondence_set,
                                  off.correspondence_set)

    sp = trace.spans()
    roots = [s for s in sp if s.parent == -1]
    assert [s.name for s in roots] == ["registration.icp"]
    root = roots[0]
    assert root.attrs == {"source_points": len(source),
                          "target_points": len(target), "branch": branch,
                          "iterations": on.iterations}
    assert all(s.call == root.call for s in sp)
    kids = _children(sp, root)
    plans = [s.attrs for s in kids if s.name == "knn.plan"]
    # each plan reads the cloud's bounds, then its statistics
    if branch == "brute":
        assert plans == []
    elif branch == "pool":
        assert plans == [{"planner": "pool", "device": "cpu",
                          "accepted": True, "reads": 2}]
    else:
        assert plans == [{"planner": "pool", "device": "cpu",
                          "accepted": False, "reads": 2},
                         {"planner": "run", "device": "cpu",
                          "accepted": True, "reads": 2}]
    builds = [s for s in sp if s.name == "registration.build"]
    (loop,) = [s for s in sp if s.name == "registration.loop"]
    assert loop.parent == root.index and loop.attrs == {"branch": branch}
    if branch == "brute":
        assert builds == [] and not any(s.name == "knn.plan" for s in sp)
    else:
        assert [(s.parent, s.attrs) for s in builds] \
            == [(root.index, {"branch": branch})]
        assert builds[0].end_ns <= loop.start_ns
    # one read of the sums an iteration, plus the source count and box
    loop_reads = [s for s in _children(sp, loop) if s.name == "host.read"]
    assert len(loop_reads) == on.iterations + 2

    c = trace.counters()
    assert c["registration.iterations"] == on.iterations > 0
    branches = {k: v for k, v in c.items()
                if k.startswith("registration.branch.")}
    assert branches == {f"registration.branch.{branch}": 1}
    assert c.get("knn.plan_refused.pool", 0) == (branch == "run")
    reads = [s for s in sp if s.name == "host.read"]
    assert c["host.reads"] == len(reads)
    assert c["host.read_bytes"] == sum(s.attrs["bytes"] for s in reads)


def test_torch_trace_generic_loop_builds_the_hash_grid_first(monkeypatch):
    """Above the grid threshold with every plan refused and the
    brute-force cap lowered, the hash grid is built in its own span and
    the loop's span opens after it."""
    source, target = _rigid_pair("run")
    for kind in ("pool", "run", "roll", "cell"):
        monkeypatch.setattr(getattr(regmod, kind + "grid"),
                            f"plan_{kind}grid",
                            trace.planner(kind)(lambda *a, **k: None))
    monkeypatch.setattr(regmod, "_BRUTE_FALLBACK_MAX", 1000)
    trace.enable(reset=True)
    res = _icp(source, target)
    trace.disable()
    sp = trace.spans()
    root = sp[0]
    assert root.attrs["branch"] == "hash"
    kids = [s.name for s in _children(sp, root)]
    assert kids.count("knn.plan") == 4
    build = [s for s in sp if s.name == "registration.build"]
    loop = [s for s in sp if s.name == "registration.loop"]
    assert [s.attrs for s in build] == [{"branch": "hash"}]
    assert [s.attrs for s in loop] == [{"branch": "hash"}]
    assert build[0].end_ns <= loop[0].start_ns
    # the fullest bucket's count is read inside the build
    assert [s.name for s in _children(sp, build[0])] == ["host.read"]
    c = trace.counters()
    assert c["registration.branch.hash"] == 1
    assert c["registration.iterations"] == res.iterations
    assert all(c[f"knn.plan_refused.{k}"] == 1
               for k in ("pool", "run", "roll", "cell"))


def _odometry_pair():
    PS = ctt.camera.PinholeCameraIntrinsicParameters.PrimeSenseDefault
    intr = ctt.camera.PinholeCameraIntrinsic(PS).scale(0.125)  # 80x60
    frames = []
    for k in (0, 1):
        c, d = cs.room_frame(np, ctt, k, intr, "cpu")
        frames.append(ctt.geometry.RGBDImage.create_from_color_and_depth(
            c, d))
    return frames, intr


def test_torch_trace_rgbd_odometry_spans():
    """Three levels of 20/10/5 Gauss-Newton steps, coarsest first: 35
    solves in all, each step's four parts in order; the pose is
    bit-identical with tracing off."""
    (src, tgt), intr = _odometry_pair()
    odo = ctt.odometry.compute_rgbd_odometry
    ok0, T0, info0 = odo(src, tgt, intr)
    trace.enable(reset=True)
    ok1, T1, info1 = odo(src, tgt, intr)
    trace.disable()
    assert ok0 and ok1
    np.testing.assert_array_equal(T0, T1)
    np.testing.assert_array_equal(info0, info1)

    sp = trace.spans()
    (root,) = [s for s in sp if s.parent == -1]
    assert root.name == "odometry.rgbd"
    kids = _children(sp, root)
    levels = [s for s in kids if s.name == "odometry.level"]
    assert [s.attrs for s in levels] == [
        {"level": 2, "iterations": 20}, {"level": 1, "iterations": 10},
        {"level": 0, "iterations": 5}]
    assert [s.name for s in kids if s.name != "odometry.level"] == [
        "odometry.prepare", "host.read", "host.read", "host.read",
        "odometry.information", "host.read", "host.read"]
    steps = ["odometry.correspondence", "odometry.jacobians",
             "odometry.reduce", "odometry.solve"]
    solves = 0
    for lv in levels:
        names = [s.name for s in _children(sp, lv)]
        assert names == steps * lv.attrs["iterations"]
        solves += names.count("odometry.solve")
    assert solves == 35
    assert trace.counters()["host.reads"] == 5
