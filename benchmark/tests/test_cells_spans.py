"""The span metrics on the CPU at the small sizes of `small.py`: a
traced run of each cell reports the span metrics its small path
reaches, and an untraced run leaves tracing off. The small ICP targets
(12000 points) lie under the port's grid threshold (20000), so the
generic loop runs on brute force: no plan and no grid build, so
`plan_span_ms` and `grid_build_span_ms` read None there and are left
out of the line; the loop and the host reads are read."""
import pytest
import torch

from benchmark import run
from benchmark.lib import registry
from cupoch_tpu_torch.utility import trace

from .small import CELLS, SECONDS, SEED

torch.set_num_threads(2)

SPAN_METRICS = {"plan_span_ms", "grid_build_span_ms", "icp_loop_span_ms",
                "host_read_span_ms", "odometry_level_span_ms",
                "odometry_solve_span_ms"}
REACHED = {
    "scan_icp.room1m": {"icp_loop_span_ms", "host_read_span_ms"},
    "scan_icp.room500k": {"icp_loop_span_ms", "host_read_span_ms"},
    "rgbd640.odometry": {"host_read_span_ms", "odometry_level_span_ms",
                         "odometry_solve_span_ms"},
}


def _run(name, traced):
    bench = registry.load_benchmark()
    traffic, config = CELLS[name]
    res, _ = run.run_cell(bench, registry.cell(bench, name), SEED, SECONDS,
                          traced, device="cpu", overrides=traffic,
                          config_overrides=config)
    return res


@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_small_run_reports_the_spans_it_reaches(name):
    res = _run(name, 1)
    assert res["correct"]
    got = SPAN_METRICS & set(res["metrics"])
    assert got == REACHED[name]
    for m in got:
        assert res["metrics"][m]["value"] > 0.0
        assert res["metrics"][m]["unit"] == "ms"
    # the readers turn tracing off once the window has ended
    assert not trace.enabled()


def test_untraced_run_leaves_tracing_off():
    trace.disable()
    res = _run("rgbd640.odometry", 0)
    assert res["correct"]
    assert not trace.enabled()
    assert not SPAN_METRICS & set(res["metrics"])
