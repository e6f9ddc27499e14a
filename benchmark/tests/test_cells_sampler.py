"""The stack sampler charges a sample to the innermost function that a
metric's file maps to its layer."""
import sys

from benchmark.lib import registry
from benchmark.lib.sampler import StackSampler, mapping_of

SRC = '''
import sys

def plan_poolgrid(inner=None):
    return inner() if inner else sys._getframe()

def helper():
    return sys._getframe()
'''


def _module(name):
    ns = {"__name__": name}
    exec(compile(SRC, name, "exec"), ns)
    return ns


def test_innermost_mapped_function_wins():
    readers = {m: registry.metric_reader(m) for m in
               ("plan_host_ms", "icp_loop_ms", "odometry_level_ms")}
    mapping = mapping_of(readers)
    assert mapping[("cupoch_tpu_torch.knn.poolgrid", "plan_poolgrid")] \
        == "plan_host_ms"
    s = StackSampler(mapping)
    plan = _module("cupoch_tpu_torch.knn.poolgrid")
    other = _module("cupoch_tpu_torch.knn.other")
    assert s.classify(plan["plan_poolgrid"]()) == (
        "plan_host_ms", "cupoch_tpu_torch.knn.poolgrid.plan_poolgrid")
    # an unmapped port function inside a mapped one: the mapped one
    # takes the time, the unmapped one names the host's activity
    metric, fn = s.classify(plan["plan_poolgrid"](other["helper"]))
    assert metric == "plan_host_ms"
    assert fn == "cupoch_tpu_torch.knn.other.helper"
    assert s.classify(sys._getframe()) == (None, None)


def test_sampler_runs_and_stops():
    import time
    s = StackSampler({}, interval_s=1e-3).start()
    time.sleep(0.05)
    s.stop()
    assert len(s.timeline) > 5
