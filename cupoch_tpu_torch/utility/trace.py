"""Spans and counters at the boundaries of the port's layers, on the
host's clock. Off by default.

    from cupoch_tpu_torch.utility import trace
    trace.enable()
    ...                                   # the port's calls
    trace.spans(), trace.counters()
    trace.export_chrome("spans.json")

`CUPOCH_TORCH_TRACE=<file>` turns tracing on when the port is imported
and writes `<file>` at the process's exit.

A span is a named interval of one thread's host time with attributes
(`span(name, **attrs)`, a context manager); spans opened inside it are
its children, and every span of one outermost (root) call shares that
call's id. Off, `span()` checks one flag and returns the shared no-op
`NOOP`: it records nothing and never touches torch. On, neither a span
nor a counter adds a torch op, a synchronisation or a device read:
`to_host` wraps the port's own blocking device-to-host reads in a
`host.read` span, one for one, so a span's time includes the waits on
the card that happen inside it, and nothing else of the card's.

Records live in memory; past `MAX_SPANS` a span is counted in `dropped`
and not stored. The port's paths run on one thread, and so does this
module's state.

Spans, in the port's layers (README.md lists them with their readers):
- `registration.icp` (root of `registration_icp`; `source_points`,
  `target_points`, `branch` pool / run / roll / cell / hash / brute,
  `iterations`), `knn.plan` (`planner`, `device`, `accepted`, `reads`),
  `registration.build` and `registration.loop` (`branch`);
- `odometry.rgbd` (root of `compute_rgbd_odometry`), `odometry.prepare`,
  `odometry.level` (`level`, `iterations`), `odometry.information`, and
  in each Gauss-Newton step `odometry.correspondence`,
  `odometry.jacobians`, `odometry.reduce` and `odometry.solve`;
- `kinfu.frame` (root of `KinfuPipeline.process_frame`; `frame`,
  `tracked`), `kinfu.surface`, `kinfu.track` and in it a
  `kinfu.track.level` a pyramid level (`level`, `points`,
  `target_points`, `iterations`, `branch`), `kinfu.integrate`, and a
  `kinfu.raycast` a level (`level`);
- `host.read` (`bytes`), `kernel.load` (`kernel`, `built`).
Counters: `registration.branch.<branch>`, `registration.iterations`,
`knn.plan_on_card.<planner>`, `knn.plan_refused.<planner>`,
`gridhash.queries`, `gridhash.slots` (candidate pairs scanned),
`gridhash.rescued` (queries the finest level did not settle),
`tsdf.march_steps`, `tsdf.stop_checks`,
`host.reads`, `host.read_bytes`,
`kernel.builds`; `counters()` adds the kernel wrappers' launch counts
(`launches.<kernel>`) and the k-NN grid cache's statistics
(`grid_cache.<stat>`), read where they live.
"""
from __future__ import annotations

import atexit
import functools
import json
import os
import time

ENV = "CUPOCH_TORCH_TRACE"
#: spans kept in memory at most; later ones are counted in `dropped`
MAX_SPANS = 1 << 19

_on = False
_spans: list = []
_stack: list = []
_counters: dict = {}
_calls = 0
#: spans not stored since `enable(reset=True)`, for want of room
dropped = 0
# (perf_counter_ns, time_ns) read together by `enable`: Kineto, and so
# torch.profiler, stamps its events with time_ns
_clock = (0, 0)


class Span:
    """One span's record: `name`, `start_ns` and `end_ns`
    (`time.perf_counter_ns()`; `end_ns` None while open), `parent` (the
    index in `spans()` of the span it opened in, -1 for a root),
    `call` (the id of its root call) and `attrs`."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "attrs",
                 "index")

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if _stack and _stack[-1] is self:
            _stack.pop()
        return False


class _NoSpan:
    """What `span` returns when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


def span(name: str, **attrs):
    """A context manager timing `name` with `attrs`, or `NOOP` when
    tracing is off."""
    if not _on:
        return NOOP
    return _open(name, attrs)


def _open(name, attrs):
    global _calls, dropped
    s = Span()
    s.name, s.end_ns, s.attrs = name, None, attrs
    if _stack:
        top = _stack[-1]
        s.parent, s.call = top.index, top.call
    else:
        _calls += 1
        s.parent, s.call = -1, _calls
    if len(_spans) < MAX_SPANS:
        s.index = len(_spans)
        _spans.append(s)
    else:
        s.index = -1
        dropped += 1
    _stack.append(s)
    return s


def set_attrs(**kw) -> None:
    """Sets attributes of the innermost open span."""
    if _on and _stack:
        _stack[-1].attrs.update(kw)


def last_attr(name: str, attr: str):
    """Attribute `attr` of the last span named `name` opened inside the
    innermost open span; None when tracing is off or there is none."""
    if not _on or not _stack:
        return None
    top = _stack[-1].index
    for s in reversed(_spans):
        if s.index <= top:
            break
        if s.name == name:
            return s.attrs.get(attr)
    return None


def count(name: str, n=1) -> None:
    """Adds `n` to the counter `name`."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def to_host(x):
    """`x.cpu()`: a blocking device-to-host read of the tensor `x`, in a
    `host.read` span with counters `host.reads` and `host.read_bytes`
    when tracing is on. On the CPU the copy is the tensor itself; the
    span still marks the read."""
    if not _on:
        return x.cpu()
    nbytes = x.numel() * x.element_size()
    count("host.reads")
    count("host.read_bytes", nbytes)
    with _open("host.read", {"bytes": nbytes}):
        return x.cpu()


def planner(kind: str):
    """Decorator of a k-NN grid plan, which takes the cloud first and
    returns a plan or None: a `knn.plan` span (`planner` kind, `device`
    the cloud's device type, `accepted` whether a plan came back,
    `reads` the blocking reads it made), `knn.plan_on_card.<kind>`
    counted for each plan of a CUDA tensor and `knn.plan_refused.<kind>`
    at each refusal."""
    def wrap(plan_fn):
        @functools.wraps(plan_fn)
        def traced(points, *args, **kwargs):
            if not _on:
                return plan_fn(points, *args, **kwargs)
            # a tensor's device type; an array (numpy's `device` is the
            # string "cpu") plans on a CPU tensor
            dev = getattr(getattr(points, "device", None), "type", "cpu")
            reads = _counters.get("host.reads", 0)
            with _open("knn.plan", {"planner": kind, "device": dev}) as s:
                plan = plan_fn(points, *args, **kwargs)
                s.attrs["accepted"] = plan is not None
                s.attrs["reads"] = _counters.get("host.reads", 0) - reads
            if dev == "cuda":
                count(f"knn.plan_on_card.{kind}")
            if plan is None:
                count(f"knn.plan_refused.{kind}")
            return plan
        return traced
    return wrap


def enable(reset: bool = True) -> None:
    """Turns tracing on; `reset` forgets every span and counter first
    (spans still open then are not recorded)."""
    global _on, _calls, dropped, _clock
    if reset:
        _spans.clear()
        _stack.clear()
        _counters.clear()
        _calls = 0
        dropped = 0
    p0 = time.perf_counter_ns()
    t = time.time_ns()
    p1 = time.perf_counter_ns()
    _clock = ((p0 + p1) // 2, t)
    _on = True


def disable() -> None:
    """Turns tracing off; the records stay."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def spans() -> list:
    """The recorded `Span`s, in the order they opened."""
    return list(_spans)


def launch_counts() -> dict:
    """This process's kernel launches since the counters were set to 0."""
    from ..knn import poolgrid_slot, rollgrid_nn, rungrid_fused, rungrid_gmm
    return {"slot": poolgrid_slot.launches,
            "fused_corres": rungrid_fused.launches["corres"],
            "fused_gn": rungrid_fused.launches["gn"],
            "gmm": rungrid_gmm.launches, "nn": rollgrid_nn.launches}


def reset_launch_counts() -> None:
    from ..knn import poolgrid_slot, rollgrid_nn, rungrid_fused, rungrid_gmm
    poolgrid_slot.launches = 0
    rungrid_fused.launches.update(corres=0, gn=0)
    rungrid_gmm.launches = 0
    rollgrid_nn.launches = 0


def counters() -> dict:
    """This module's counters, with the kernel launches
    (`launches.<kernel>`, since `reset_launch_counts`) and the k-NN grid
    cache's numbers (`grid_cache.<stat>`, since
    `knn.rungrid.reset_grid_cache_stats`)."""
    from ..knn import rungrid
    out = dict(_counters)
    out.update((f"launches.{k}", v) for k, v in launch_counts().items())
    out.update((f"grid_cache.{k}", v)
               for k, v in rungrid.grid_cache_stats.items())
    return out


def _chrome_events(base_ns: int = 0) -> list:
    """The closed spans as Chrome-trace complete events, stamped in
    microseconds of `time.time_ns()` (the clock of torch.profiler's
    events) since `base_ns`."""
    pid = os.getpid()
    off = _clock[1] - _clock[0] - base_ns
    # a track of their own beside the profiler's threads
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "cupoch_tpu_torch spans"}}]
    for s in _spans:
        if s.end_ns is None:
            continue
        args = dict(s.attrs, call=s.call, parent=s.parent)
        out.append({"ph": "X", "cat": "cupoch_tpu_torch", "name": s.name,
                    "pid": pid, "tid": 0, "ts": (s.start_ns + off) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


def export_chrome(path: str, profiler_trace: str = None) -> None:
    """Writes the spans to `path` as Chrome-trace JSON. Alone, events
    are stamped in microseconds since the epoch (`baseTimeNanoseconds`
    0). With `profiler_trace`, a file of torch.profiler's
    `export_chrome_trace` from the same process, `path` holds that
    trace's events and the spans, on its base time: one timeline."""
    doc = {"traceEvents": [], "baseTimeNanoseconds": 0,
           "displayTimeUnit": "ms"}
    if profiler_trace is not None:
        with open(profiler_trace) as fh:
            doc = json.load(fh)
    doc["traceEvents"] = list(doc.get("traceEvents", [])) + _chrome_events(
        int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as fh:
        json.dump(doc, fh)


if os.environ.get(ENV):
    enable()
    atexit.register(export_chrome, os.environ[ENV])
