"""The device's activity over the measured window, from torch.profiler
with CUDA activity only (no host operators, so little overhead and a
small trace held in memory; nothing is written to disk)."""
from __future__ import annotations

import time
from collections import defaultdict

NAME_CHARS = 160


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        prof = torch.profiler
        self.prof = prof.profile(activities=[prof.ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    def intervals(self):
        """[(start_s, end_s, name)] of every kernel, copy and fill on
        the device, in seconds from the trace's start. Reads the raw
        Kineto events: building the profiler's Python event tree takes
        minutes for a window of 10^5 launches."""
        DeviceType = self.torch.autograd.DeviceType
        res = self.prof.profiler.kineto_results
        t0 = res.trace_start_ns()
        out = []
        for e in res.events():
            if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
                continue
            s = (e.start_ns() - t0) * 1e-9
            out.append((s, s + e.duration_ns() * 1e-9, e.name()))
        out.sort()
        return out


def summarise(intervals, window_s: float, timeline=None, t0=None,
              top: int = 10) -> dict:
    """busy seconds (the union of the intervals), device time by name,
    and the longest idle gaps named by the port function the host was
    in during each (from the sampler's timeline)."""
    by_name = defaultdict(float)
    busy = 0.0
    gaps = []
    end = 0.0
    for s, e, name in intervals:
        s, e = max(s, 0.0), min(e, window_s)
        if e <= s:
            continue
        by_name[name] += e - s
        if s > end:
            gaps.append((s - end, end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if window_s > end:
        gaps.append((window_s - end, end, window_s))
    gaps.sort(reverse=True)
    named = []
    for length, g0, g1 in gaps[:top]:
        label = "no port function"
        if timeline and t0 is not None:
            seen = defaultdict(int)
            for t, fn in timeline:
                if g0 <= t - t0 <= g1 and fn:
                    seen[fn] += 1
            if seen:
                label = max(seen, key=seen.get)
        named.append([label, length])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # templated kernel names run to a thousand characters
    return {"busy_s": busy, "by_name": dict(by_name),
            "device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": named}
