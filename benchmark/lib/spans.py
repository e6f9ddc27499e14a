"""Per-frame readings of the port's own spans
(`cupoch_tpu_torch.utility.trace`) for the span metrics' readers.

A span reader calls `enable()` when it is imported. `run.py` imports
the readers of a `--trace 1` run only, after the warm frames and
before the window opens, so the spans cover the window and an
untraced run never turns tracing on. The first read turns tracing off
again, since readers read after the window. A port without the trace
module reads nothing: every reading is None."""
try:
    from cupoch_tpu_torch.utility import trace
except ImportError:
    trace = None


def enable():
    if trace is not None:
        trace.enable(reset=True)


def window_spans():
    """The spans recorded since `enable`; None without the trace module
    or when spans were dropped for want of room."""
    if trace is None:
        return None
    trace.disable()
    return None if trace.dropped else trace.spans()


def per_frame_ms(ctx, name):
    """ms a frame in the spans named `name` (one inside another of the
    same name counted once), or None when none was recorded."""
    spans = window_spans()
    if not spans or not ctx.frames:
        return None
    covered, total, found = set(), 0, False
    for s in spans:
        if s.parent in covered:                 # inside a counted span
            covered.add(s.index)
        elif s.name == name and s.end_ns is not None:
            covered.add(s.index)
            total += s.end_ns - s.start_ns
            found = True
    return total * 1e-6 / ctx.frames if found else None
