"""Share of the measured window in which no kernel, copy or fill ran on
the card: 100 (1 - busy / window), busy the union of the device
intervals of a CUDA-only profiler trace (layer: device)."""
FUNCTIONS = ()


def read(ctx):
    if ctx.window_s <= 0 or not ctx.trace.get("by_name"):
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.window_s)
