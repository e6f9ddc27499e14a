"""Kernel 1 (`csrc/poolgrid_slot.cu`, launched by
`knn/poolgrid_slot.slot_pass`) as a share of its roofline: the least
time the card could take for the window's launches over the kernel's
device time in the trace. Each frame's launches are counted with that
frame's work (the driver's `launch_work`), counted from the frame's
inputs, independent of the port's plan: each target point, normal and
query read once, one int32 written a query, a squared distance for
each target point within the threshold of a query. A launch's least
time is the larger of its bytes over HBM bandwidth and its operations
over the float32 rate."""
FUNCTIONS = ()
KERNEL = "slot_kernel"


def read(ctx):
    secs = sum(s for name, s in ctx.trace.get("by_name", {}).items()
               if KERNEL in name)
    launch_work = getattr(ctx.cell, "launch_work", None)
    frames = launch_work(KERNEL) if launch_work and secs > 0 else []
    if not frames:
        return None
    bound = sum(n * max(w["bytes"] / ctx.peaks.HBM_BYTES_PER_S,
                        w["ops"] / ctx.peaks.FP32_FLOPS)
                for n, w in frames)
    return 100.0 * bound / secs
