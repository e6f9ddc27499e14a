"""ms a frame in the ICP loops (iterations and final evaluation, after
the grid's build), from the port's `registration.loop` spans, device
waits included (layer: ICP loop); with `grid_build_span_ms`, the twin
of the sampled `icp_loop_ms`."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "registration.loop")
