"""ms a frame building the registration's search grid (pooled, run,
roll, cell or hash grid), from the port's `registration.build` spans,
device waits inside the build included (layer: grid build)."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "registration.build")
