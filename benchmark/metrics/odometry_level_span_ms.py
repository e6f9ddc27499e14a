"""ms a frame in the odometry's pyramid levels, from the port's
`odometry.level` spans (layer: odometry); the twin of the sampled
`odometry_level_ms`."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "odometry.level")
