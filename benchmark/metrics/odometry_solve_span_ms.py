"""ms a frame in the 6x6 solves and pose updates of the odometry's
Gauss-Newton steps, from the port's `odometry.solve` spans (layer:
odometry): the host's enqueue of a few hundred scalar launches a step."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "odometry.solve")
