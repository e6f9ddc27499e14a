"""ms a frame in KinectFusion's track stage, frame-to-model ICP over
every level, from the port's `kinfu.track` spans, device waits
included (layer: KinFu)."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "kinfu.track")
