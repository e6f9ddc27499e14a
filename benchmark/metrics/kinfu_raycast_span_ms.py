"""ms a frame in KinectFusion's raycast stage, the model's raycast at
every level, from the port's `kinfu.raycast` spans, device waits
included (layer: KinFu)."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "kinfu.raycast")
