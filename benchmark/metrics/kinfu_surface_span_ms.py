"""ms a frame in KinectFusion's surface stage, the RGB-D pyramid and
each level's cloud with normals, from the port's `kinfu.surface`
spans, device waits included (layer: KinFu)."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "kinfu.surface")
