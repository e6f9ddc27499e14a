"""ms a frame in KinectFusion's integrate stage, the TSDF update of
every voxel, from the port's `kinfu.integrate` spans, device waits
included (layer: KinFu)."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "kinfu.integrate")
