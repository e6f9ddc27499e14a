"""ms a frame in the k-NN grids' plans, from the port's `knn.plan`
spans (layer: host plans); the twin of the sampled `plan_host_ms`."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "knn.plan")
