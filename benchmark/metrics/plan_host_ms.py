"""Host ms a frame in the k-NN grids' plans (numpy, on the calling
thread), sampled from the stack (layer: host plans)."""
FUNCTIONS = (
    ("cupoch_tpu_torch.knn.poolgrid", "plan_poolgrid"),
    ("cupoch_tpu_torch.knn.rungrid", "plan_rungrid"),
    ("cupoch_tpu_torch.knn.rollgrid", "plan_rollgrid"),
    ("cupoch_tpu_torch.knn.cellgrid", "plan_cellgrid"),
)


def read(ctx):
    return ctx.per_frame_ms()
