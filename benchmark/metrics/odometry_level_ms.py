"""ms a frame in the odometry's pyramid levels (each a device
Gauss-Newton loop with one host read), sampled from the stack (layer:
odometry)."""
FUNCTIONS = (
    ("cupoch_tpu_torch.odometry.odometry_core", "level_odometry"),
)


def read(ctx):
    return ctx.per_frame_ms()
