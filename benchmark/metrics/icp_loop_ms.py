"""ms a frame in the ICP loops, device waits included, sampled from the
stack (layer: ICP loop)."""
FUNCTIONS = (
    ("cupoch_tpu_torch.registration.fused_icp", "icp_core_pool"),
    ("cupoch_tpu_torch.registration.fused_icp", "icp_core_rungrid"),
    ("cupoch_tpu_torch.registration.registration", "_icp_core"),
)


def read(ctx):
    return ctx.per_frame_ms()
