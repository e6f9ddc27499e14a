"""ms a frame in the port's blocking device-to-host reads, waits for
the card's queued work included, from its `host.read` spans (layer:
host reads)."""
from benchmark.lib import spans

FUNCTIONS = ()
spans.enable()


def read(ctx):
    return spans.per_frame_ms(ctx, "host.read")
