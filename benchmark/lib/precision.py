"""The working precision of a reference run: "float32", what the
configurations state, or a lower torch dtype's name ("bfloat16", the
control). TF32 stays off in both."""
from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def working(name: str):
    """Switches TF32 off and yields the tensor dtype; the switches are
    put back afterwards."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield getattr(torch, name)
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved
