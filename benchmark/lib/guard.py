"""Checks a run makes on its own process: the card it was given, and
that nothing of JAX or of the JAX package was loaded."""
from __future__ import annotations

import sys

# compared with the part of each module's name before the first dot,
# whole: the port's own name begins with the JAX package's
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cupoch_tpu"})


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & FORBIDDEN)


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or
    the reason it could not."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
