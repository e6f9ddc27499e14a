"""Seeds for every draw of a run, from `--seed` and a frame index, and
the draw of the frames a run checks."""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def mix(seed: int, *parts) -> int:
    """A 63-bit seed from the run's seed and any labels or indices."""
    text = ":".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, *parts))
    return g


def host_rng(seed: int, *parts) -> np.random.Generator:
    return np.random.default_rng(mix(seed, *parts))


def checked_frames(records: list, seed: int, n: int) -> list:
    """`n` of the recorded frames, drawn from the seed, with the slowest
    frame (`latency`) among them, in the order they ran."""
    if not records:
        return []
    n = min(n, len(records))
    pick = sorted(host_rng(seed, "check").choice(len(records), n,
                                                 replace=False))
    slow = max(range(len(records)),
               key=lambda i: records[i].get("latency", 0.0))
    if slow not in pick:
        pick[-1] = slow
    return [records[i] for i in sorted(pick)]
