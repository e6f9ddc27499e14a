"""Camera trajectories in the Redwood `.log` layout (an `i j k` line,
then the 4x4 camera-to-world pose, a frame), as the RGB-D sequences'
`trajectory.log` holds them."""
from __future__ import annotations

from typing import List

import numpy as np

from ..utility import console


def read_trajectory_log(path: str) -> List[np.ndarray]:
    """The [4, 4] float32 camera-to-world poses, in file order."""
    poses: List[np.ndarray] = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        header = lines[i].split()
        if len(header) != 3:
            console.log_error(f"[read_trajectory_log] bad header at "
                              f"line {i}: {lines[i]!r}")
        rows = [list(map(float, lines[i + 1 + r].split()))
                for r in range(4)]
        poses.append(np.asarray(rows, np.float32))
        i += 5
    return poses


def write_trajectory_log(path: str, poses) -> bool:
    """Each pose's 16 entries to 17 significant digits."""
    with open(path, "w") as f:
        for k, T in enumerate(poses):
            T = np.asarray(T, np.float64)
            f.write(f"{k} {k} {k + 1}\n")
            for r in range(4):
                f.write(" ".join(f"{float(v):.17g}" for v in T[r]) + "\n")
    return True
