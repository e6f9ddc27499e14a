"""SLAM state checkpoint and resume (the JAX package's
`slam/checkpoint.py`, in the same files: the two packages read each
other's checkpoints).

State is a flat dict of arrays (poses, landmarks, trajectory, pose-graph
edges), written atomically as `.npz` through a temporary file and
`os.replace`, with the scalars in a `.json` sidecar written the same
way. Tensors are written as numpy arrays.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utility import console


def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, state: Dict[str, Any],
                    metadata: Optional[Dict[str, Any]] = None) -> bool:
    """Atomically writes `state` (dict of arrays / scalars) to `path`
    (.npz) and `metadata` to `path + '.json'`."""
    arrays = {}
    for k, v in state.items():
        a = _array(v)
        if a.dtype == object:
            console.log_error(
                f"[save_checkpoint] non-array state entry {k!r}.")
        arrays[k] = a
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if metadata is not None:
        meta_tmp = path + ".json.tmp"
        with open(meta_tmp, "w") as f:
            json.dump(metadata, f)
        os.replace(meta_tmp, path + ".json")
    return True


def load_checkpoint(path: str):
    """Returns (state dict of numpy arrays, metadata dict or None)."""
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta


def latest_checkpoint(directory: str, prefix: str = "slam_"
                      ) -> Optional[str]:
    """The newest `prefix*.npz` in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory)
             if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    cands.sort(key=lambda f: os.path.getmtime(os.path.join(directory, f)))
    return os.path.join(directory, cands[-1])
