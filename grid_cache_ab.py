"""What the k-NN grid cache (`cupoch_tpu_torch.knn.rungrid`) does in
chip_smoke.py's phase 4g, for one or more checkouts of the repository,
each in a process of its own on an NVIDIA GPU.

Run from the root of the repository:

    python3 grid_cache_ab.py TREE[:MIB] [TREE[:MIB] ...]

TREE is a checkout (`.` for this one; an older commit unpacked with
`git archive`); `:MIB` sets that run's `_GRID_CACHE_BYTES` to MIB MiB,
where the checkout has one. Each run calls the checkout's
`chip_smoke.global_registration` with the checkout's package, after
replacing the module's cache dict with one that counts: lookups that
found a grid, found grids rejected (a store under the key just found),
grids stored, the most grids and bytes held before a lookup or at the
end, and the largest grid offered. It prints the card, then one JSON
line a run with those counts and the phase's seconds.
"""
import json
import os
import subprocess
import sys
import time


def _grid_bytes(grid) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in vars(grid).values()
               if isinstance(t, torch.Tensor))


def _counting_cache():
    class CountingCache(dict):
        """The grid cache's dict, counting what the cache does."""

        def __init__(self):
            super().__init__()
            self.counts = dict(found=0, rejected=0, stored=0, max_grids=0,
                               max_bytes=0, max_grid_bytes=0)
            self._last = None

        def sample(self):
            c = self.counts
            c["max_grids"] = max(c["max_grids"], len(self))
            c["max_bytes"] = max(c["max_bytes"], sum(
                _grid_bytes(e[0]) for e in self.values()))

        def get(self, key, default=None):
            self.sample()
            entry = super().get(key, default)
            self._last = key if entry is not None else None
            self.counts["found"] += entry is not None
            return entry

        def __setitem__(self, key, entry):
            c = self.counts
            c["rejected"] += key == self._last
            c["stored"] += 1
            c["max_grid_bytes"] = max(c["max_grid_bytes"],
                                      _grid_bytes(entry[0]))
            self._last = None
            super().__setitem__(key, entry)

    return CountingCache()


def run_one(budget_mib) -> dict:
    """Phase 4g of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    import cupoch_tpu_torch as ctt
    from cupoch_tpu_torch.knn import rungrid
    from cupoch_tpu_torch.parallel.launch import (launch_counts,
                                                  reset_launch_counts)

    if budget_mib is not None and hasattr(rungrid, "_GRID_CACHE_BYTES"):
        rungrid._GRID_CACHE_BYTES = int(budget_mib) << 20
    rungrid._grid_cache = cache = _counting_cache()
    t0 = time.perf_counter()
    cs.global_registration(np, torch, ctt, reset_launch_counts,
                           launch_counts, {}, torch.cuda.get_device_name(0))
    seconds = time.perf_counter() - t0
    cache.sample()
    c = cache.counts
    return dict(c, hits=c["found"] - c["rejected"], seconds=seconds,
                budget_mib=(getattr(rungrid, "_GRID_CACHE_BYTES", 0) >> 20)
                or None,
                count_cap=getattr(rungrid, "_GRID_CACHE_MAX", None),
                own_stats=getattr(rungrid, "grid_cache_stats", None))


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        budget = argv[1] if len(argv) > 1 and argv[1] != "-" else None
        print("RESULT " + json.dumps(run_one(budget)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    for spec in argv:
        tree, _, budget = spec.partition(":")
        tree = os.path.abspath(tree)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             budget or "-"], cwd=tree, capture_output=True, text=True,
            timeout=600, env=dict(os.environ, PYTHONPATH=tree))
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if out.returncode or not lines:
            print(out.stdout[-4000:] + out.stderr[-4000:])
            return 1
        print(json.dumps(dict(tree=spec, **json.loads(lines[-1][7:]))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
