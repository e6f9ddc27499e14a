"""A short run of every cell on the card through the command the driver
runs: a result line of the contract's shape, `correct` true, the no-JAX
guard passed. Skips without a CUDA card."""
import json
import os
import subprocess
import sys

import pytest

from benchmark.lib import registry

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, os.path.join(registry.BENCH_DIR, "run.py"),
         "--workload", name, "--seed", "3141592653", "--seconds", "3",
         "--trace", str(trace)],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in registry.cell_metrics(
        registry.load_benchmark(), name, kind)}
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"
