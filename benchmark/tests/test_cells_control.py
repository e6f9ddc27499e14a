"""The control of every cell at a small size on the CPU: the plain
reference computed in bfloat16, put in the program's place, fails at
least one of the cell's limits (its readings at the cells' own size,
on the card, are in PERF.md)."""
import pytest
import torch

from benchmark import control
from benchmark.lib import registry

from .small import CELLS, SEED

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_lower_precision_fails(name):
    bench = registry.load_benchmark()
    traffic, config = CELLS[name]
    program, low, limits = control.readings(
        bench, registry.cell(bench, name), SEED, 2, device="cpu",
        overrides=traffic, config_overrides=config)
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(low[k] > limits[k] for k in limits), low
