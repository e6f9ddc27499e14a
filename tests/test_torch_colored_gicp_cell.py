"""Colored ICP and Generalized ICP end to end on the active-cell grid
(15k + 15k points in two 0.1 cubes at opposite corners of a 2.0 box, at
r 0.01): the port against the JAX package on the CPU. The cases and
their limits are set out in tests/test_torch_colored_gicp_icp.py."""
import pytest

from test_torch_colored_gicp_icp import check_branch


@pytest.mark.parametrize("est", ["colored", "gicp"])
def test_torch_colored_gicp_cell_matches_jax(rng, est):
    check_branch(rng, "cell", est)
