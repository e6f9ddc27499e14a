"""Colored ICP and Generalized ICP end to end on the dense roll grid
(30k points in [0, 0.42]^3 at r 0.05): the port against the JAX package
on the CPU. The cases and their limits are set out in
tests/test_torch_colored_gicp_icp.py."""
import pytest

from test_torch_colored_gicp_icp import check_branch


@pytest.mark.parametrize("est", ["colored", "gicp"])
def test_torch_colored_gicp_roll_matches_jax(rng, est):
    check_branch(rng, "roll", est)
