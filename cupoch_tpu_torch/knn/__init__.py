"""Neighbour search: brute force (`bruteforce`), the pooled
correspondence grid of the ICP path (`poolgrid`, with its CUDA slot
kernel in `poolgrid_slot`), and the run-structured grid (`rungrid`,
with its CUDA fused pass in `rungrid_fused` and its Gaussian-moment
pass in `rungrid_gmm`)."""
from . import (bruteforce, poolgrid, poolgrid_slot, rungrid, rungrid_fused,
               rungrid_gmm)

__all__ = ["bruteforce", "poolgrid", "poolgrid_slot", "rungrid",
           "rungrid_fused", "rungrid_gmm"]
