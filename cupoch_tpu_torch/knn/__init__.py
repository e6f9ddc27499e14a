"""Neighbour search. So far: the pooled correspondence grid of the ICP
path (`poolgrid`) and its CUDA slot kernel (`poolgrid_slot`)."""
from . import poolgrid, poolgrid_slot, rungrid

__all__ = ["poolgrid", "poolgrid_slot", "rungrid"]
