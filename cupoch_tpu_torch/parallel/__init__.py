"""Registration over several ranks: the point-sharded run-grid ICP and
the ring-sharded pooled ICP over `torch.distributed` (the JAX package's
`parallel/`), with the mesh handle and its collectives
(`collectives.py`) and a launcher that spawns ranks on one machine
(`launch.py`)."""
from .collectives import Mesh
from .sharded import (
    POINTS_AXIS,
    make_point_mesh,
    ring_sharded_pool_icp_fn,
    ring_sharded_registration_icp,
    sharded_icp_fn,
    sharded_registration_icp,
    sharded_transform,
)

__all__ = [
    "Mesh",
    "POINTS_AXIS",
    "make_point_mesh",
    "ring_sharded_pool_icp_fn",
    "ring_sharded_registration_icp",
    "sharded_icp_fn",
    "sharded_registration_icp",
    "sharded_transform",
]
