"""Collision checking between voxel grids, occupancy grids, line sets
and primitives."""
from .collision import (
    CollisionResult,
    CollisionType,
    compute_intersection,
)
from .primitives import (
    Box,
    Capsule,
    Cylinder,
    Mesh,
    Primitive,
    PrimitiveType,
    Sphere,
)

__all__ = [
    "CollisionResult",
    "CollisionType",
    "compute_intersection",
    "Primitive",
    "PrimitiveType",
    "Box",
    "Sphere",
    "Capsule",
    "Cylinder",
    "Mesh",
]
