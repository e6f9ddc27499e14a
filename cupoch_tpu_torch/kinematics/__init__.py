"""URDF kinematic chains and forward kinematics."""
from .kinematic_chain import (
    Frame,
    Joint,
    JointType,
    KinematicChain,
    Link,
    ShapeInfo,
)

__all__ = [
    "KinematicChain",
    "Frame",
    "Link",
    "Joint",
    "JointType",
    "ShapeInfo",
]
