"""The SLAM backend (the JAX package's `slam/`): the pose graph with
its edges sharded over a mesh of ranks, Schur-complement bundle
adjustment with its landmarks sharded, checkpoint and resume, and RGB-D
SLAM on top of them."""
from .bundle_adjustment import (
    BAProblem,
    BLOCK_AXIS,
    bundle_adjustment,
    make_block_mesh,
    reprojection_rmse,
)
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .pose_graph import (
    EDGE_AXIS,
    GlobalOptimizationOption,
    PoseGraph,
    PoseGraphEdge,
    PoseGraphNode,
    global_optimization,
)
from .slam import RGBDSlam, SlamOption

__all__ = [
    "BAProblem",
    "bundle_adjustment",
    "make_block_mesh",
    "reprojection_rmse",
    "BLOCK_AXIS",
    "EDGE_AXIS",
    "PoseGraph",
    "PoseGraphNode",
    "PoseGraphEdge",
    "GlobalOptimizationOption",
    "global_optimization",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "RGBDSlam",
    "SlamOption",
]
