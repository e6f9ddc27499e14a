"""cupoch_tpu_torch: the PyTorch / CUDA port of cupoch_tpu for NVIDIA
Hopper GPUs.

The JAX package `cupoch_tpu` is the reference; this package imports
none of it. Entry points run on the card (`device="cuda"`) unless the
caller names another device. TF32 is turned off here: the pose math
(displacement bound, pose composition, Kabsch) must run in full f32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import (  # noqa: E402
    bench,
    camera,
    collision,
    geometry,
    imageproc,
    integration,
    io,
    kinematics,
    kinfu,
    knn,
    odometry,
    parallel,
    planning,
    registration,
    slam,
    utility,
    visualization,
)
# the geometry's to_*_dlpack / from_*_dlpack methods
from .utility import dl_converter  # noqa: E402,F401

__all__ = ["bench", "camera", "collision", "geometry", "imageproc",
           "integration", "io", "kinematics", "kinfu", "knn", "odometry",
           "parallel", "planning", "registration", "slam", "utility",
           "visualization"]
