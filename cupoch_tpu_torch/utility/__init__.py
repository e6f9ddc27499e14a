"""Shape, device, console, transform and solver helpers and the LZF
codec (`dl_converter`, DLPack interop, loads with the package), with
the JAX package's flat names re-exported from their modules."""
import torch

from . import console, eigen, lzf, shape, trace, transforms
from .console import (
    ConsoleProgressBar,
    VerbosityLevel,
    get_verbosity_level,
    log_debug,
    log_error,
    log_info,
    log_warning,
    set_verbosity_level,
)
from .device import resolve_device
from .eigen import (
    compute_jtj_jtr,
    solve_jacobian_system,
    solve_linear_system_psd,
    symeig3x3,
)
from .shape import INVALID_INDEX, bucket_size, pad_axis0, valid_mask
from .transforms import (
    exp_se3,
    exp_so3,
    hat,
    inverse_transform,
    log_se3,
    log_so3,
    make_transform,
    quaternion_from_rotation,
    rotation_from_axis_angle,
    rotation_from_euler,
    rotation_from_quaternion,
    rotation_matrix_x,
    rotation_matrix_y,
    rotation_matrix_z,
    transform_points,
    transform_vector6_to_matrix4,
)


def is_cuda_available() -> bool:
    """Whether a CUDA card is present (cupoch utility::IsCudaAvailable,
    platform.h:52)."""
    return torch.cuda.is_available()


__all__ = [
    "console", "eigen", "lzf", "shape", "trace", "transforms",
    "resolve_device",
    "is_cuda_available",
    "ConsoleProgressBar", "VerbosityLevel", "get_verbosity_level",
    "log_debug", "log_error", "log_info", "log_warning",
    "set_verbosity_level",
    "compute_jtj_jtr", "solve_jacobian_system", "solve_linear_system_psd",
    "symeig3x3",
    "INVALID_INDEX", "bucket_size", "pad_axis0", "valid_mask",
    "exp_se3", "exp_so3", "hat", "inverse_transform", "log_se3", "log_so3",
    "make_transform", "quaternion_from_rotation", "rotation_from_axis_angle",
    "rotation_from_euler", "rotation_from_quaternion", "rotation_matrix_x",
    "rotation_matrix_y", "rotation_matrix_z", "transform_points",
    "transform_vector6_to_matrix4",
]
