"""JSON IO of camera intrinsics, parameters and trajectories (cupoch
io/file_format/file_json.cpp, utility/ijson_convertible.h): an object
with `to_dict` / `from_dict` is JSON convertible."""
from __future__ import annotations

import json

from ..camera import PinholeCameraIntrinsic, PinholeCameraParameters
from ..utility import console


def write_ijson_convertible_to_json(path: str, obj) -> bool:
    if not hasattr(obj, "to_dict"):
        console.log_error("[WriteJSON] object is not JSON convertible.")
    with open(path, "w") as f:
        json.dump(obj.to_dict(), f, indent=2)
    return True


def read_ijson_convertible_from_json(path: str, cls):
    with open(path) as f:
        d = json.load(f)
    return cls.from_dict(d)


def read_pinhole_camera_intrinsic(path: str) -> PinholeCameraIntrinsic:
    return read_ijson_convertible_from_json(path, PinholeCameraIntrinsic)


def write_pinhole_camera_intrinsic(path: str, intrinsic) -> bool:
    return write_ijson_convertible_to_json(path, intrinsic)


def read_pinhole_camera_parameters(path: str) -> PinholeCameraParameters:
    return read_ijson_convertible_from_json(path, PinholeCameraParameters)


def write_pinhole_camera_parameters(path: str, params) -> bool:
    return write_ijson_convertible_to_json(path, params)
