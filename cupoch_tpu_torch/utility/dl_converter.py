"""DLPack interop (cupoch utility/dl_converter.h:34-40, exposed in
Python as the geometry's to_*_dlpack / from_*_dlpack,
cupoch_pybind/geometry/pointcloud.cpp:82-105): tensors pass to and
from other frameworks without a copy where the consumer allows."""
from __future__ import annotations

import torch
import torch.utils.dlpack


def to_dlpack(tensor: torch.Tensor):
    """A DLPack capsule of `tensor` (ToDLPack, dl_converter.h:34); a
    consumer takes it once."""
    return torch.utils.dlpack.to_dlpack(tensor.contiguous())


def from_dlpack(capsule_or_array) -> torch.Tensor:
    """A tensor over a DLPack capsule or an object with `__dlpack__`
    (FromDLPack, dl_converter.h:37-40)."""
    return torch.utils.dlpack.from_dlpack(capsule_or_array)


def pointcloud_to_points_dlpack(pcd):
    """cupoch PointCloud::to_points_dlpack."""
    return to_dlpack(pcd.points)


def pointcloud_from_points_dlpack(capsule_or_array):
    """A PointCloud over the points, on their device."""
    from ..geometry.pointcloud import PointCloud

    t = from_dlpack(capsule_or_array)
    return PointCloud(t, device=t.device)


def _install_geometry_methods():
    """to_*_dlpack / from_*_dlpack on PointCloud (points, normals,
    colours) and TriangleMesh (vertices), as cupoch's Python API has
    them; a from_ method moves the data to the geometry's device."""
    from ..geometry.pointcloud import PointCloud
    from ..geometry.trianglemesh import TriangleMesh

    def field(cls, name, attr):
        def to_(self):
            return to_dlpack(getattr(self, attr))

        def from_(self, capsule_or_array):
            setattr(self, attr, from_dlpack(capsule_or_array))

        setattr(cls, f"to_{name}_dlpack", to_)
        setattr(cls, f"from_{name}_dlpack", from_)

    for name in ("points", "normals", "colors"):
        field(PointCloud, name, name)
    field(TriangleMesh, "vertices", "vertices")


_install_geometry_methods()
