"""VoxelGrid file IO: the PLY layout of cupoch and Open3D
(io/class_io/voxelgrid_io.cpp, io/file_format/file_ply.cu:611-750) with
three elements: `origin` (x, y, z double), `voxel_size` (val double) and
`vertex` (the integer grid indices as x, y, z double, with red, green,
blue uchar colours when the grid has them). The reader puts the grid on
`device` (None: the card); the writer takes a grid on any device.
"""
from __future__ import annotations

import os

import numpy as np

from ..geometry.voxelgrid import VoxelGrid
from ..utility import console
from .pointcloud_io import _read_ply_elements, to_numpy


def _ext(path: str, format: str) -> str:
    return os.path.splitext(path)[1][1:].lower() if format == "auto" \
        else format


def read_voxel_grid(path: str, format: str = "auto",
                    device=None) -> VoxelGrid:
    """cupoch ReadVoxelGrid (voxelgrid_io.cpp:63)."""
    if _ext(path, format) != "ply":
        console.log_error("Read VoxelGrid failed: unknown extension %s",
                          _ext(path, format))
    els = _read_ply_elements(path)
    origin, voxel_size = np.zeros(3, np.float32), 0.0
    if "origin" in els:
        o = els["origin"]
        origin = np.asarray([o["x"][0], o["y"][0], o["z"][0]], np.float32)
    if "voxel_size" in els:
        voxel_size = float(els["voxel_size"]["val"][0])
    v = els.get("vertex")
    if v is None or "x" not in v:
        return VoxelGrid.from_numpy(np.zeros((0, 3), np.int32),
                                    np.zeros((0, 3), np.float32),
                                    voxel_size, origin, device=device)
    keys = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.int32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]],
                        -1).astype(np.float32) / 255.0
    else:
        cols = np.zeros((len(keys), 3), np.float32)
    return VoxelGrid.from_numpy(keys, cols, voxel_size, origin,
                                device=device)


def write_voxel_grid(path: str, voxelgrid: VoxelGrid,
                     write_ascii: bool = False,
                     format: str = "auto") -> bool:
    """cupoch WriteVoxelGrid (voxelgrid_io.cpp:88), WriteVoxelGridToPLY
    (file_ply.cu:684-750)."""
    if _ext(path, format) != "ply":
        console.log_error("Write VoxelGrid failed: unknown extension %s",
                          _ext(path, format))
    keys = to_numpy(voxelgrid.voxels_keys, np.float64)
    has_colors = voxelgrid.has_colors()
    n = len(keys)
    fmt = "ascii" if write_ascii else "binary_little_endian"
    header = [
        "ply",
        f"format {fmt} 1.0",
        "comment Created by cupoch_tpu_torch",
        "element origin 1",
        "property double x",
        "property double y",
        "property double z",
        "element voxel_size 1",
        "property double val",
        f"element vertex {n}",
        "property double x",
        "property double y",
        "property double z",
    ]
    if has_colors:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    origin = np.asarray(voxelgrid.origin, np.float64)
    if has_colors:
        cols = np.clip(to_numpy(voxelgrid.voxels_colors, np.float64)
                       * 255.0, 0.0, 255.0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if write_ascii:
            f.write(f"{origin[0]} {origin[1]} {origin[2]}\n"
                    .encode("ascii"))
            f.write(f"{float(voxelgrid.voxel_size)}\n".encode("ascii"))
            rows = [f"{k[0]:.0f} {k[1]:.0f} {k[2]:.0f}" for k in keys]
            if has_colors:
                rows = [f"{r} {c[0]} {c[1]} {c[2]}"
                        for r, c in zip(rows, cols)]
            f.write("".join(r + "\n" for r in rows).encode("ascii"))
        else:
            f.write(origin.astype("<f8").tobytes())
            f.write(np.float64(voxelgrid.voxel_size)
                    .astype("<f8").tobytes())
            if has_colors:
                rec = np.dtype([("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                                ("r", "u1"), ("g", "u1"), ("b", "u1")])
                rows = np.empty(n, rec)
                rows["x"], rows["y"], rows["z"] = keys.T
                rows["r"], rows["g"], rows["b"] = cols.T
                f.write(rows.tobytes())
            else:
                f.write(keys.astype("<f8").tobytes())
    return True
