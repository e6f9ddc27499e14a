"""PointCloud file IO: PLY, PCD (ascii, binary, binary_compressed) and
XYZ (cupoch io/class_io/pointcloud_io.cpp:38-51 dispatch by extension;
file_ply.cu, file_pcd.cu, file_xyz.cu).

Files are parsed and written with numpy over the raw bytes on the host;
readers put the cloud on `device` (None: the card), writers take a
cloud on any device. PCD binary_compressed goes through the C LZF codec
(`utility.lzf`), which must build; only data that does not compress is
stored raw, as the format allows.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..geometry.pointcloud import PointCloud
from ..utility import console, lzf


def to_numpy(x, dtype=None) -> np.ndarray:
    """A tensor of any device, or an array, as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def _parse_ply_header(f):
    line = f.readline().decode("ascii", "replace").strip()
    if line != "ply":
        console.log_error("[ReadPLY] not a ply file.")
    fmt = None
    # (name, count, [(prop_name, dtype, is_list, list_count_dtype)])
    elements = []
    cur = None
    while True:
        line = f.readline().decode("ascii", "replace").strip()
        if not line or line.startswith(("comment", "obj_info")):
            continue
        parts = line.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property":
            if parts[1] == "list":
                cur[2].append((parts[4], _PLY_DTYPES[parts[3]], True,
                               _PLY_DTYPES[parts[2]]))
            else:
                cur[2].append((parts[2], _PLY_DTYPES[parts[1]], False, None))
        elif parts[0] == "end_header":
            break
    return fmt, elements


def _read_ply_elements(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    with open(path, "rb") as f:
        fmt, elements = _parse_ply_header(f)
        endian = "<" if fmt == "binary_little_endian" else ">"
        out: Dict[str, Dict[str, np.ndarray]] = {}
        if fmt == "ascii":
            rows_needed = sum(c for _, c, _ in elements)
            text = f.read().decode("ascii", "replace").split("\n")
            li = 0
            for name, count, props in elements:
                has_list = any(p[2] for p in props)
                if not has_list:
                    data = np.loadtxt(text[li:li + count], ndmin=2)
                    li += count
                    out[name] = {p[0]: data[:, i] for i, p in enumerate(props)}
                else:
                    # list property (faces): fixed arity assumed per row
                    rows = []
                    for k in range(count):
                        vals = text[li + k].split()
                        n = int(vals[0])
                        rows.append([float(v) for v in vals[1:1 + n]])
                    li += count
                    out[name] = {props[0][0]: np.asarray(rows)}
        else:
            for name, count, props in elements:
                has_list = any(p[2] for p in props)
                if not has_list:
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    buf = f.read(dt.itemsize * count)
                    rec = np.frombuffer(buf, dt, count)
                    out[name] = {p[0]: rec[p[0]] for p in props}
                else:
                    # assume uniform list arity (triangles); peek first
                    p = props[0]
                    cnt_dt = np.dtype(endian + p[3])
                    pos = f.tell()
                    first_n = int(np.frombuffer(f.read(cnt_dt.itemsize),
                                                cnt_dt, 1)[0])
                    f.seek(pos)
                    dt = np.dtype([("n", endian + p[3]),
                                   ("v", endian + p[1], (first_n,))])
                    rec = np.frombuffer(f.read(dt.itemsize * count), dt, count)
                    out[name] = {p[0]: rec["v"]}
        return out


def read_point_cloud_ply(path: str, device=None) -> PointCloud:
    els = _read_ply_elements(path)
    v = els.get("vertex")
    if v is None:
        console.log_error("[ReadPLY] no vertex element.")
    pcd = PointCloud(np.stack(
        [v["x"], v["y"], v["z"]], -1).astype(np.float32), device=device)
    if all(k in v for k in ("nx", "ny", "nz")):
        pcd.normals = np.stack(
            [v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
    if all(k in v for k in ("red", "green", "blue")):
        pcd.colors = np.stack(
            [v["red"], v["green"], v["blue"]], -1).astype(np.float32) / 255.0
    return pcd


def write_point_cloud_ply(path: str, pcd, write_ascii: bool = False):
    n = len(pcd)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols: List[np.ndarray] = [to_numpy(pcd.points, np.float32)]
    if pcd.has_normals():
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        cols.append(to_numpy(pcd.normals, np.float32))
    if pcd.has_colors():
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols.append(np.clip(to_numpy(pcd.colors) * 255.0, 0,
                            255).astype(np.uint8))
    header = ["ply",
              "format ascii 1.0" if write_ascii
              else "format binary_little_endian 1.0",
              f"element vertex {n}"]
    ply_types = {"f4": "float", "u1": "uchar"}
    for name, t in props:
        header.append(f"property {ply_types[t]} {name}")
    header.append("end_header\n")
    dt = np.dtype([(name, "<" + t) for name, t in props])
    rec = np.empty(n, dt)
    i = 0
    for c in cols:
        for j in range(c.shape[1]):
            rec[props[i][0]] = c[:, j]
            i += 1
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if write_ascii:
            fmtstr = " ".join("%d" if t == "u1" else "%.8g"
                              for _, t in props)
            np.savetxt(f, np.column_stack([c.astype(np.float64)
                                           for c in cols]), fmt=fmtstr)
        else:
            f.write(rec.tobytes())
    return True


# ---------------------------------------------------------------------------
# PCD
# ---------------------------------------------------------------------------

def _parse_pcd_header(f) -> Tuple[dict, int]:
    header = {}
    while True:
        line = f.readline().decode("ascii", "replace")
        if not line:
            console.log_error("[ReadPCD] truncated header.")
        s = line.strip()
        if s.startswith("#") or not s:
            continue
        key, _, rest = s.partition(" ")
        header[key.upper()] = rest.split()
        if key.upper() == "DATA":
            return header, f.tell()


def read_point_cloud_pcd(path: str, device=None) -> PointCloud:
    with open(path, "rb") as f:
        header, offset = _parse_pcd_header(f)
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0]) if "POINTS" in header else (
            int(header["WIDTH"][0]) * int(header["HEIGHT"][0]))
        mode = header["DATA"][0]
        np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1",
                    ("U", 2): "u2", ("U", 4): "u4", ("I", 1): "i1",
                    ("I", 2): "i2", ("I", 4): "i4"}
        dt_fields = []
        for name, s, t, c in zip(fields, sizes, types, counts):
            base = np_types[(t, s)]
            dt_fields.append((name, "<" + base, (c,)) if c > 1
                             else (name, "<" + base))
        dt = np.dtype(dt_fields)

        if mode == "ascii":
            raw = np.loadtxt(f, ndmin=2)
            cols = {}
            i = 0
            for name, s, t, c in zip(fields, sizes, types, counts):
                cols[name] = raw[:, i:i + c].squeeze(-1) if c == 1 \
                    else raw[:, i:i + c]
                i += c
        elif mode == "binary":
            rec = np.frombuffer(f.read(dt.itemsize * n), dt, n)
            cols = {name: rec[name] for name in fields}
        elif mode == "binary_compressed":
            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            payload = f.read(comp_size)
            # comp_size == uncomp_size ⇒ stored raw (incompressible data)
            blob = (payload if comp_size == uncomp_size
                    else lzf.decompress(payload, uncomp_size))
            # compressed PCD stores fields contiguously (SoA)
            cols = {}
            pos = 0
            for name, s, t, c in zip(fields, sizes, types, counts):
                base = np.dtype("<" + np_types[(t, s)])
                nbytes = base.itemsize * c * n
                arr = np.frombuffer(blob[pos:pos + nbytes], base)
                cols[name] = arr.reshape(n, c).squeeze(-1) if c == 1 \
                    else arr.reshape(n, c)
                pos += nbytes
        else:
            console.log_error(f"[ReadPCD] unknown DATA mode {mode}.")

    pts = np.stack([cols["x"], cols["y"], cols["z"]], -1) \
        .astype(np.float32)
    normals = colors = None
    if all(k in cols for k in ("normal_x", "normal_y", "normal_z")):
        normals = np.stack(
            [cols["normal_x"], cols["normal_y"], cols["normal_z"]],
            -1).astype(np.float32)
    if "rgb" in cols:
        rgb = np.ascontiguousarray(
            cols["rgb"].astype(np.float32)).view(np.uint32)
        r = (rgb >> 16) & 0xFF
        g = (rgb >> 8) & 0xFF
        b = rgb & 0xFF
        colors = (np.stack([r, g, b], -1) / 255.0).astype(np.float32)
    elif all(k in cols for k in ("r", "g", "b")):
        colors = np.stack(
            [cols["r"], cols["g"], cols["b"]], -1).astype(np.float32) / 255.0
    # drop NaN points (PCD stores invalid points as NaN rows)
    ok = np.isfinite(pts).all(-1)
    pcd = PointCloud(pts[ok], device=device)
    if normals is not None:
        pcd.normals = normals[ok]
    if colors is not None:
        pcd.colors = colors[ok]
    return pcd


def write_point_cloud_pcd(path: str, pcd, write_ascii: bool = False,
                          compressed: bool = False):
    n = len(pcd)
    fields = ["x", "y", "z"]
    data = [to_numpy(pcd.points, np.float32)]
    if pcd.has_normals():
        fields += ["normal_x", "normal_y", "normal_z"]
        data.append(to_numpy(pcd.normals, np.float32))
    if pcd.has_colors():
        fields.append("rgb")
        c = np.clip(to_numpy(pcd.colors) * 255.0, 0, 255).astype(np.uint32)
        packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
        data.append(packed.view(np.float32)[:, None])
    flat = np.column_stack(data).astype(np.float32)
    mode = ("ascii" if write_ascii
            else "binary_compressed" if compressed else "binary")
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(fields),
        "SIZE " + " ".join(["4"] * len(fields)),
        "TYPE " + " ".join(["F"] * len(fields)),
        "COUNT " + " ".join(["1"] * len(fields)),
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {mode}\n"])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if write_ascii:
            np.savetxt(f, flat, fmt="%.8g")
        elif compressed:
            soa = np.concatenate([np.ascontiguousarray(flat[:, i])
                                  for i in range(flat.shape[1])])
            raw = soa.tobytes()
            comp = lzf.compress(raw)
            if comp is None:
                comp = raw  # incompressible: stored raw, as PCD allows
            f.write(struct.pack("<II", len(comp), len(raw)))
            f.write(comp)
        else:
            f.write(np.ascontiguousarray(flat).tobytes())
    return True


# ---------------------------------------------------------------------------
# XYZ
# ---------------------------------------------------------------------------

def read_point_cloud_xyz(path: str, device=None) -> PointCloud:
    data = np.loadtxt(path, ndmin=2)
    return PointCloud(data[:, :3].astype(np.float32), device=device)


def write_point_cloud_xyz(path: str, pcd):
    np.savetxt(path, to_numpy(pcd.points), fmt="%.8g")
    return True


# ---------------------------------------------------------------------------
# dispatch (cupoch pointcloud_io.cpp:38-51)
# ---------------------------------------------------------------------------

_READERS = {
    "ply": read_point_cloud_ply,
    "pcd": read_point_cloud_pcd,
    "xyz": read_point_cloud_xyz,
}
_WRITERS = {
    "ply": write_point_cloud_ply,
    "pcd": write_point_cloud_pcd,
    "xyz": write_point_cloud_xyz,
}


def read_point_cloud(path: str, format: str = "auto",
                     device=None) -> PointCloud:
    ext = (os.path.splitext(path)[1][1:].lower() if format == "auto"
           else format)
    fn = _READERS.get(ext)
    if fn is None:
        console.log_error(
            f"Read geometry::PointCloud failed: unknown file extension "
            f"{ext}.")
    pcd = fn(path, device)
    console.log_debug("Read PointCloud: %d vertices.", len(pcd))
    return pcd


def write_point_cloud(path: str, pcd, write_ascii: bool = False,
                      compressed: bool = False, format: str = "auto") -> bool:
    ext = (os.path.splitext(path)[1][1:].lower() if format == "auto"
           else format)
    fn = _WRITERS.get(ext)
    if fn is None:
        console.log_error(
            f"Write geometry::PointCloud failed: unknown file extension "
            f"{ext}.")
    if ext == "pcd":
        return fn(path, pcd, write_ascii, compressed)
    if ext == "ply":
        return fn(path, pcd, write_ascii)
    return fn(path, pcd)
