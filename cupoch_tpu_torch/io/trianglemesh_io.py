"""TriangleMesh file IO: PLY, OBJ with its material's texture and the
corners' UVs, and STL, ASCII or binary (cupoch
io/class_io/trianglemesh_io.cpp, file_ply.cu, file_obj.cu, file_stl.cu).

Files are parsed and written with numpy on the host; readers put the
mesh on `device` (None: the card), writers take a mesh on any device.
An OBJ's texture is a PNG, read and written by `image_io`'s own codec.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..geometry.trianglemesh import TriangleMesh
from ..utility import console
from .image_io import read_image, write_image
from .pointcloud_io import _read_ply_elements, to_numpy


def read_triangle_mesh_ply(path: str, device=None) -> TriangleMesh:
    els = _read_ply_elements(path)
    v = els.get("vertex")
    if v is None:
        console.log_error("[ReadPLY] no vertex element.")
    verts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    faces = None
    for fname in ("face",):
        if fname in els:
            d = els[fname]
            key = next(iter(d))
            faces = np.asarray(d[key], np.int32)
    mesh = TriangleMesh(verts, faces if faces is not None
                        else np.zeros((0, 3), np.int32), device=device)
    if all(k in v for k in ("nx", "ny", "nz")):
        mesh.vertex_normals = np.stack(
            [v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
    if all(k in v for k in ("red", "green", "blue")):
        mesh.vertex_colors = np.stack(
            [v["red"], v["green"], v["blue"]], -1).astype(np.float32) / 255.0
    return mesh


def write_triangle_mesh_ply(path: str, mesh, write_ascii: bool = False):
    verts = to_numpy(mesh.vertices, np.float32)
    tris = to_numpy(mesh.triangles, np.int32)
    n, m = len(verts), len(tris)
    header = ["ply",
              "format ascii 1.0" if write_ascii
              else "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    has_n = mesh.has_vertex_normals()
    has_c = mesh.has_vertex_colors()
    if has_n:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {m}",
               "property list uchar int vertex_indices", "end_header\n"]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        cols = [verts]
        if has_n:
            cols.append(to_numpy(mesh.vertex_normals, np.float32))
        if has_c:
            cols.append(np.clip(to_numpy(mesh.vertex_colors) * 255, 0,
                                255).astype(np.uint8))
        if write_ascii:
            flat = np.column_stack([c.astype(np.float64) for c in cols])
            fmt = " ".join(["%.8g"] * (3 + (3 if has_n else 0))
                           + (["%d"] * 3 if has_c else []))
            np.savetxt(f, flat, fmt=fmt)
            np.savetxt(f, np.column_stack(
                [np.full(m, 3, np.int32), tris]), fmt="%d")
        else:
            fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if has_n:
                fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
            if has_c:
                fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            rec = np.empty(n, np.dtype(fields))
            i = 0
            for c in cols:
                for j in range(c.shape[1]):
                    rec[fields[i][0]] = c[:, j]
                    i += 1
            f.write(rec.tobytes())
            frec = np.empty(m, np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
            frec["n"] = 3
            frec["v"] = tris
            f.write(frec.tobytes())
    return True


def _triangle_corners(f_rows):
    """(faces [m, 3], corner UV indices [3m], -1 where a corner has
    none) of OBJ `f` lines given with the vertex count before each;
    polygons are fanned. Lines of three `v` or `v/vt` corners with
    positive indices (what the writer writes) are parsed in one pass."""
    text = " ".join(line[2:] for _, line in f_rows)
    parts = 1 + text.count("/") // max(3 * len(f_rows), 1)
    if f_rows and parts <= 2 and "//" not in text:
        ints = np.asarray(text.replace("/", " ").split(), np.int64)
        if ints.size == 3 * parts * len(f_rows) and ints.min() > 0 \
                and all(len(line.split()) == 4 for _, line in f_rows):
            ints = ints.reshape(-1, 3, parts) - 1
            uv = ints[:, :, 1].reshape(-1) if parts == 2 \
                else np.full(3 * len(f_rows), -1, np.int64)
            return ints[:, :, 0].tolist(), uv.tolist()
    faces, face_uvs = [], []
    for n_verts, line in f_rows:
        toks = [t.split("/") for t in line.split()[1:]]
        idx = [int(t[0]) for t in toks]
        idx = [i - 1 if i > 0 else n_verts + i for i in idx]
        ti = [int(t[1]) - 1 if len(t) > 1 and t[1] else -1 for t in toks]
        for k in range(1, len(idx) - 1):  # fan triangulation
            faces.append([idx[0], idx[k], idx[k + 1]])
            face_uvs.extend([ti[0], ti[k], ti[k + 1]])
    return faces, face_uvs


def read_triangle_mesh_obj(path: str, device=None) -> TriangleMesh:
    """OBJ: v / vt / vn / f v[/vt[/vn]] lines, polygons fanned into
    triangles, and the first `mtllib` material's `map_Kd` texture
    (cupoch file_obj.cu:83-150: per-corner UVs, kept only when every
    corner has one)."""
    with open(path, "r", errors="replace") as f:
        lines = f.read().splitlines()
    v_rows, vn_rows, vt_rows, f_rows, mtllibs = [], [], [], [], []
    for line in lines:
        if line.startswith("v "):
            v_rows.append(line)
        elif line.startswith("vn "):
            vn_rows.append(line)
        elif line.startswith("vt "):
            vt_rows.append(line)
        elif line.startswith("f "):
            f_rows.append((len(v_rows), line))   # relative indices count
        elif line.startswith("mtllib "):          # the vertices before
            mtllibs.append(line.split(None, 1)[1].strip())

    def numbers(rows, k):
        toks = " ".join(ln.split(None, 1)[1] if " " in ln else ""
                        for ln in rows).split()
        if len(toks) == k * len(rows):       # k numbers on every line
            return np.asarray(toks, np.float64).reshape(len(rows), k)
        return np.asarray([ln.split()[1:k + 1] for ln in rows],
                          np.float64).reshape(len(rows), k)

    faces, face_uvs = _triangle_corners(f_rows)
    verts = numbers(v_rows, 3)
    mesh = TriangleMesh(verts.astype(np.float32),
                        np.asarray(faces, np.int32) if faces
                        else np.zeros((0, 3), np.int32), device=device)
    if vn_rows and len(vn_rows) == len(v_rows):
        mesh.vertex_normals = numbers(vn_rows, 3).astype(np.float32)
    # UVs only when every corner carries one (file_obj.cu:137-140)
    if vt_rows and face_uvs and min(face_uvs) >= 0:
        uv_arr = numbers(vt_rows, 2).astype(np.float32)
        mesh.triangle_uvs = uv_arr[np.asarray(face_uvs, np.int64)]
    # texture via the first material's diffuse map (file_obj.cu:148)
    base = os.path.dirname(os.path.abspath(path))
    for lib in mtllibs:
        mtl_path = os.path.join(base, lib)
        if not os.path.exists(mtl_path):
            continue
        with open(mtl_path, "r", errors="replace") as mf:
            for line in mf:
                if line.strip().startswith("map_Kd"):
                    tex = os.path.join(base,
                                       line.split(None, 1)[1].strip())
                    if os.path.exists(tex):
                        mesh.texture = read_image(tex, device=mesh.device)
                        break
        if mesh.texture is not None:
            break
    return mesh


def _rows(fmt: str, arr: np.ndarray) -> str:
    """The text `np.savetxt` writes for `arr` [n, k] with `fmt`, formatted
    in one pass."""
    arr = np.asarray(arr)
    return ((fmt + "\n") * len(arr)) % tuple(arr.reshape(-1).tolist())


def write_triangle_mesh_obj(path: str, mesh, write_triangle_uvs=True):
    """OBJ with a vt line a corner, and beside it a .mtl and the texture
    as PNG when the mesh carries them (cupoch file_obj.cu:163-240)."""
    verts = to_numpy(mesh.vertices)
    tris = to_numpy(mesh.triangles) + 1
    write_triangle_uvs = write_triangle_uvs and mesh.has_triangle_uvs()
    base, _ = os.path.splitext(path)
    name = os.path.basename(base)
    has_tex = mesh.has_texture()
    with open(path, "w") as f:
        f.write("# exported by cupoch_tpu_torch\n")
        if write_triangle_uvs or has_tex:
            f.write(f"mtllib {name}.mtl\n")
        f.write(_rows("v %.8g %.8g %.8g", verts))
        if write_triangle_uvs:
            uv = to_numpy(mesh.triangle_uvs)
            f.write(_rows("vt %.8g %.8g", uv))
            f.write(f"usemtl {name}\n")
            corner = np.arange(1, uv.shape[0] + 1).reshape(-1, 3)
            rows = np.stack([tris[:, 0], corner[:, 0],
                             tris[:, 1], corner[:, 1],
                             tris[:, 2], corner[:, 2]], -1)
            f.write(_rows("f %d/%d %d/%d %d/%d", rows))
        else:
            f.write(_rows("f %d %d %d", tris))
    if write_triangle_uvs or has_tex:
        with open(base + ".mtl", "w") as mf:
            mf.write(f"newmtl {name}\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\n")
            if has_tex:
                mf.write(f"map_Kd {name}.png\n")
        if has_tex:
            write_image(base + ".png", mesh.texture)
    return True


def read_triangle_mesh_stl(path: str, device=None) -> TriangleMesh:
    """STL, binary or ASCII (cupoch file_stl.cu); equal corners become
    one vertex, in sorted order, to recover the shared topology."""
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    is_ascii = head[:5] == b"solid" and b"facet" in (head + rest[:512])
    if is_ascii:
        verts = []
        for line in (head + rest).decode("ascii", "replace").splitlines():
            s = line.strip()
            if s.startswith("vertex"):
                verts.append([float(x) for x in s.split()[1:4]])
        tri_pts = np.asarray(verts, np.float32).reshape(-1, 3, 3)
    else:
        n = struct.unpack("<I", rest[:4])[0]
        dt = np.dtype([("normal", "<f4", (3,)), ("v", "<f4", (3, 3)),
                       ("attr", "<u2")])
        rec = np.frombuffer(rest[4:4 + dt.itemsize * n], dt, n)
        tri_pts = rec["v"].astype(np.float32)
    flat = tri_pts.reshape(-1, 3)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    return TriangleMesh(uniq, inv.reshape(-1, 3).astype(np.int32),
                        device=device)


def write_triangle_mesh_stl(path: str, mesh):
    verts = to_numpy(mesh.vertices, np.float32)
    tris = to_numpy(mesh.triangles, np.int32)
    v = verts[tris]                                    # [M,3,3]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    nrm = np.cross(e1, e2)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    rec = np.zeros(len(tris), np.dtype(
        [("normal", "<f4", (3,)), ("v", "<f4", (3, 3)), ("attr", "<u2")]))
    rec["normal"] = nrm
    rec["v"] = v
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        f.write(rec.tobytes())
    return True


_READERS = {
    "ply": read_triangle_mesh_ply,
    "obj": read_triangle_mesh_obj,
    "stl": read_triangle_mesh_stl,
}
_WRITERS = {
    "ply": write_triangle_mesh_ply,
    "obj": write_triangle_mesh_obj,
    "stl": write_triangle_mesh_stl,
}


def read_triangle_mesh(path: str, format: str = "auto",
                       device=None) -> TriangleMesh:
    ext = (os.path.splitext(path)[1][1:].lower() if format == "auto"
           else format)
    fn = _READERS.get(ext)
    if fn is None:
        console.log_error(
            f"Read geometry::TriangleMesh failed: unknown file extension "
            f"{ext}.")
    mesh = fn(path, device)
    console.log_debug("Read TriangleMesh: %d vertices, %d triangles.",
                      int(mesh.vertices.shape[0]),
                      int(mesh.triangles.shape[0]))
    return mesh


def write_triangle_mesh(path: str, mesh, write_ascii: bool = False,
                        format: str = "auto") -> bool:
    ext = (os.path.splitext(path)[1][1:].lower() if format == "auto"
           else format)
    fn = _WRITERS.get(ext)
    if fn is None:
        console.log_error(
            f"Write geometry::TriangleMesh failed: unknown file extension "
            f"{ext}.")
    if ext == "ply":
        return fn(path, mesh, write_ascii)
    return fn(path, mesh)
