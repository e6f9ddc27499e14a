"""URDF forward kinematics (cupoch kinematics/kinematic_chain.{h,cpp},
kinematic_chain.h:32-110).

The URDF is parsed and the Frame tree of links and joints walked on the
host in numpy, as the reference does: joint poses are small 4x4 chains.
The links' shapes are the port's primitives, or meshes read from the
files the URDF names (`package://` stripped, relative to the URDF's
directory, scaled and moved to the shape's origin, as the reference
does); their meshes live on the chain's `device`. A mesh file that is
missing or fails to read leaves the shape without a mesh (a failed read
logs a warning), and the link is kept."""
from __future__ import annotations

import copy
import enum
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
import torch

from ..collision.primitives import Box, Cylinder, Primitive, Sphere
from ..utility import console
from ..utility.device import resolve_device


class JointType(enum.IntEnum):
    # values match kinematic_chain.h:66-70
    Fixed = 0
    Revolute = 1
    Prismatic = 2


class ShapeInfo:
    """cupoch kinematic_chain.h:32-45."""

    def __init__(self, primitive: Optional[Primitive] = None, mesh=None):
        self.primitive = primitive
        self.mesh = mesh
        if primitive is not None and mesh is None:
            self.mesh = primitive.create_mesh()


class Link:
    """cupoch kinematic_chain.h:47-62."""

    def __init__(self, name: str = "", collisions=None, visuals=None):
        self.name = name
        self.collisions: List[ShapeInfo] = collisions or []
        self.visuals: List[ShapeInfo] = visuals or []


class Joint:
    """cupoch kinematic_chain.h:64-82."""

    def __init__(self, name: str = "", jtype: JointType = JointType.Fixed,
                 offset=None, axis=(1.0, 0.0, 0.0)):
        self.name = name
        self.type = jtype
        self.offset = (np.eye(4, dtype=np.float32) if offset is None
                       else np.asarray(offset, np.float32))
        self.axis = np.asarray(axis, np.float32)


def _axis_angle(axis: np.ndarray, theta: float) -> np.ndarray:
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    K = np.asarray([[0, -axis[2], axis[1]],
                    [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0]], np.float32)
    return (np.eye(3, dtype=np.float32) + np.sin(theta) * K
            + (1 - np.cos(theta)) * (K @ K))


class Frame:
    """cupoch kinematic_chain.h:84-95."""

    def __init__(self):
        self.link = Link()
        self.joint = Joint()
        self.children: List["Frame"] = []

    def get_transform(self, theta: float = 0.0) -> np.ndarray:
        """offset ∘ joint motion (cupoch Frame::GetTransform,
        kinematic_chain.cpp)."""
        T = np.eye(4, dtype=np.float32)
        if self.joint.type == JointType.Revolute:
            T[:3, :3] = _axis_angle(self.joint.axis, theta)
        elif self.joint.type == JointType.Prismatic:
            T[:3, 3] = self.joint.axis * theta
        return self.joint.offset @ T


def _origin_to_matrix(elem) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    if elem is None:
        return T
    xyz = [float(v) for v in elem.get("xyz", "0 0 0").split()]
    rpy = [float(v) for v in elem.get("rpy", "0 0 0").split()]
    cr, sr = np.cos(rpy[0]), np.sin(rpy[0])
    cp, sp = np.cos(rpy[1]), np.sin(rpy[1])
    cy, sy = np.cos(rpy[2]), np.sin(rpy[2])
    Rz = np.asarray([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.asarray([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.asarray([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    T[:3, :3] = (Rz @ Ry @ Rx).astype(np.float32)
    T[:3, 3] = xyz
    return T


def _mesh_shape(mesh, origin, urdf_dir: str, device) -> ShapeInfo:
    from ..io import read_triangle_mesh

    fn = mesh.get("filename", "").replace("package://", "")
    path = fn if os.path.isabs(fn) else os.path.join(urdf_dir, fn)
    tri = None
    if os.path.exists(path):
        try:
            tri = read_triangle_mesh(path, device=device)
        except (OSError, ValueError, RuntimeError) as e:
            console.log_warning("[URDF] failed to load mesh %s: %s", path, e)
    if tri is not None:
        scale = mesh.get("scale")
        if scale:
            tri.vertices = tri.vertices * torch.tensor(
                [float(v) for v in scale.split()], dtype=torch.float32,
                device=tri.vertices.device)
        tri.transform(origin)
    return ShapeInfo(None, tri)


def _parse_shape(elem, urdf_dir: str, device) -> Optional[ShapeInfo]:
    geom = elem.find("geometry")
    if geom is None:
        return None
    origin = _origin_to_matrix(elem.find("origin"))
    box = geom.find("box")
    if box is not None:
        size = [float(v) for v in box.get("size", "0 0 0").split()]
        return ShapeInfo(Box(size, origin, device=device))
    sphere = geom.find("sphere")
    if sphere is not None:
        s = Sphere(float(sphere.get("radius", 0.0)), device=device)
        s.transform = origin @ s.transform
        return ShapeInfo(s)
    cyl = geom.find("cylinder")
    if cyl is not None:
        return ShapeInfo(Cylinder(float(cyl.get("radius", 0.0)),
                                  float(cyl.get("length", 0.0)), origin,
                                  device=device))
    mesh = geom.find("mesh")
    if mesh is not None:
        return _mesh_shape(mesh, origin, urdf_dir, device)
    return None


class KinematicChain:
    """cupoch kinematic_chain.h:97-110 + BuildFromURDF
    (kinematic_chain.cpp)."""

    def __init__(self, filename: str = "", device=None):
        self.device = resolve_device(device)
        self.root = Frame()
        self.link_map: Dict[str, Link] = {}
        if filename:
            self.build_from_urdf(filename)

    def build_from_urdf(self, filename: str) -> "KinematicChain":
        robot = ET.parse(filename).getroot()
        # mesh files are relative to the URDF's directory; to the
        # working directory when the URDF comes as a file object
        urdf_dir = os.path.dirname(os.path.abspath(filename)) \
            if isinstance(filename, (str, os.PathLike)) else os.getcwd()

        links: Dict[str, Link] = {}
        for le in robot.findall("link"):
            name = le.get("name", "")
            link = Link(name)
            for ce in le.findall("collision"):
                s = _parse_shape(ce, urdf_dir, self.device)
                if s is not None:
                    link.collisions.append(s)
            for ve in le.findall("visual"):
                s = _parse_shape(ve, urdf_dir, self.device)
                if s is not None:
                    link.visuals.append(s)
            links[name] = link

        joints = []
        child_names = set()
        for je in robot.findall("joint"):
            jname = je.get("name", "")
            jtype_s = je.get("type", "fixed")
            jtype = {"fixed": JointType.Fixed,
                     "revolute": JointType.Revolute,
                     "continuous": JointType.Revolute,
                     "prismatic": JointType.Prismatic}.get(
                         jtype_s, JointType.Fixed)
            parent = je.find("parent").get("link")
            child = je.find("child").get("link")
            offset = _origin_to_matrix(je.find("origin"))
            axis_e = je.find("axis")
            axis = ([float(v) for v in axis_e.get("xyz", "1 0 0").split()]
                    if axis_e is not None else [1.0, 0.0, 0.0])
            joints.append((jname, jtype, offset, axis, parent, child))
            child_names.add(child)

        roots = [n for n in links if n not in child_names]
        if not roots:
            console.log_error("[BuildFromURDF] no root link found.")
        root_name = roots[0]

        frames: Dict[str, Frame] = {}

        def frame_for(link_name):
            f = frames.get(link_name)
            if f is None:
                f = Frame()
                f.link = links[link_name]
                frames[link_name] = f
            return f

        self.root = frame_for(root_name)
        for jname, jtype, offset, axis, parent, child in joints:
            cf = frame_for(child)
            cf.joint = Joint(jname, jtype, offset, axis)
            frame_for(parent).children.append(cf)
        self.link_map = links
        return self

    def forward_kinematics(self, jmap: Optional[Dict[str, float]] = None,
                           base=None) -> Dict[str, np.ndarray]:
        """Link name -> world 4x4 pose (cupoch
        KinematicChain::ForwardKinematics, kinematic_chain.cpp)."""
        jmap = jmap or {}
        base = (np.eye(4, dtype=np.float32) if base is None
                else np.asarray(base, np.float32))
        out: Dict[str, np.ndarray] = {}

        def walk(frame: Frame, T: np.ndarray):
            theta = jmap.get(frame.joint.name, 0.0)
            Tf = T @ frame.get_transform(theta) if frame.joint.name else T
            out[frame.link.name] = Tf
            for c in frame.children:
                walk(c, Tf)

        walk(self.root, base)
        return out

    def get_transformed_visual_geometry_map(self, link_pos):
        """Visual meshes posed at the FK solution (cupoch
        GetTransformedVisualGeometryMap, kinematic_chain.cpp)."""
        out = {}
        for name, T in link_pos.items():
            link = self.link_map.get(name)
            if link is None:
                continue
            meshes = []
            for s in link.visuals:
                if s.mesh is not None:
                    m = copy.deepcopy(s.mesh)
                    m.transform(T)
                    meshes.append(m)
            if meshes:
                out[name] = meshes
        return out
