"""Render and view options with a JSON round trip (cupoch
visualization/visualizer/render_option.h, view_control.h; serialised
as IJsonConvertible does, file_json.cpp).

Host numpy in float64, as in the JAX package: the classes carry the
state that cupoch persists to JSON (compatible with cupoch / Open3D
render-option files) with no GL behind them. Fitting a view reads only
the geometry's bounds: six numbers copied from the geometry's device.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class PointColorOption(enum.IntEnum):
    """cupoch render_option.h:50-57."""

    Default = 0
    Color = 1
    XCoordinate = 2
    YCoordinate = 3
    ZCoordinate = 4
    Normal = 9


class MeshShadeOption(enum.IntEnum):
    FlatShade = 0
    SmoothShade = 1


class MeshColorOption(enum.IntEnum):
    Default = 0
    Color = 1
    XCoordinate = 2
    YCoordinate = 3
    ZCoordinate = 4
    Normal = 9


class RenderOption:
    """cupoch render_option.h (its GL-independent part)."""

    POINT_SIZE_DEFAULT = 5.0
    LINE_WIDTH_DEFAULT = 1.0

    def __init__(self):
        self.background_color = np.ones(3, np.float32)
        self.point_size = self.POINT_SIZE_DEFAULT
        self.line_width = self.LINE_WIDTH_DEFAULT
        self.point_show_normal = False
        self.mesh_show_wireframe = False
        self.mesh_show_back_face = False
        self.point_color_option = PointColorOption.Default
        self.mesh_shade_option = MeshShadeOption.FlatShade
        self.mesh_color_option = MeshColorOption.Color
        self.show_coordinate_frame = False
        self.light_on = True

    def to_dict(self) -> dict:
        return {
            "class_name": "RenderOption",
            "version_major": 1,
            "version_minor": 0,
            "background_color": [float(c) for c in self.background_color],
            "point_size": float(self.point_size),
            "line_width": float(self.line_width),
            "point_show_normal": bool(self.point_show_normal),
            "mesh_show_wireframe": bool(self.mesh_show_wireframe),
            "mesh_show_back_face": bool(self.mesh_show_back_face),
            "point_color_option": int(self.point_color_option),
            "mesh_shade_option": int(self.mesh_shade_option),
            "mesh_color_option": int(self.mesh_color_option),
            "show_coordinate_frame": bool(self.show_coordinate_frame),
            "light_on": bool(self.light_on),
        }

    @staticmethod
    def from_dict(d: dict) -> "RenderOption":
        opt = RenderOption()
        opt.background_color = np.asarray(
            d.get("background_color", [1, 1, 1]), np.float32)
        opt.point_size = float(d.get("point_size",
                                     RenderOption.POINT_SIZE_DEFAULT))
        opt.line_width = float(d.get("line_width",
                                     RenderOption.LINE_WIDTH_DEFAULT))
        opt.point_show_normal = bool(d.get("point_show_normal", False))
        opt.mesh_show_wireframe = bool(d.get("mesh_show_wireframe", False))
        opt.mesh_show_back_face = bool(d.get("mesh_show_back_face", False))
        opt.point_color_option = PointColorOption(
            d.get("point_color_option", 0))
        opt.mesh_shade_option = MeshShadeOption(
            d.get("mesh_shade_option", 0))
        opt.mesh_color_option = MeshColorOption(
            d.get("mesh_color_option", 1))
        opt.show_coordinate_frame = bool(
            d.get("show_coordinate_frame", False))
        opt.light_on = bool(d.get("light_on", True))
        return opt


def _bounds(pts):
    """(min, max) [3] of the rows of `pts` on the host, None for no
    rows; a tensor is reduced on its device and six numbers copied."""
    if pts is None or len(pts) == 0:
        return None
    pts = torch.as_tensor(pts)
    box = torch.stack([pts.amin(0), pts.amax(0)]).cpu().numpy()
    return box[0], box[1]


class ViewControl:
    """Full look-at camera model with orbit/zoom/pan/roll.

    cupoch view_control.{h,cpp}: the same state machine and
    constants: `set_projection_parameters` derives (right, eye,
    distance, view_ratio) from (front, up, lookat, zoom, fov, bbox)
    exactly as SetProjectionParameters (view_control.cpp:225-240);
    rotate/translate/scale/roll mirror the pixel-domain interactions
    (view_control.cpp:252-290) so a camera driven by the same event
    stream lands on the same extrinsics."""

    FIELD_OF_VIEW_MAX = 90.0
    FIELD_OF_VIEW_MIN = 5.0
    FIELD_OF_VIEW_DEFAULT = 60.0
    FIELD_OF_VIEW_STEP = 5.0
    ZOOM_DEFAULT = 0.7
    ZOOM_MIN = 0.02
    ZOOM_MAX = 2.0
    ZOOM_STEP = 0.02
    ROTATION_RADIAN_PER_PIXEL = 0.003

    def __init__(self):
        self.lookat = np.zeros(3, np.float64)
        self.up = np.asarray([0.0, 1.0, 0.0], np.float64)
        self.front = np.asarray([0.0, 0.0, 1.0], np.float64)
        self.zoom = self.ZOOM_DEFAULT
        self.field_of_view = self.FIELD_OF_VIEW_DEFAULT
        self.bounding_box_min = np.zeros(3, np.float64)
        self.bounding_box_max = np.ones(3, np.float64)
        self.window_width = 0
        self.window_height = 0
        self.right = np.asarray([1.0, 0.0, 0.0], np.float64)
        self.eye = np.zeros(3, np.float64)
        self.distance = 1.0
        self.view_ratio = 1.0
        self.set_projection_parameters()

    # -- geometry fitting ------------------------------------------------
    def _max_extent(self) -> float:
        return float(np.max(self.bounding_box_max
                            - self.bounding_box_min))

    def fit_in_geometry(self, *geometries):
        """Union the geometries' AABBs and reset the view onto them
        (cupoch FitInGeometry + Reset)."""
        los, his = [], []
        for g in geometries:
            box = _bounds(getattr(g, "points", getattr(g, "vertices", None)))
            if box is None:
                continue
            los.append(box[0])
            his.append(box[1])
        if los:
            self.bounding_box_min = np.min(np.stack(los), 0).astype(
                np.float64)
            self.bounding_box_max = np.max(np.stack(his), 0).astype(
                np.float64)
        self.reset()

    def reset(self):
        """cupoch view_control.cpp:215-222."""
        self.field_of_view = self.FIELD_OF_VIEW_DEFAULT
        self.zoom = self.ZOOM_DEFAULT
        self.lookat = (self.bounding_box_min
                       + self.bounding_box_max) * 0.5
        self.up = np.asarray([0.0, 1.0, 0.0], np.float64)
        self.front = np.asarray([0.0, 0.0, 1.0], np.float64)
        self.set_projection_parameters()

    def get_projection_type(self) -> str:
        return ("orthogonal"
                if self.field_of_view == self.FIELD_OF_VIEW_MIN
                else "perspective")

    def set_projection_parameters(self):
        """cupoch SetProjectionParameters, view_control.cpp:225."""
        f = self.front / np.linalg.norm(self.front)
        r = np.cross(self.up, f)
        r = r / np.linalg.norm(r)
        u = np.cross(f, r)
        self.front, self.right = f, r
        self.up = u / np.linalg.norm(u)
        ext = max(self._max_extent(), 1e-12)
        self.view_ratio = self.zoom * ext
        half = (self.field_of_view
                if self.get_projection_type() == "perspective"
                else self.FIELD_OF_VIEW_STEP) * 0.5 * np.pi / 180.0
        self.distance = self.view_ratio / np.tan(half)
        self.eye = self.lookat + self.front * self.distance

    # -- interactions ----------------------------------------------------
    def change_field_of_view(self, step: float = 1.0):
        self.field_of_view = float(np.clip(
            self.field_of_view + step * self.FIELD_OF_VIEW_STEP,
            self.FIELD_OF_VIEW_MIN, self.FIELD_OF_VIEW_MAX))
        self.set_projection_parameters()

    def change_window_size(self, width: int, height: int):
        self.window_width = int(width)
        self.window_height = int(height)
        self.set_projection_parameters()

    def scale(self, s: float):
        """Mouse-wheel zoom (view_control.cpp:252)."""
        self.zoom = float(np.clip(self.zoom + s * self.ZOOM_STEP,
                                  self.ZOOM_MIN, self.ZOOM_MAX))
        self.set_projection_parameters()

    def rotate(self, x: float, y: float, xo: float = 0.0,
               yo: float = 0.0):
        """Orbit by mouse pixels (view_control.cpp:258-270)."""
        alpha = x * self.ROTATION_RADIAN_PER_PIXEL
        beta = y * self.ROTATION_RADIAN_PER_PIXEL
        f = self.front * np.cos(alpha) - self.right * np.sin(alpha)
        f = f / np.linalg.norm(f)
        r = np.cross(self.up, f)
        self.right = r / np.linalg.norm(r)
        f2 = f * np.cos(beta) + self.up * np.sin(beta)
        self.front = f2 / np.linalg.norm(f2)
        u = np.cross(self.front, self.right)
        self.up = u / np.linalg.norm(u)
        self.set_projection_parameters()

    def translate(self, x: float, y: float, xo: float = 0.0,
                  yo: float = 0.0):
        """Pan by mouse pixels (view_control.cpp:272-281)."""
        h = max(self.window_height, 1)
        shift = (self.right * (-x) + self.up * y) / h \
            * self.view_ratio * 2.0
        self.eye = self.eye + shift
        self.lookat = self.lookat + shift
        self.set_projection_parameters()

    def roll(self, x: float):
        """Roll about the view axis (view_control.cpp:283-290,
        Rodrigues about front)."""
        alpha = x * self.ROTATION_RADIAN_PER_PIXEL
        f, u = self.front, self.up
        self.up = (u * np.cos(alpha) + np.cross(f, u) * np.sin(alpha)
                   + f * f.dot(u) * (1.0 - np.cos(alpha)))
        self.set_projection_parameters()

    # -- conversions -----------------------------------------------------
    def convert_to_pinhole_camera_parameters(self):
        """cupoch view_control.cpp:115-157 (same extrinsic rows:
        (right, -up, -front) with the matching translation)."""
        from ..camera.pinhole_camera_intrinsic import (
            PinholeCameraIntrinsic, PinholeCameraParameters,
        )

        if self.window_width <= 0 or self.window_height <= 0 or \
                self.get_projection_type() == "orthogonal":
            return None
        self.set_projection_parameters()
        p = PinholeCameraParameters()
        tan_half = np.tan(self.field_of_view * 0.5 * np.pi / 180.0)
        focal = self.window_height / tan_half / 2.0
        p.intrinsic = PinholeCameraIntrinsic(
            self.window_width, self.window_height, focal, focal,
            self.window_width / 2.0 - 0.5,
            self.window_height / 2.0 - 0.5)
        ext = np.zeros((4, 4), np.float64)
        ext[0, :3] = self.right
        ext[1, :3] = -self.up
        ext[2, :3] = -self.front
        ext[0, 3] = -self.right.dot(self.eye)
        ext[1, 3] = self.up.dot(self.eye)
        ext[2, 3] = self.front.dot(self.eye)
        ext[3, 3] = 1.0
        p.extrinsic = ext
        return p

    def convert_from_pinhole_camera_parameters(self, p) -> bool:
        """cupoch view_control.cpp:159-203."""
        K = np.asarray(p.intrinsic.intrinsic_matrix, np.float64)
        ext = np.asarray(p.extrinsic, np.float64)
        if self.window_width != p.intrinsic.width or \
                self.window_height != p.intrinsic.height or \
                self.window_width <= 0:
            return False
        tan_half = self.window_height / (K[1, 1] * 2.0)
        self.field_of_view = float(np.clip(
            np.arctan(tan_half) * 2.0 * 180.0 / np.pi,
            self.FIELD_OF_VIEW_MIN, self.FIELD_OF_VIEW_MAX))
        self.right = ext[0, :3].copy()
        self.up = -ext[1, :3]
        self.front = -ext[2, :3]
        self.eye = np.linalg.inv(ext[:3, :3]) @ (-ext[:3, 3])
        center = (self.bounding_box_min + self.bounding_box_max) * 0.5
        ideal_distance = (self.eye - center).dot(self.front)
        half = self.field_of_view * 0.5 * np.pi / 180.0
        ideal_zoom = ideal_distance * np.tan(half) \
            / max(self._max_extent(), 1e-12)
        self.zoom = float(np.clip(ideal_zoom, self.ZOOM_MIN,
                                  self.ZOOM_MAX))
        self.view_ratio = self.zoom * self._max_extent()
        self.distance = self.view_ratio / np.tan(half)
        self.lookat = self.eye - self.front * self.distance
        return True

    def convert_to_view_parameters(self):
        from .view_trajectory import ViewParameters

        s = ViewParameters()
        s.field_of_view = self.field_of_view
        s.zoom = self.zoom
        s.lookat = self.lookat.copy()
        s.up = self.up.copy()
        s.front = self.front.copy()
        s.boundingbox_min = self.bounding_box_min.copy()
        s.boundingbox_max = self.bounding_box_max.copy()
        return s

    def convert_from_view_parameters(self, s) -> bool:
        self.field_of_view = float(s.field_of_view)
        self.zoom = float(s.zoom)
        self.lookat = np.asarray(s.lookat, np.float64)
        self.up = np.asarray(s.up, np.float64)
        self.front = np.asarray(s.front, np.float64)
        self.bounding_box_min = np.asarray(s.boundingbox_min,
                                           np.float64)
        self.bounding_box_max = np.asarray(s.boundingbox_max,
                                           np.float64)
        self.set_projection_parameters()
        return True

    # single-field setters
    def set_lookat(self, v):
        self.lookat = np.asarray(v, np.float64)
        self.set_projection_parameters()

    def set_up(self, v):
        self.up = np.asarray(v, np.float64)
        self.set_projection_parameters()

    def set_front(self, v):
        self.front = np.asarray(v, np.float64)
        self.set_projection_parameters()

    def set_zoom(self, z):
        self.zoom = float(z)
        self.set_projection_parameters()

    def to_dict(self) -> dict:
        return {
            "class_name": "ViewControl",
            "lookat": [float(c) for c in self.lookat],
            "up": [float(c) for c in self.up],
            "front": [float(c) for c in self.front],
            "zoom": float(self.zoom),
            "field_of_view": float(self.field_of_view),
        }

    @staticmethod
    def from_dict(d: dict) -> "ViewControl":
        vc = ViewControl()
        vc.lookat = np.asarray(d.get("lookat", [0, 0, 0]), np.float32)
        vc.up = np.asarray(d.get("up", [0, 1, 0]), np.float32)
        vc.front = np.asarray(d.get("front", [0, 0, 1]), np.float32)
        vc.zoom = float(d.get("zoom", 0.7))
        vc.field_of_view = float(d.get("field_of_view", 60.0))
        return vc
