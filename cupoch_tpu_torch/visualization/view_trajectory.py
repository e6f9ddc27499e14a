"""Camera view parameters and trajectories with a JSON round trip
(cupoch visualization/visualizer/view_parameters.{h,cpp} and
view_trajectory.{h,cpp}): the `class_name = "ViewTrajectory"` schema of
cupoch / Open3D view files, and `get_interpolated_frame`'s cubic-spline
camera path (view_trajectory.cpp:33-126) for fly-throughs. Host numpy
in float64.
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from ..utility import console

INTERVAL_MAX = 59
INTERVAL_MIN = 0
INTERVAL_STEP = 1
INTERVAL_DEFAULT = 29


class ViewParameters:
    """cupoch view_parameters.h:30-62 (17-float vector layout:
    fov, zoom, lookat, up, front, bbox_min, bbox_max)."""

    def __init__(self):
        self.field_of_view = 60.0
        self.zoom = 0.7
        self.lookat = np.zeros(3, np.float64)
        self.up = np.asarray([0.0, 1.0, 0.0], np.float64)
        self.front = np.asarray([0.0, 0.0, 1.0], np.float64)
        self.boundingbox_min = np.zeros(3, np.float64)
        self.boundingbox_max = np.zeros(3, np.float64)

    def convert_to_vector17(self) -> np.ndarray:
        return np.concatenate([
            [self.field_of_view, self.zoom], self.lookat, self.up,
            self.front, self.boundingbox_min, self.boundingbox_max])

    def convert_from_vector17(self, v) -> "ViewParameters":
        v = np.asarray(v, np.float64)
        self.field_of_view = float(v[0])
        self.zoom = float(v[1])
        self.lookat = v[2:5].copy()
        self.up = v[5:8].copy()
        self.front = v[8:11].copy()
        self.boundingbox_min = v[11:14].copy()
        self.boundingbox_max = v[14:17].copy()
        return self

    def to_json_dict(self) -> dict:
        return {
            "field_of_view": self.field_of_view,
            "zoom": self.zoom,
            "lookat": list(map(float, self.lookat)),
            "up": list(map(float, self.up)),
            "front": list(map(float, self.front)),
            "boundingbox_min": list(map(float, self.boundingbox_min)),
            "boundingbox_max": list(map(float, self.boundingbox_max)),
        }

    def from_json_dict(self, d: dict) -> bool:
        try:
            self.field_of_view = float(d["field_of_view"])
            self.zoom = float(d["zoom"])
            self.lookat = np.asarray(d["lookat"], np.float64)
            self.up = np.asarray(d["up"], np.float64)
            self.front = np.asarray(d["front"], np.float64)
            self.boundingbox_min = np.asarray(d["boundingbox_min"],
                                              np.float64)
            self.boundingbox_max = np.asarray(d["boundingbox_max"],
                                              np.float64)
        except (KeyError, TypeError, ValueError):
            console.log_warning("ViewParameters read JSON failed.")
            return False
        return True


class ViewTrajectory:
    """cupoch view_trajectory.h:33-90."""

    def __init__(self):
        self.view_status: List[ViewParameters] = []
        self.is_loop = False
        self.interval = INTERVAL_DEFAULT
        self._coeff: Optional[np.ndarray] = None  # [n, 17, 4]

    def change_interval(self, change: int):
        new_interval = self.interval + change * INTERVAL_STEP
        if INTERVAL_MIN <= new_interval <= INTERVAL_MAX:
            self.interval = new_interval

    def num_of_frames(self) -> int:
        n = len(self.view_status)
        if n == 0:
            return 0
        return (self.interval + 1) * n if self.is_loop else \
            (self.interval + 1) * (n - 1) + 1

    def reset(self):
        self.is_loop = False
        self.interval = INTERVAL_DEFAULT
        self.view_status.clear()
        self._coeff = None

    def compute_interpolation_coefficients(self):
        """Natural / periodic cubic spline through the 17-dim view
        vectors (cupoch view_trajectory.cpp:33-95)."""
        n = len(self.view_status)
        if n == 0:
            self._coeff = None
            return
        y = np.stack([s.convert_to_vector17()
                      for s in self.view_status])      # [n, 17]
        if n == 1:
            c = np.zeros((1, 17, 4))
            c[:, :, 0] = y
            self._coeff = c
            return
        A = np.zeros((n, n))
        if self.is_loop:
            A += np.diag([4.0] * n)
            for i in range(n):
                A[i, (i + 1) % n] = 1.0
                A[i, (i - 1) % n] = 1.0
        else:
            A += np.diag([4.0] * n)
            A[0, 0] = A[n - 1, n - 1] = 2.0
            for i in range(n - 1):
                A[i, i + 1] = 1.0
                A[i + 1, i] = 1.0
        b = np.zeros((n, 17))
        if self.is_loop:
            b[0] = 3.0 * (y[1] - y[n - 1])
            b[n - 1] = 3.0 * (y[0] - y[n - 2])
        else:
            b[0] = 3.0 * (y[1] - y[0])
            b[n - 1] = 3.0 * (y[n - 1] - y[n - 2])
        for i in range(1, n - 1):
            b[i] = 3.0 * (y[i + 1] - y[i - 1])
        x = np.linalg.solve(A, b)                      # [n, 17]
        coeff = np.zeros((n, 17, 4))
        for i in range(n):
            i1 = (i + 1) % n
            coeff[i, :, 0] = y[i]
            coeff[i, :, 1] = x[i]
            coeff[i, :, 2] = 3.0 * (y[i1] - y[i]) - 2.0 * x[i] - x[i1]
            coeff[i, :, 3] = 2.0 * (y[i] - y[i1]) + x[i] + x[i1]
        self._coeff = coeff

    def get_interpolated_frame(self, k: int) -> Tuple[bool,
                                                      ViewParameters]:
        """cupoch view_trajectory.cpp:110-126."""
        status = ViewParameters()
        if not self.view_status or k >= self.num_of_frames():
            return False, status
        if self._coeff is None:
            self.compute_interpolation_coefficients()
        seg = k // (self.interval + 1)
        frac = (k - seg * (self.interval + 1)) / float(self.interval + 1)
        s = np.asarray([1.0, frac, frac * frac, frac ** 3])
        status.convert_from_vector17(self._coeff[seg] @ s)
        return True, status

    # -- JSON (schema matches view_trajectory.cpp:142-199) -------------
    def to_json_dict(self) -> dict:
        return {
            "class_name": "ViewTrajectory",
            "version_major": 1,
            "version_minor": 0,
            "is_loop": self.is_loop,
            "interval": self.interval,
            "trajectory": [s.to_json_dict() for s in self.view_status],
        }

    def from_json_dict(self, d: dict) -> bool:
        if d.get("class_name") != "ViewTrajectory" or \
                d.get("version_major", 1) != 1:
            console.log_warning(
                "ViewTrajectory read JSON failed: unsupported format.")
            return False
        self.is_loop = bool(d.get("is_loop", False))
        self.interval = int(d.get("interval", INTERVAL_DEFAULT))
        self.view_status = []
        for obj in d.get("trajectory", []):
            s = ViewParameters()
            if not s.from_json_dict(obj):
                return False
            self.view_status.append(s)
        self._coeff = None
        return True


def read_view_trajectory(path: str) -> ViewTrajectory:
    with open(path) as f:
        d = json.load(f)
    traj = ViewTrajectory()
    traj.from_json_dict(d)
    return traj


def write_view_trajectory(path: str, trajectory: ViewTrajectory) -> bool:
    with open(path, "w") as f:
        json.dump(trajectory.to_json_dict(), f, indent=1)
    return True
