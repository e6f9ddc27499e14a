"""A textured room seen by a Kinect-v1-like RGB-D camera, rendered on
the device.

The room (planes and boxes, in metres, y down) and its texture are those
of the port's RGB-D check, copied here so the benchmark owns them. The
camera starts 0.4 m above the room's origin looking down by 15 deg and
moves `step_shift_m` and `step_deg` about `step_axis` a frame; the
trajectory's position sweeps back and forth over `sweep_frames`
frames, so any frame index has a pose, and each seed starts it at
another phase. Depth is z-depth with the axial noise of a Kinect v1
(Nguyen, Izadi and Lovell 2012: sigma = 0.0012 + 0.0019 (z - 0.4)^2 m)
drawn from the seed and the frame index, rounded to the sensor's uint16
millimetres; colour is uint8 RGB at each pixel's centre.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PLANES = ((1, 0.8), (2, 2.8), (0, -1.5), (0, 1.6))
BOXES = (((-1.0, 0.3, 1.8), (-0.5, 0.8, 2.3)),
         ((0.2, 0.2, 2.0), (0.8, 0.8, 2.5)),
         ((-0.25, 0.5, 1.2), (0.25, 0.8, 1.6)))
CAMERA_HEIGHT = 0.4
CAMERA_PITCH_DEG = 15.0


def room_view() -> np.ndarray:
    """The first camera's camera-to-room pose, float64."""
    a = math.radians(CAMERA_PITCH_DEG)
    P = np.eye(4)
    P[1:3, 1:3] = [[math.cos(a), math.sin(a)], [-math.sin(a), math.cos(a)]]
    P[1, 3] = -CAMERA_HEIGHT
    return P


def _rotation(axis, angle) -> np.ndarray:
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


class RGBDRoom:
    def __init__(self, camera: dict, depth_scale: float, traffic: dict,
                 phase: int, device):
        self.t = traffic
        self.depth_scale = float(depth_scale)
        self.phase = int(phase)
        self.device = device
        c = camera
        self.W, self.H = c["width"], c["height"]
        self.fx, self.fy, self.cx, self.cy = c["fx"], c["fy"], c["cx"], \
            c["cy"]
        v, u = torch.meshgrid(
            torch.arange(self.H, dtype=torch.float64, device=device),
            torch.arange(self.W, dtype=torch.float64, device=device),
            indexing="ij")
        self.rays = torch.stack([(u - self.cx) / self.fx,
                                 (v - self.cy) / self.fy,
                                 torch.ones_like(u)], -1)

    def position(self, k: int) -> int:
        """Steps along the trajectory at frame k: a triangle wave."""
        n = self.t["sweep_frames"]
        m = (k + self.phase) % (2 * n)
        return m if m <= n else 2 * n - m

    def pose(self, k: int) -> np.ndarray:
        """Camera-to-world pose of frame k in the first camera's frame
        (the world of the room's first view), float64."""
        m = self.position(k)
        P = np.eye(4)
        P[:3, :3] = _rotation(self.t["step_axis"],
                              math.radians(self.t["step_deg"]) * m)
        P[:3, 3] = np.asarray(self.t["step_shift_m"]) * m
        return P

    def render(self, k: int, gen: torch.Generator):
        """(RGB uint8 [H, W, 3], depth uint16 mm [H, W]) of frame k on
        the device; depth 0 where a ray meets nothing."""
        pose = torch.as_tensor(room_view() @ self.pose(k),
                               device=self.device)
        R, o = pose[:3, :3], pose[:3, 3]
        d = self.rays @ R.T
        best = torch.full(d.shape[:2], math.inf, dtype=torch.float64,
                          device=self.device)
        for axis, value in PLANES:
            da = d[..., axis]
            t = (value - o[axis]) / torch.where(da == 0, 1e-300, da)
            best = torch.where((t > 0) & (t < best), t, best)
        for lo, hi in BOXES:
            lo = torch.as_tensor(lo, dtype=torch.float64, device=self.device)
            hi = torch.as_tensor(hi, dtype=torch.float64, device=self.device)
            inv = 1.0 / d
            t1, t2 = (lo - o) * inv, (hi - o) * inv
            t_in = torch.minimum(t1, t2).nan_to_num(-math.inf).amax(-1)
            t_out = torch.maximum(t1, t2).nan_to_num(math.inf).amin(-1)
            hit = (t_out >= t_in) & (t_in > 0) & (t_in < best)
            best = torch.where(hit, t_in, best)
        found = torch.isfinite(best)
        z = torch.where(found, best, 0.0)
        p = o + d * z[..., None]
        x, y, w = p[..., 0], p[..., 1], p[..., 2]
        rgb = torch.stack([
            0.5 + 0.2 * torch.sin(6.0 * x + 2.0 * w) * torch.cos(5.0 * y)
            + 0.15 * torch.sin(3.0 * w - 4.0 * x),
            0.5 + 0.2 * torch.cos(5.5 * y - 3.0 * x) * torch.sin(4.5 * w)
            + 0.1 * torch.sin(7.0 * x),
            0.5 + 0.25 * torch.sin(4.0 * x + 6.0 * y + 3.0 * w)], -1)
        rgb = torch.round(rgb.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        rgb[~found] = 0
        sigma = 0.0012 + 0.0019 * (z - 0.4) ** 2
        noisy = z + sigma * torch.randn(z.shape, generator=gen,
                                        dtype=torch.float64,
                                        device=self.device)
        mm = torch.round(noisy * self.depth_scale).clamp(0, 65535)
        mm = torch.where(found, mm, 0.0).to(torch.int32).to(torch.uint16)
        return rgb, mm
