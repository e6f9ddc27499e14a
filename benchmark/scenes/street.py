"""Spinning 64-beam LiDAR scans of a street, made on the device.

The street runs along x; the ground is z = 0. Buildings, parked cars
and poles are axis-aligned boxes, laid out from the seed: a row of
buildings on each side of a street `street_width_m` wide, either one
unbroken façade (`block_m` null) or blocks `block_m` long with cross
streets `cross_street_m` wide between them, whose walls face along the
street. The sensor (`sensor_height_m` above the ground) casts
`beams` rays spaced evenly from the first to the second of
`elevation_deg`, at `azimuth_steps` steps a turn; each ray returns its
first hit within `max_range_m`, its range perturbed by Gaussian noise
of `range_noise_m`. A scan is the returns in the sensor's frame, x
forward, z up (the HDL-64E's layout on KITTI's car).
"""
from __future__ import annotations

import math

import numpy as np
import torch

CAR = (4.4, 1.8, 1.5)
POLE = (0.25, 0.25, 7.0)
DEPTH = 15.0                   # of a building, across the street


def layout(rng: np.random.Generator, p: dict) -> np.ndarray:
    """[B, 6] boxes (lo xyz, hi xyz) of one street, drawn from `rng`."""
    half = rng.uniform(*p["street_width_m"]) / 2
    x0, x1 = -p["length_m"] / 2, p["length_m"] / 2
    boxes = []
    for side in (-1.0, 1.0):
        y_in, y_out = side * half, side * (half + DEPTH)
        x = x0
        while x < x1:
            if p["block_m"] is None:
                end = x1
            else:
                end = min(x + rng.uniform(*p["block_m"]), x1)
            h = rng.uniform(*p["height_m"])
            boxes.append((x, min(y_in, y_out), 0.0, end, max(y_in, y_out),
                          h))
            x = end + (rng.uniform(*p["cross_street_m"])
                       if p["block_m"] is not None else 0.0)
        # parked cars along the kerb, poles along the pavement
        x = x0 + rng.uniform(0, 8)
        while x < x1:
            y = side * (half - 3.0)
            boxes.append((x, y - CAR[1] / 2, 0.0, x + CAR[0], y + CAR[1] / 2,
                          CAR[2]))
            x += CAR[0] + rng.uniform(*p["car_gap_m"])
        for x in np.arange(x0 + rng.uniform(0, p["pole_every_m"]), x1,
                           p["pole_every_m"]):
            y = side * (half - 1.0)
            boxes.append((x, y - POLE[1] / 2, 0.0, x + POLE[0],
                          y + POLE[1] / 2, POLE[2]))
    return np.asarray(boxes, np.float64)


def rays(p: dict, device) -> torch.Tensor:
    """[R, 3] unit directions in the sensor's frame, float64."""
    el = torch.deg2rad(torch.linspace(*p["elevation_deg"], p["beams"],
                                      dtype=torch.float64, device=device))
    az = torch.arange(p["azimuth_steps"], dtype=torch.float64,
                      device=device) * (2 * math.pi / p["azimuth_steps"])
    el, az = torch.meshgrid(el, az, indexing="ij")
    return torch.stack([torch.cos(el) * torch.cos(az),
                        torch.cos(el) * torch.sin(az), torch.sin(el)],
                       -1).reshape(-1, 3)


def pose(x: float, y: float, yaw_deg: float, height: float):
    """[4, 4] float64 pose of the sensor in the street's frame."""
    c, s = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
    return torch.tensor([[c, -s, 0.0, x], [s, c, 0.0, y],
                         [0.0, 0.0, 1.0, height], [0.0, 0.0, 0.0, 1.0]],
                        dtype=torch.float64)


def scan(boxes: np.ndarray, T, p: dict, g: torch.Generator) -> torch.Tensor:
    """[N, 3] float32 returns in the sensor's frame for a sensor at pose
    `T` (street frame); range noise drawn from `g`, on g's device."""
    dev = g.device
    d = rays(p, dev)
    T = T.to(dev)
    o = T[:3, 3]
    dw = d @ T[:3, :3].T
    big = torch.finfo(torch.float64).max
    t = torch.full((d.shape[0],), big, dtype=torch.float64, device=dev)
    down = dw[:, 2] < 0
    t = torch.where(down, -o[2] / torch.where(down, dw[:, 2], -1.0), t)
    b = torch.as_tensor(boxes, dtype=torch.float64, device=dev)
    safe = torch.where(dw.abs() < 1e-12, torch.full_like(dw, 1e-12), dw)
    inv = 1.0 / safe
    for i in range(0, b.shape[0], 64):
        lo, hi = b[i:i + 64, :3], b[i:i + 64, 3:]
        t1 = (lo[None] - o) * inv[:, None]
        t2 = (hi[None] - o) * inv[:, None]
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        hit = (near <= far) & (near > 0)
        t = torch.minimum(t, torch.where(hit, near, big).amin(-1))
    keep = t <= p["max_range_m"]
    r = t[keep] + p["range_noise_m"] * torch.randn(
        int(keep.sum()), generator=g, dtype=torch.float64, device=dev)
    return (d[keep] * r[:, None]).to(torch.float32)


def motion(rng: np.random.Generator, p: dict):
    """(forward m, sideways m, yaw deg) of one frame's step."""
    return (rng.uniform(*p["step_m"]), rng.uniform(-0.05, 0.05),
            rng.uniform(-p["max_turn_deg"], p["max_turn_deg"]))
