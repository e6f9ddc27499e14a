"""RGB-D odometry cells on a rendered room sequence: one
`compute_rgbd_odometry` call a frame (hybrid Jacobian, the config's
OdometryOption) from frame i - 1 to frame i, from the identity. Each
frame renders one new image; the last frame's target is this frame's
source. A pair the call reports as unsolved counts as failed.
"""
from __future__ import annotations

import sys
import traceback

import numpy as np
import torch

import cupoch_tpu_torch as ctt

from ..lib import rng
from ..lib.precision import working
from ..reference import odometry as ref_odometry
from ..scenes.rgbd_room import RGBDRoom


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.t, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        cam = config["camera"]
        phase = int(rng.host_rng(seed, "phase").integers(
            0, 2 * traffic["sweep_frames"]))
        self.scene = RGBDRoom(cam, config["depth_scale"], traffic, phase,
                              self.dev)
        self.intrinsic = ctt.camera.PinholeCameraIntrinsic(
            cam["width"], cam["height"], cam["fx"], cam["fy"], cam["cx"],
            cam["cy"])
        self.K = np.asarray(self.intrinsic.intrinsic_matrix, np.float32)
        o = dict(config["odometry"])
        o.pop("jacobian")
        self.option = ctt.odometry.OdometryOption(**o)
        self.jacobian = ctt.odometry.RGBDOdometryJacobianFromHybridTerm()
        self.next_frame = 0
        self.prev = None
        self.records = []
        self.pending = None
        self.last = None

    # -- inputs --------------------------------------------------------
    def images(self, k: int):
        """(RGB uint8, depth uint16 mm) of frame k, made on the device."""
        return self.scene.render(k, rng.generator(self.dev, self.seed,
                                                  "rgbd", k))

    def _rgbd(self, rgb, mm):
        Image = ctt.geometry.Image
        RGBD = ctt.geometry.RGBDImage
        return RGBD.create_from_color_and_depth(
            Image(rgb, device=self.dev), Image(mm, device=self.dev),
            self.cfg["depth_scale"], self.cfg["depth_trunc"])

    # -- frames --------------------------------------------------------
    def prepare(self, stream: str, i: int):
        k = self.next_frame
        self.next_frame += 1
        if self.prev is None:
            self.prev = self._rgbd(*self.images(k))
            k = self.next_frame
            self.next_frame += 1
        self.pending = (stream, k, self._rgbd(*self.images(k)))

    def run(self) -> bool:
        stream, k, frame = self.pending
        self.last = None
        rec = {"stream": stream, "k": k, "ok": False}
        try:
            ok, T, _ = ctt.odometry.compute_rgbd_odometry(
                self.prev, frame, self.intrinsic, np.eye(4), self.jacobian,
                self.option)
            self.prev = frame
            rec.update(ok=bool(ok) and bool(np.isfinite(T).all()),
                       T=np.asarray(T, np.float64), success=bool(ok))
        except (RuntimeError, ValueError) as e:
            print(f"frame {k} failed: {e!r}", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)
        if stream == "window":
            self.records.append(rec)
            self.last = rec
        return rec["ok"]

    def warm(self, frames: int):
        for i in range(frames):
            self.prepare("warm", i)
            self.run()

    def release(self):
        self.pending = self.prev = None
        self.last = None

    def notes(self) -> list:
        fails = sum(not r["ok"] for r in self.records)
        return [f"odometry: {len(self.records)} frames, {fails} failed; "
                f"trajectory phase {self.scene.phase}"]

    # -- the reference ---------------------------------------------------
    def sample(self) -> list:
        return rng.checked_frames(self.records, self.seed,
                                  self.t["checked_frames"])

    @staticmethod
    def pose_gaps(T, R) -> dict:
        T, R = np.asarray(T, np.float64), np.asarray(R, np.float64)
        if not (np.isfinite(T).all() and np.isfinite(R).all()):
            return {"rot_gap": float("inf"), "shift_gap": float("inf")}
        return {"rot_gap": float(np.abs(T[:3, :3] - R[:3, :3]).max()),
                "shift_gap": float(np.abs(T[:3, 3] - R[:3, 3]).max())}

    def _odometry(self, src, tgt, precision):
        with working(precision) as dtype:
            return ref_odometry.odometry(
                *src, *tgt, self.K, self.cfg["odometry"],
                self.cfg["depth_scale"], self.cfg["depth_trunc"], dtype)

    def _odometry_gaps(self, recs, precision=None):
        """Gaps of the program's pairs, or of the reference in
        `precision` in the program's place, against the reference."""
        worst = {"rot_gap": 0.0, "shift_gap": 0.0}
        for rec in recs:
            src = self.images(rec["k"] - 1)
            tgt = self.images(rec["k"])
            ok_r, T_r = self._odometry(src, tgt, "float32")
            if precision is None:
                ok_p, T_p = rec.get("success", False), rec.get("T")
            else:
                ok_p, T_p = self._odometry(src, tgt, precision)
            # a pair solved on one side only is as far as it can be
            if ok_p and ok_r:
                g = self.pose_gaps(T_p, T_r)
            elif ok_p == ok_r:
                g = {}
            else:
                g = {"rot_gap": float("inf"), "shift_gap": float("inf")}
            for k, v in g.items():
                worst[k] = max(worst[k], v)
        return worst

    def check(self, limits: dict) -> list:
        recs = self.sample()
        worst = self._odometry_gaps(recs) if recs else \
            {k: float("inf") for k in limits}
        return [(k, worst[k], limits[k]) for k in limits]

    def control(self, precision) -> dict:
        """The reference in `precision` in the program's place, on the
        frames `check` would compare."""
        return self._odometry_gaps(self.sample(), precision)
