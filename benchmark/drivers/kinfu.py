"""KinectFusion cells: one `KinfuPipeline.process_frame` a frame on one
continuous stream of the rendered room (`scenes/rgbd_room.py`), warm
frames first (the first frame only integrates), then the window's
frames, all into one pipeline at the configuration's KinfuOption. A
frame that raises or reports a lost track counts as failed.

`check` replays every frame the program completed, from frame 0,
through the plain reference (`reference/kinfu.py`) and compares each
frame's pose and, at the end, the volume. The replay fits a run's time,
so the traffic's `checked_frames`, which the harness asks of every
traffic, is not read here.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

import cupoch_tpu_torch as ctt

from ..lib import rng
from ..lib.precision import working
from ..reference import kinfu as ref_kinfu
from ..scenes.rgbd_room import RGBDRoom


def option(cfg: dict):
    """The configuration's KinfuOption."""
    o = dict(cfg["kinfu"])
    o["tsdf_color_type"] = ctt.integration.TSDFVolumeColorType[
        o["tsdf_color_type"]]
    o["tf_type"] = ctt.registration.TransformationEstimationType[
        o["tf_type"]]
    return ctt.kinfu.KinfuOption(**o)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.t, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        # KinFu filters the colour pyramid channel by channel, which the
        # image filter warns of on every level of every frame
        console = ctt.utility.console
        console.set_verbosity_level(console.VerbosityLevel.Error)
        cam = config["camera"]
        phase = int(rng.host_rng(seed, "phase").integers(
            0, 2 * traffic["sweep_frames"]))
        self.scene = RGBDRoom(cam, config["depth_scale"], traffic, phase,
                              self.dev)
        self.intrinsic = ctt.camera.PinholeCameraIntrinsic(
            cam["width"], cam["height"], cam["fx"], cam["fy"], cam["cx"],
            cam["cy"])
        self.pipe = ctt.kinfu.KinfuPipeline(self.intrinsic, option(config),
                                            device=self.dev)
        self.next_frame = 0
        self.records = []           # every frame, the warm ones too
        self.pending = None
        self.last = None
        self.volume = None          # the program's (tsdf, weight) at the end
        self._replay = None         # the float32 reference's readings

    # -- inputs --------------------------------------------------------
    def images(self, k: int):
        """(RGB uint8, depth uint16 mm) of frame k, made on the device."""
        return self.scene.render(k, rng.generator(self.dev, self.seed,
                                                  "kinfu", k))

    # -- frames --------------------------------------------------------
    def prepare(self, stream: str, i: int):
        k = self.next_frame
        self.next_frame += 1
        rgb, mm = self.images(k)
        Image = ctt.geometry.Image
        rgbd = ctt.geometry.RGBDImage.create_from_color_and_depth(
            Image(rgb, device=self.dev), Image(mm, device=self.dev),
            self.cfg["depth_scale"], self.cfg["depth_trunc"],
            convert_rgb_to_intensity=False)
        self.pending = (stream, k, rgbd)

    def run(self) -> bool:
        stream, k, rgbd = self.pending
        self.last = None
        rec = {"stream": stream, "k": k, "ok": False}
        try:
            ok = self.pipe.process_frame(rgbd)
            T = np.asarray(self.pipe.cur_pose, np.float64).copy()
            rec.update(ok=bool(ok) and bool(np.isfinite(T).all()), T=T)
        except (RuntimeError, ValueError) as e:
            print(f"frame {k} failed: {e!r}", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)
        self.records.append(rec)
        if stream == "window":
            self.last = rec
        return rec["ok"]

    def warm(self, frames: int):
        for i in range(frames):
            self.prepare("warm", i)
            self.run()

    def release(self):
        """Keeps the program's volume on the host and frees the card."""
        if self.pipe is not None:
            v = self.pipe.volume
            self.volume = (v.tsdf.cpu(), v.weight.cpu())
        self.pipe = self.pending = self.last = None

    def notes(self) -> list:
        window = [r for r in self.records if r["stream"] == "window"]
        fails = sum(not r["ok"] for r in window)
        cutoff = self.cfg["kinfu"]["depth_cutoff"]
        scale = self.cfg["depth_scale"]
        share = min((float(((mm > 0) & (mm <= cutoff * scale)).float()
                            .mean()) for mm in
                     (self.images(r["k"])[1].to(torch.int32)
                      for r in self.records)),
                    default=float("nan"))
        lines = [f"kinfu: {len(window)} window frames, {fails} failed, "
                 f"{len(self.records)} frames in all; trajectory phase "
                 f"{self.scene.phase}; least share of a frame's pixels with "
                 f"a depth in (0, {cutoff}] m: {share:.4f}"]
        levels = {}
        for s in ctt.utility.trace.spans():
            if s.name == "kinfu.track.level":
                a = s.attrs
                levels.setdefault(a["level"], set()).add(
                    (a.get("branch"), a.get("points", 0) > 0))
        if levels:
            lines.append("kinfu: ICP branch by level: " + "; ".join(
                f"{lv} {sorted(str(b) for b, _ in v)}"
                for lv, v in sorted(levels.items())))
        return lines

    # -- the reference ---------------------------------------------------
    def _replayed(self) -> list:
        """The completed frames the reference replays, from frame 0."""
        return [r for r in self.records if r["ok"]]

    def _reference(self, recs, precision):
        """(poses, tsdf, weight) of the reference over the frames of
        `recs`, in `precision`; a pose is None where it lost track."""
        with working(precision) as dtype:
            ref = ref_kinfu.KinFu(self.cfg, self.dev, dtype)
            poses = []
            for rec in recs:
                ok = ref.process(self.images(rec["k"])[1])
                poses.append(ref.pose.astype(np.float64) if ok else None)
        return poses, ref.volume.tsdf, ref.volume.weight

    @staticmethod
    def pose_gaps(T, R) -> dict:
        if R is None or T is None or not (np.isfinite(T).all()
                                          and np.isfinite(R).all()):
            return {"rot_gap": float("inf"), "shift_gap": float("inf")}
        return {"rot_gap": float(np.abs(T[:3, :3] - R[:3, :3]).max()),
                "shift_gap": float(np.abs(T[:3, 3] - R[:3, 3]).max())}

    def _gaps(self, poses, tsdf, weight) -> dict:
        """Widest pose gaps and the volume's share of differing voxels
        against the float32 reference."""
        ref_poses, ref_tsdf, ref_weight = self._replay
        worst = {"rot_gap": 0.0, "shift_gap": 0.0}
        for T, R in zip(poses, ref_poses):
            for k, v in self.pose_gaps(T, R).items():
                worst[k] = max(worst[k], v)
        worst["volume_gap"] = ref_kinfu.volume_gap(
            tsdf.to(ref_tsdf.device), weight.to(ref_tsdf.device), ref_tsdf,
            ref_weight, self.t["volume_tsdf_tol"])
        return worst

    def check(self, limits: dict) -> list:
        recs = self._replayed()
        if not recs or self.volume is None:
            return [(k, float("inf"), limits[k]) for k in limits]
        t0 = time.perf_counter()
        self._replay = self._reference(recs, "float32")
        print(f"kinfu: the reference replayed {len(recs)} frames in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        worst = self._gaps([r["T"] for r in recs], *self.volume)
        return [(k, worst[k], limits[k]) for k in limits]

    def control(self, precision) -> dict:
        """The reference in `precision` in the program's place, on the
        frames `check` compared (after `check`)."""
        recs = self._replayed()
        return self._gaps(*self._reference(recs, precision))
