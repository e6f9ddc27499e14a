"""Scan registration cells: `registration_icp` with the point-to-plane
estimator, one call a frame. Each frame registers a fresh dense fragment
of the room (`scenes/room.py`) onto another, independent sample, the
source moved by a fresh motion; the init is the identity. The sizes
of the motions follow low-discrepancy sequences from an offset the
seed draws, so every window holds the same spread of motions.
"""
from __future__ import annotations

import sys
import traceback

import numpy as np
import torch

import cupoch_tpu_torch as ctt

from ..lib import rng
from ..lib.precision import working
from ..lib.work import correspondence_work
from ..reference import icp as ref_icp
from ..scenes import room


def _launches():
    k = ctt.knn
    return {"slot_kernel": k.poolgrid_slot.launches,
            "fused_kernel": sum(k.rungrid_fused.launches.values()),
            "gmm_kernel": k.rungrid_gmm.launches,
            "nn_kernel": k.rollgrid_nn.launches}


def _branch(delta: dict) -> str:
    if delta["slot_kernel"]:
        return "pooled grid (kernel 1)"
    if delta["fused_kernel"]:
        return "run grid (kernel 2)"
    if delta["nn_kernel"]:
        return "roll or cell grid (kernel 4)"
    return "brute force or hash grid (no kernel)"


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.t, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        reg = ctt.registration
        self.estimation = reg.TransformationEstimationPointToPlane()
        self.criteria = reg.ICPConvergenceCriteria(**config["criteria"])
        self.threshold = float(traffic["threshold_m"])
        self.offset = tuple(rng.host_rng(seed, "sizes").uniform(0, 1, 2))
        self.records = []
        self.pending = None
        self.last = None            # the last window frame's record

    # -- inputs --------------------------------------------------------
    def _room_pair(self, stream: str, k: int):
        t = self.t
        g = rng.generator(self.dev, self.seed, "room", stream, k)
        tgt, tn = room.fragment(g, t["points"], t["noise_m"],
                                t["outlier_share"])
        src, _ = room.fragment(g, t["points"], t["noise_m"],
                               t["outlier_share"])
        M = room.random_motion(g, t["max_turn_deg"], t["max_shift_m"],
                               room.motion_sizes(self.offset, k))
        src = src @ M[:3, :3].T + M[:3, 3]
        return (src.to(torch.float32), tgt.to(torch.float32),
                tn.to(torch.float32))

    def _cloud(self, pts, normals=None):
        pc = ctt.geometry.PointCloud(pts, device=self.dev)
        if normals is not None:
            pc.normals = normals
        return pc

    # -- frames --------------------------------------------------------
    def prepare(self, stream: str, k: int):
        """Makes the inputs of the next frame on the device."""
        src, tgt, tn = self._room_pair(stream, k)
        self.pending = (stream, k, self._cloud(src), self._cloud(tgt, tn),
                        np.eye(4, dtype=np.float32))

    def run(self) -> bool:
        """The frame's public calls; True when a finite pose came back."""
        stream, k, src, tgt, init = self.pending
        self.last = None
        before = _launches()
        rec = {"stream": stream, "k": k, "init": init, "ok": False}
        try:
            res = ctt.registration.registration_icp(
                src, tgt, self.threshold, init, self.estimation,
                self.criteria)
            T = np.asarray(res.transformation, np.float32)
            rec.update(T=T, fitness=res.fitness, rmse=res.inlier_rmse,
                       iterations=res.iterations,
                       ok=bool(np.isfinite(T).all()))
        except (RuntimeError, ValueError) as e:
            print(f"frame {k} failed: {e!r}", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)
        after = _launches()
        rec["launches"] = {n: after[n] - before[n] for n in after}
        if stream == "window":
            self.records.append(rec)
            self.last = rec
        return rec["ok"]

    def warm(self, frames: int):
        for i in range(frames):
            self.prepare("warm", i)
            self.run()

    def release(self):
        self.pending = None
        self.last = None

    # -- what the run reports beside the metrics ----------------------
    def notes(self) -> list:
        if not self.records:
            return []
        total = {n: sum(r["launches"][n] for r in self.records)
                 for n in self.records[0]["launches"]}
        it = [r.get("iterations", 0) for r in self.records]
        return [f"branch: {_branch(total)}; kernel launches in the window "
                f"{total}; ICP iterations a frame {min(it)}-{max(it)}"]

    # -- the reference ---------------------------------------------------
    def _inputs_of(self, rec):
        """(source, target, target normals) of a recorded frame, made
        again from the seed."""
        return self._room_pair(rec["stream"], rec["k"])

    def sample(self) -> list:
        return rng.checked_frames(self.records, self.seed,
                                  self.t["checked_frames"])

    def reference(self, rec, precision="float32"):
        src, tgt, tn = self._inputs_of(rec)
        c = self.cfg["criteria"]
        with working(precision) as dtype:
            T, fit, rmse, it = ref_icp.point_to_plane(
                src, tgt, tn, self.threshold, rec["init"],
                c["relative_fitness"], c["relative_rmse"],
                c["max_iteration"], dtype=dtype)
        return {"T": T.numpy(), "fitness": fit, "rmse": rmse,
                "iterations": it}

    @staticmethod
    def gaps(got: dict, ref: dict) -> dict:
        if not got.get("ok"):
            return {k: float("inf") for k in
                    ("rot_gap", "shift_gap", "fitness_gap", "rmse_gap")}
        T, R = np.asarray(got["T"], np.float64), np.asarray(ref["T"],
                                                             np.float64)
        return {
            "rot_gap": float(np.abs(T[:3, :3] - R[:3, :3]).max()),
            "shift_gap": float(np.abs(T[:3, 3] - R[:3, 3]).max()),
            "fitness_gap": abs(got["fitness"] - ref["fitness"]),
            "rmse_gap": abs(got["rmse"] - ref["rmse"])
            / max(ref["rmse"], 1e-12)}

    def check(self, limits: dict) -> list:
        """[(name, value, limit)]: the widest gap of each number over
        the checked frames, against the limits of the configuration."""
        worst = {}
        for rec in self.sample():
            g = self.gaps(rec, self.reference(rec))
            for k, v in g.items():
                worst[k] = max(worst.get(k, 0.0), v)
        if not worst:
            worst = {k: float("inf") for k in limits}
        return [(k, worst[k], limits[k]) for k in limits]

    def control(self, precision) -> dict:
        """The widest gaps of the reference in `precision` put in the
        program's place, on the frames `check` would compare."""
        worst = {}
        for rec in self.sample():
            low = self.reference(rec, precision)
            low["ok"] = bool(np.isfinite(low["T"]).all())
            g = self.gaps(low, self.reference(rec))
            for k, v in g.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    # -- work counts for the kernel roofline ---------------------------
    def launch_work(self, kernel: str) -> list:
        """[(launches, work)] of each window frame that launched
        `kernel`: its launches and the work of one of them
        (`lib.work.correspondence_work`), counted from that frame's own
        inputs with the source at the frame's returned pose."""
        out = []
        for rec in self.records:
            n = rec["launches"].get(kernel, 0)
            if not n or not rec["ok"]:
                continue
            src, tgt, _ = self._inputs_of(rec)
            T = torch.as_tensor(rec["T"], device=src.device)
            out.append((n, correspondence_work(
                src @ T[:3, :3].T + T[:3, 3], tgt, self.threshold)))
        return out
