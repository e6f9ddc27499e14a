"""RGB-D SLAM with a pose-graph backend that may be sharded over a mesh
of ranks (the JAX package's `slam/slam.py`).

Frontend: hybrid RGB-D odometry against the previous frame, keyframes
every `keyframe_interval` frames or past a motion threshold, loop
closure by pose proximity to an older keyframe. Backend: the keyframe
pose graph, optimised every `optimize_every_n_keyframes` keyframes by
`global_optimization` (edge-sharded over the mesh when one is given).
State checkpoints through `slam.checkpoint`.

Over a mesh of several ranks, rank 0 alone runs the frontend (tracking,
keyframe and loop-closure decisions) and broadcasts what each frame
changed: the new trajectory pose, keyframe nodes and edges, the live
poses, the counters and whether to optimise. Every rank then applies
it and every rank enters `global_optimization` together, so the ranks
hold equal graphs and take the same branches (a collective that some
rank skipped would hang the others). Ranks other than 0 may pass None
for the frame.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..camera import PinholeCameraIntrinsic
from ..geometry import RGBDImage
from ..odometry import (
    OdometryOption,
    RGBDOdometryJacobianFromHybridTerm,
    compute_rgbd_odometry,
)
from ..utility import console
from . import checkpoint as ckpt
from .pose_graph import (
    GlobalOptimizationOption,
    PoseGraph,
    PoseGraphEdge,
    PoseGraphNode,
    global_optimization,
)


class SlamOption:
    def __init__(self,
                 keyframe_interval: int = 5,
                 keyframe_angle_deg: float = 10.0,
                 keyframe_translation: float = 0.15,
                 loop_closure_interval: int = 0,
                 loop_closure_radius: float = 0.5,
                 loop_closure_min_gap: int = 3,
                 odometry_option: Optional[OdometryOption] = None,
                 optimize_every_n_keyframes: int = 8):
        self.keyframe_interval = int(keyframe_interval)
        self.keyframe_angle_deg = float(keyframe_angle_deg)
        self.keyframe_translation = float(keyframe_translation)
        # every Nth keyframe attempts a loop closure (0 = off)
        self.loop_closure_interval = int(loop_closure_interval)
        # candidate keyframes must sit within this translation radius
        self.loop_closure_radius = float(loop_closure_radius)
        # ... and be at least this many keyframes older
        self.loop_closure_min_gap = int(loop_closure_min_gap)
        self.odometry_option = odometry_option or OdometryOption()
        self.optimize_every_n_keyframes = int(optimize_every_n_keyframes)


class RGBDSlam:
    """Sequential RGB-D SLAM: track -> keyframe -> optimise.

    `mesh`: the backend's mesh (None: one process); `device`: where the
    pose graph is solved without a mesh (None: the card)."""

    def __init__(self, intrinsic: PinholeCameraIntrinsic,
                 option: Optional[SlamOption] = None, mesh=None,
                 device=None):
        self.intrinsic = intrinsic
        self.option = option or SlamOption()
        self.mesh = mesh
        self.device = device
        self.pose_graph = PoseGraph()
        self.trajectory: List[np.ndarray] = []   # every frame's pose
        self.cur_pose = np.eye(4, dtype=np.float32)
        self.prev_frame: Optional[RGBDImage] = None
        self.last_keyframe_pose = np.eye(4, dtype=np.float32)
        self.last_keyframe_frame: Optional[RGBDImage] = None
        # (kf_id, pose at insertion, frame): loop-closure candidates
        self._keyframes: List[tuple] = []
        self.frame_id = 0
        self._since_opt = 0

    @property
    def _leader(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    # -- frontend ------------------------------------------------------
    def process_frame(self, rgbd: Optional[RGBDImage]) -> bool:
        """Track against the previous frame; maybe add a keyframe, and
        optimise when it is due. Returns whether tracking succeeded."""
        n_traj = len(self.trajectory)
        n_nodes = len(self.pose_graph.nodes)
        n_edges = len(self.pose_graph.edges)
        step = None
        if self._leader:
            ok = self._track(rgbd)
            step = {"ok": ok,
                    "trajectory": self.trajectory[n_traj:],
                    "nodes": self.pose_graph.nodes[n_nodes:],
                    "edges": self.pose_graph.edges[n_edges:],
                    "cur_pose": self.cur_pose,
                    "last_keyframe_pose": self.last_keyframe_pose,
                    "frame_id": self.frame_id,
                    "since_opt": self._since_opt}
        if self.mesh is not None and self.mesh.size > 1:
            step = self.mesh.broadcast_object(step)
            if not self._leader:
                self.trajectory.extend(step["trajectory"])
                self.pose_graph.nodes.extend(step["nodes"])
                self.pose_graph.edges.extend(step["edges"])
                self.cur_pose = step["cur_pose"]
                self.last_keyframe_pose = step["last_keyframe_pose"]
                self.frame_id = step["frame_id"]
                self._since_opt = step["since_opt"]
        if self._since_opt >= self.option.optimize_every_n_keyframes:
            self.optimize()
        return step["ok"]

    def _track(self, rgbd: RGBDImage) -> bool:
        if self.prev_frame is None:
            if self.frame_id == 0:  # the very first frame (not a resume)
                self.pose_graph.nodes.append(PoseGraphNode(self.cur_pose))
                self.trajectory.append(self.cur_pose.copy())
                self._keyframes.append((0, self.cur_pose.copy(), rgbd))
            self.prev_frame = rgbd
            self.last_keyframe_frame = rgbd
            self.frame_id += 1
            return True
        ok, motion, info = compute_rgbd_odometry(
            rgbd, self.prev_frame, self.intrinsic,
            jacobian=RGBDOdometryJacobianFromHybridTerm(),
            option=self.option.odometry_option)
        if not ok:
            console.log_warning("[RGBDSlam] odometry failed at frame %d",
                                self.frame_id)
            motion = np.eye(4, dtype=np.float32)
            info = np.eye(6, dtype=np.float32)
        # motion maps the source (current) into the target (previous)
        self.cur_pose = (self.cur_pose @ motion).astype(np.float32)
        self.trajectory.append(self.cur_pose.copy())
        self.prev_frame = rgbd
        if self._is_keyframe():
            self._insert_keyframe(rgbd, info)
        self.frame_id += 1
        return ok

    def _is_keyframe(self) -> bool:
        if self.frame_id % self.option.keyframe_interval == 0:
            return True
        rel = np.linalg.inv(self.last_keyframe_pose) @ self.cur_pose
        t = np.linalg.norm(rel[:3, 3])
        ang = np.degrees(np.arccos(
            np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1)))
        return (t > self.option.keyframe_translation
                or ang > self.option.keyframe_angle_deg)

    def _insert_keyframe(self, rgbd: RGBDImage, info: np.ndarray):
        prev_kf_pose = self.last_keyframe_pose
        kf_id = len(self.pose_graph.nodes)
        self.pose_graph.nodes.append(PoseGraphNode(self.cur_pose))
        rel = (np.linalg.inv(prev_kf_pose) @ self.cur_pose).astype(
            np.float32)
        self.pose_graph.edges.append(PoseGraphEdge(
            kf_id - 1, kf_id, rel, info, uncertain=False))
        self._keyframes.append((kf_id, self.cur_pose.copy(), rgbd))
        if (self.option.loop_closure_interval
                and kf_id % self.option.loop_closure_interval == 0):
            self._try_loop_closure(kf_id, rgbd)
        self.last_keyframe_pose = self.cur_pose.copy()
        self.last_keyframe_frame = rgbd
        self._since_opt += 1

    def _try_loop_closure(self, kf_id: int, rgbd: RGBDImage) -> bool:
        """Place recognition by pose proximity: the nearest keyframe at
        least `loop_closure_min_gap` keyframes older within
        `loop_closure_radius` of the current estimate, registered by
        RGB-D odometry seeded with the current relative estimate; an
        `uncertain` edge joins the two keyframes."""
        gap = self.option.loop_closure_min_gap
        cand = None
        best_d = self.option.loop_closure_radius
        for cid, cpose, cframe in self._keyframes:
            if cid >= kf_id - gap or cframe is None:
                continue
            d = float(np.linalg.norm(cpose[:3, 3] - self.cur_pose[:3, 3]))
            if d <= best_d:
                best_d = d
                cand = (cid, cpose, cframe)
        if cand is None:
            return False
        cid, cpose, cframe = cand
        init = np.linalg.inv(cpose) @ self.cur_pose
        ok, motion, lc_info = compute_rgbd_odometry(
            rgbd, cframe, self.intrinsic, odo_init=init,
            option=self.option.odometry_option)
        if not ok:
            return False
        self.pose_graph.edges.append(PoseGraphEdge(
            cid, kf_id, np.asarray(motion, np.float32), lc_info,
            uncertain=True))
        console.log_debug("[RGBDSlam] loop closure %d -> %d (d=%.3f)",
                          cid, kf_id, best_d)
        return True

    # -- backend -------------------------------------------------------
    def optimize(self):
        """Optimises the pose graph (edge-sharded over the mesh) and
        re-anchors the live pose to the corrected last keyframe. Every
        rank of the mesh must call it."""
        if len(self.pose_graph.edges) == 0:
            return
        before = self.pose_graph.nodes[-1].pose.copy()
        global_optimization(self.pose_graph,
                            GlobalOptimizationOption(max_iteration=10),
                            mesh=self.mesh, device=self.device)
        after = self.pose_graph.nodes[-1].pose
        correction = (after @ np.linalg.inv(before)).astype(np.float32)
        self.cur_pose = (correction @ self.cur_pose).astype(np.float32)
        self.last_keyframe_pose = (
            correction @ self.last_keyframe_pose).astype(np.float32)
        self._keyframes = [
            (cid, self.pose_graph.nodes[cid].pose.copy(), f)
            for (cid, _, f) in self._keyframes]
        self._since_opt = 0

    # -- persistence ---------------------------------------------------
    def state(self) -> dict:
        """The persisted state as numpy arrays (what `save` writes)."""
        g = self.pose_graph
        return {
            "trajectory": np.stack(self.trajectory)
            if self.trajectory else np.zeros((0, 4, 4), np.float32),
            "keyframe_poses": np.stack([n.pose for n in g.nodes])
            if g.nodes else np.zeros((0, 4, 4), np.float32),
            "edge_src": np.asarray([e.source_node_id for e in g.edges],
                                   np.int32),
            "edge_tgt": np.asarray([e.target_node_id for e in g.edges],
                                   np.int32),
            "edge_transform": np.stack([e.transformation for e in g.edges])
            if g.edges else np.zeros((0, 4, 4), np.float32),
            "edge_information": np.stack([e.information for e in g.edges])
            if g.edges else np.zeros((0, 6, 6), np.float32),
            "edge_uncertain": np.asarray([e.uncertain for e in g.edges],
                                         bool),
            "cur_pose": self.cur_pose,
            "last_keyframe_pose": self.last_keyframe_pose,
        }

    def save(self, path: str) -> bool:
        meta = {"frame_id": self.frame_id, "since_opt": self._since_opt}
        return ckpt.save_checkpoint(path, self.state(), meta)

    def restore(self, path: str) -> bool:
        state, meta = ckpt.load_checkpoint(path)
        self.trajectory = list(state["trajectory"])
        self.pose_graph = PoseGraph()
        for pose in state["keyframe_poses"]:
            self.pose_graph.nodes.append(PoseGraphNode(pose))
        for s, t, z, inf, unc in zip(
                state["edge_src"], state["edge_tgt"],
                state["edge_transform"], state["edge_information"],
                state["edge_uncertain"]):
            self.pose_graph.edges.append(
                PoseGraphEdge(int(s), int(t), z, inf, bool(unc)))
        self.cur_pose = state["cur_pose"]
        self.last_keyframe_pose = state["last_keyframe_pose"]
        if meta:
            self.frame_id = int(meta.get("frame_id", 0))
            self._since_opt = int(meta.get("since_opt", 0))
        # the previous frame is not persisted: tracking restarts from the
        # next frame (prev_frame None re-anchors, adds no node)
        self.prev_frame = None
        self.last_keyframe_frame = None
        return True
