"""Pose-graph optimisation, replicated or with its edges sharded over a
mesh of ranks (the JAX package's `slam/pose_graph.py`).

SE(3) keyframe nodes, relative-pose edges with 6x6 information
matrices, Gauss-Newton with node 0 held fixed. With a mesh, each rank
computes the normal-equation blocks of its share of the edges (their
Jacobians are the work), the ranks gather all the edges' blocks (4 x
36 + 12 + 1 numbers an edge), rank 0 assembles H and b and solves, and
every rank applies the step rank 0 broadcasts, so the node poses stay
replicated bit for bit (a sum by the card's atomic adds is not
repeatable to the last bit, so ranks that each assembled and solved
would part). The JAX package psums the dense [6N, 6N] H and every
device solves: at 2500 nodes that is 1.8 GB an iteration in float64
against 6 MB of blocks, and D solves where one will do. The API
follows Open3D's `PoseGraph` / `global_optimization`.

The iterations run in float64 on the float32 graph (the JAX package's
run in float32): the residuals, their Jacobians, H, b and the solve.
A sphere2500-sized system is ill-conditioned enough that a float32
solve moves the poses by up to 2e-2 for last-bit differences in H
(the summation order of a psum, on an H100); in float64 the answer
does not depend on how the edges are split over the ranks. The
Jacobians of the residual log(Z^-1 inv(exp(xi_i) T_i) exp(xi_j) T_j)
at xi = 0 are taken in closed form (the inverse right Jacobian of
SE(3) and an adjoint), where the JAX package takes `jacfwd` through
its float32 exp and log: against central differences in float64 that
errs by up to 5e-3 on tests/test_slam.py's loop graph and 1.9e-2 on
sphere2500's first iteration, the closed form by 1.5e-5 and 7.8e-5
(host runs).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..parallel.collectives import Mesh
from ..utility import console
from ..utility.device import resolve_device
from ..utility.transforms import exp_se3, hat, inverse_transform, log_se3

EDGE_AXIS = "edges"
#: damping added to the reduced system's diagonal
DAMPING = 1e-6


class PoseGraphNode:
    def __init__(self, pose=None):
        self.pose = (np.eye(4, dtype=np.float32) if pose is None
                     else np.asarray(pose, np.float32))


class PoseGraphEdge:
    def __init__(self, source_node_id: int, target_node_id: int,
                 transformation=None, information=None,
                 uncertain: bool = False, confidence: float = 1.0):
        self.source_node_id = int(source_node_id)
        self.target_node_id = int(target_node_id)
        self.transformation = (np.eye(4, dtype=np.float32)
                               if transformation is None
                               else np.asarray(transformation, np.float32))
        self.information = (np.eye(6, dtype=np.float32)
                            if information is None
                            else np.asarray(information, np.float32))
        self.uncertain = bool(uncertain)
        self.confidence = float(confidence)


class PoseGraph:
    def __init__(self):
        self.nodes: List[PoseGraphNode] = []
        self.edges: List[PoseGraphEdge] = []


class GlobalOptimizationOption:
    def __init__(self, max_correspondence_distance: float = 0.03,
                 edge_prune_threshold: float = 0.25,
                 preference_loop_closure: float = 1.0,
                 reference_node: int = 0,
                 max_iteration: int = 20):
        self.max_correspondence_distance = float(max_correspondence_distance)
        self.edge_prune_threshold = float(edge_prune_threshold)
        self.preference_loop_closure = float(preference_loop_closure)
        self.reference_node = int(reference_node)
        self.max_iteration = int(max_iteration)


def _jr_inv(r):
    """The inverse right Jacobian of SE(3) at twists r [E, 6] = [w, v]
    (float64): [[Jr^-1, 0], [-Jr^-1 Q_r Jr^-1, Jr^-1]] with SO(3)'s
    Jr^-1(w) and Barfoot's Q_r(v, w) = Q_l(-v, -w), each coefficient in
    its Taylor form below |w| = 0.01."""
    w, v = r[:, :3], r[:, 3:]
    th2 = (w * w).sum(-1)
    small = th2 < 1e-4
    t = torch.sqrt(torch.where(small, 1.0, th2))
    t2 = t * t
    sn, cs = torch.sin(t), torch.cos(t)

    def coef(series, exact):
        return torch.where(small, series, exact)[:, None, None]

    a = coef(1 / 12 + th2 / 720, 1 / t2 - (1 + cs) / (2 * t * sn))
    c1 = coef(1 / 6 - th2 / 120, (t - sn) / (t2 * t))
    c2 = coef(1 / 24 - th2 / 720, (t2 + 2 * cs - 2) / (2 * t2 * t2))
    c3 = coef(1 / 120 - th2 / 2520,
              (2 * t - 3 * sn + t * cs) / (2 * t2 * t2 * t))
    W, P = hat(-w), hat(-v)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    J = eye - 0.5 * W + a * (W @ W)
    WP, PW = W @ P, P @ W
    WPW = WP @ W
    Q = 0.5 * P + c1 * (WP + PW + WPW) + c2 * (W @ WP + PW @ W - 3 * WPW) \
        + c3 * (WPW @ W + W @ WPW)
    out = r.new_zeros((r.shape[0], 6, 6))
    out[:, :3, :3] = J
    out[:, 3:, 3:] = J
    out[:, 3:, :3] = -(J @ Q @ J)
    return out


def edge_jacobians(poses, src_idx, tgt_idx, z_inv):
    """(r [E, 6], J_i [E, 6, 6], J_j [E, 6, 6]): the residuals
    r = log(Z^-1 T_i^-1 T_j) and their derivatives with respect to left
    twists of the source and target nodes, in the dtype of `poses`. A
    left twist of T_j moves E = Z^-1 T_i^-1 T_j to E exp(Ad(T_j^-1) xi),
    and one of T_i to E exp(-Ad(T_j^-1) xi), so J_j = Jr^-1(r)
    Ad(T_j^-1) = -J_i, taken in float64 (its coefficients cancel
    digits near |w| = 0.01)."""
    Ti, Tj = poses[src_idx], poses[tgt_idx]
    r = log_se3(z_inv.to(poses.dtype) @ inverse_transform(Ti) @ Tj)
    Tinv = inverse_transform(Tj).double()
    R, t = Tinv[:, :3, :3], Tinv[:, :3, 3]
    ad = R.new_zeros((R.shape[0], 6, 6))
    ad[:, :3, :3] = R
    ad[:, 3:, 3:] = R
    ad[:, 3:, :3] = hat(t) @ R
    Jj = (_jr_inv(r.double()) @ ad).to(poses.dtype)
    return r, -Jj, Jj


def scatter_blocks(n: int, rows, cols, blocks) -> torch.Tensor:
    """[6n, 6n] sum of the 6x6 `blocks` at block (rows, cols)."""
    acc = blocks.new_zeros((n * n, 36))
    acc.index_add_(0, rows * n + cols, blocks.reshape(-1, 36))
    return acc.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)


def edge_blocks(poses, src_idx, tgt_idx, z_inv, info, weight):
    """Each edge's share of the normal system: (block rows [4E], block
    cols [4E], H blocks [4E, 6, 6], b rows [2E], b blocks [2E, 6], the
    weighted squared error [E]), in the dtype of `poses`."""
    r, Ji, Jj = edge_jacobians(poses, src_idx, tgt_idx, z_inv)
    w = (weight[:, None, None] * info).to(poses.dtype)
    JiT_w = torch.einsum("eki,ekl->eil", Ji, w)
    JjT_w = torch.einsum("eki,ekl->eil", Jj, w)
    H_ii = torch.einsum("eik,ekj->eij", JiT_w, Ji)
    H_ij = torch.einsum("eik,ekj->eij", JiT_w, Jj)
    H_jj = torch.einsum("eik,ekj->eij", JjT_w, Jj)
    b_i = torch.einsum("eik,ek->ei", JiT_w, r)
    b_j = torch.einsum("eik,ek->ei", JjT_w, r)
    return (torch.cat([src_idx, src_idx, tgt_idx, tgt_idx]),
            torch.cat([src_idx, tgt_idx, src_idx, tgt_idx]),
            torch.cat([H_ii, H_ij, H_ij.transpose(-1, -2), H_jj]),
            torch.cat([src_idx, tgt_idx]), torch.cat([b_i, b_j]),
            torch.einsum("ek,ekl,el->e", r, w, r))


def assemble(n_nodes: int, rows, cols, blocks, b_rows, b_blocks, errs):
    """The [6N, 6N] H, [6N] b and the squared error from edge blocks."""
    b = b_blocks.new_zeros((n_nodes, 6))
    b.index_add_(0, b_rows, b_blocks)
    return (scatter_blocks(n_nodes, rows, cols, blocks), b.reshape(-1),
            errs.sum())


def normal_system(poses, src_idx, tgt_idx, z_inv, info, weight,
                  n_nodes: int):
    """The [6N, 6N] H, [6N] b and the weighted squared error of an edge
    set."""
    return assemble(n_nodes, *edge_blocks(poses, src_idx, tgt_idx, z_inv,
                                          info, weight))


def solve_anchored(H, b, lam, n_nodes: int):
    """GN step with node 0 held fixed: the reduced system without the
    anchor's block, zeros re-inserted for it. [n_nodes, 6]. Damps H's
    diagonal in place."""
    H.diagonal()[6:].add_(lam)
    dxr = -torch.linalg.solve(H[6:, 6:], b[6:])
    return torch.cat([dxr.new_zeros(6), dxr]).reshape(n_nodes, 6)


def _optimize(poses, edges, n_nodes: int, max_iteration: int, lam,
              mesh: Optional[Mesh]):
    """GN iterations in the dtype of `poses`; with `mesh`, `edges` are
    this rank's: each rank computes its edges' blocks, rank 0 gathers
    all of them, assembles H and b and solves, and broadcasts the step
    and the error."""
    err = torch.zeros((), dtype=poses.dtype, device=poses.device)
    lead = mesh is None or mesh.rank == 0
    for _ in range(max_iteration):
        parts = edge_blocks(poses, *edges)
        if mesh is not None:
            parts = [mesh.all_gather(p) for p in parts]
        if lead:
            H, b, err = assemble(n_nodes, *parts)
            dx = solve_anchored(H, b, lam, n_nodes)
            del H
        else:
            dx = poses.new_empty((n_nodes, 6))
        if mesh is not None:
            step = mesh.broadcast(torch.cat([dx.reshape(-1), err[None]]))
            dx, err = step[:-1].reshape(n_nodes, 6), step[-1]
        poses = exp_se3(dx) @ poses
    return poses, err


def _edge_arrays(pose_graph: PoseGraph, option: GlobalOptimizationOption,
                 n_shards: int):
    """(src, tgt, z_inv, info, weight) as numpy, padded to a multiple of
    `n_shards` with edges that self-connect node 0 at zero weight."""
    edges = pose_graph.edges
    src = np.asarray([e.source_node_id for e in edges], np.int64)
    tgt = np.asarray([e.target_node_id for e in edges], np.int64)
    z = np.stack([e.transformation for e in edges])
    info = np.stack([e.information for e in edges]).astype(np.float32)
    weight = np.asarray([option.preference_loop_closure if e.uncertain
                         else 1.0 for e in edges], np.float32)
    z_inv = np.linalg.inv(z).astype(np.float32)
    pad = (-len(edges)) % n_shards
    if pad:
        src = np.concatenate([src, np.zeros(pad, np.int64)])
        tgt = np.concatenate([tgt, np.zeros(pad, np.int64)])
        z_inv = np.concatenate(
            [z_inv, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        info = np.concatenate(
            [info, np.tile(np.eye(6, dtype=np.float32), (pad, 1, 1))])
        weight = np.concatenate([weight, np.zeros(pad, np.float32)])
    return src, tgt, z_inv, info, weight


def global_optimization(pose_graph: PoseGraph,
                        option: Optional[GlobalOptimizationOption] = None,
                        mesh: Optional[Mesh] = None,
                        device=None) -> PoseGraph:
    """Optimises the node poses in place and returns the graph.

    With `mesh`, the edges are padded to a multiple of its size and each
    rank takes its block of them, on the mesh's device; every rank must
    call with the same graph. Without, the same iterations run on
    `device` (None: the card)."""
    option = option or GlobalOptimizationOption()
    n_nodes = len(pose_graph.nodes)
    if n_nodes == 0 or len(pose_graph.edges) == 0:
        console.log_warning("[GlobalOptimization] empty pose graph.")
        return pose_graph
    dev = mesh.device if mesh is not None else resolve_device(device)
    n_shards = 1 if mesh is None else mesh.size
    arrays = _edge_arrays(pose_graph, option, n_shards)
    per = arrays[0].shape[0] // n_shards
    lo = 0 if mesh is None else mesh.rank * per
    edges = tuple(torch.as_tensor(a[lo:lo + per], device=dev)
                  for a in arrays)
    poses = torch.as_tensor(
        np.stack([n.pose for n in pose_graph.nodes]).astype(np.float32),
        device=dev).double()
    new_poses, err = _optimize(poses, edges, n_nodes, option.max_iteration,
                               DAMPING, mesh)
    new_poses = new_poses.float().cpu().numpy()
    console.log_debug("[GlobalOptimization] residual %g", float(err))
    for i, node in enumerate(pose_graph.nodes):
        node.pose = new_poses[i]
    return pose_graph
