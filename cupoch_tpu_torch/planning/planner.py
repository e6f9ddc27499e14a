"""Roadmap planner over a 3D position graph (cupoch
planning/planner.{h,cu}, planner.h:31-67, planner.cu:35-130): the edges
that pass within the object's radius of an obstacle get an infinite
weight (RemoveCollisionEdges, planner.cu:62-107) and the path comes from
the graph's shortest paths, on the graph's device."""
from __future__ import annotations

import copy
from typing import List

import numpy as np
import torch

from ..collision import compute_intersection
from ..geometry.graph import Graph
from ..geometry.occupancygrid import OccupancyGrid
from ..geometry.voxelgrid import VoxelGrid
from ..utility import console


class PlannerBase:
    """planner.h:31-45."""

    def __init__(self):
        self.obstacles = []

    def add_obstacle(self, obstacle):
        self.obstacles.append(obstacle)
        return self

    def find_path(self, start, goal):
        raise NotImplementedError


class Pos3DPlanner(PlannerBase):
    """planner.h:47-67 (the same defaults)."""

    def __init__(self, graph: Graph, object_radius: float = 0.1,
                 max_edge_distance: float = 1.0):
        super().__init__()
        self.graph = copy.deepcopy(graph)
        self.object_radius = float(object_radius)
        self.max_edge_distance = float(max_edge_distance)
        #: relaxations of the last find_path's shortest paths
        self.last_sssp_iterations = 0

    def update_graph(self):
        self._remove_collision_edges(self.graph)
        return self

    def _remove_collision_edges(self, graph: Graph):
        graph.set_edge_weights_from_distance()
        for obstacle in self.obstacles:
            if not isinstance(obstacle, (VoxelGrid, OccupancyGrid)):
                console.log_error("Unsupported obstacle type.")
            res = compute_intersection(obstacle, graph, self.object_radius)
            if res.is_collided():
                edge_ids = res.get_collision_index_pairs()[:, 1].long()
                w = graph.edge_weights.clone()
                w[edge_ids.to(w.device)] = float("inf")
                graph.edge_weights = w

    def find_path(self, start, goal) -> List[np.ndarray]:
        """The path's points from start to goal, both joined to the nodes
        within max_edge_distance; [] when there is none (cupoch
        Pos3DPlanner::FindPath, planner.cu:109-130)."""
        ex = copy.deepcopy(self.graph)
        n_start = int(ex.points.shape[0])
        n_goal = n_start + 1
        ex.add_node_and_connect(np.asarray(start, np.float32),
                                self.max_edge_distance, lazy_add=True)
        ex.add_node_and_connect(np.asarray(goal, np.float32),
                                self.max_edge_distance, lazy_add=False)
        self._remove_collision_edges(ex)
        path_idx, dist = ex.dijkstra_path(n_start, n_goal)
        self.last_sssp_iterations = ex.last_sssp_iterations
        if not np.isfinite(dist):
            return []
        pts = ex.points[torch.as_tensor(path_idx, device=ex.device)]
        return list(pts.cpu().numpy())
