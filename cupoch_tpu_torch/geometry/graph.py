"""Graph over a LineSet, with single-source shortest paths (cupoch
geometry/graph.{h,cu}, graph.h:29-128).

Edges are directed [E, 2] rows of `lines` with float32 `edge_weights`;
an undirected graph (the default) stores both directions. The shortest
paths are the reference's fixed point of synchronous relaxations
(graph.cu:65-136), each one scatter-min over the edge list on the
graph's device; the loop reads whether a distance changed once every
SSSP_CHECK_ITERATIONS relaxations (a relaxation at the fixed point
changes nothing). Distances are sums along paths in float32 and each
node's predecessor is the least source among the edges that reach its
distance.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..utility import console
from .geometry import GeometryType, as_f32, norm_f32
from .lineset import LineSet, as_i32

#: the SSSP loop tests for a change once every this many relaxations
SSSP_CHECK_ITERATIONS = 8
_BIG = np.iinfo(np.int32).max


class SSSPResult:
    """graph.h:31-44."""

    def __init__(self, shortest_distance=float("inf"), prev_index=-1):
        self.shortest_distance = float(shortest_distance)
        self.prev_index = int(prev_index)

    def __repr__(self):
        return (f"SSSPResult(dist={self.shortest_distance:.4f}, "
                f"prev={self.prev_index})")


def sssp(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, start: int,
         n_nodes: int, max_iter: int):
    """(dist [N] float32, prev [N] int32, relaxations run): the fixed
    point of dist[v] = min(dist[v], min_e dist[src_e] + w_e) from
    `start`, at most `max_iter` relaxations."""
    dev = w.device
    src = src.long()
    dst = dst.long()
    dist = torch.full((n_nodes,), float("inf"), device=dev)
    dist[start] = 0.0
    it = 0
    while it < max_iter:
        prev_check = dist
        for _ in range(min(SSSP_CHECK_ITERATIONS, max_iter - it)):
            dist = dist.scatter_reduce(0, dst, dist[src] + w, "amin")
            it += 1
        if not bool((dist < prev_check).any()):
            break
    cand = dist[src] + w
    achieves = cand == dist[dst]
    big = torch.full((n_nodes,), _BIG, dtype=torch.int64, device=dev)
    prev = big.scatter_reduce(0, dst, torch.where(achieves, src, _BIG),
                              "amin")
    prev = torch.where((prev == _BIG) | ~torch.isfinite(dist), -1, prev)
    prev[start] = -1
    return dist, prev.to(torch.int32), it


def _edge_keys(e: torch.Tensor, n: int) -> torch.Tensor:
    e = e.long()
    return e[:, 0] * n + e[:, 1]


class Graph(LineSet):
    """graph.h:29-128."""

    def __init__(self, points=None, dim: int = 3, device=None):
        super().__init__(points=points, dim=dim, gtype=GeometryType.Graph,
                         device=device)
        self.edge_weights = np.zeros((0,), np.float32)
        self.node_colors = np.zeros((0, 3), np.float32)
        self.is_directed = False
        #: relaxations of the last SSSP
        self.last_sssp_iterations = 0

    @property
    def edge_weights(self):
        return self._edge_weights

    @edge_weights.setter
    def edge_weights(self, v):
        self._edge_weights = as_f32(v, self.device, ()).reshape(-1)

    @property
    def node_colors(self):
        return self._node_colors

    @node_colors.setter
    def node_colors(self, v):
        self._node_colors = as_f32(v, self.device).reshape(-1, 3)

    @staticmethod
    def from_numpy(points, lines, edge_weights, is_directed: bool = False,
                   dim: int = 3, device=None) -> "Graph":
        """A graph holding a saved state: nodes, directed edge rows and
        their weights."""
        g = Graph(points, dim=dim, device=device)
        g.lines = lines
        g.edge_weights = edge_weights
        g.is_directed = bool(is_directed)
        return g

    # -- predicates ---------------------------------------------------------
    def has_weights(self) -> bool:
        return (self.edge_weights.shape[0] > 0
                and self.lines.shape[0] == self.edge_weights.shape[0])

    def has_node_colors(self) -> bool:
        return (self.node_colors.shape[0] > 0
                and self.points.shape[0] == self.node_colors.shape[0])

    def is_constructed(self) -> bool:
        return self.has_weights()

    def clear(self):
        super().clear()
        self.edge_weights = np.zeros((0,), np.float32)
        self.node_colors = np.zeros((0, 3), np.float32)
        return self

    def __repr__(self):
        return (f"Graph with {int(self.lines.shape[0])} edges and "
                f"{int(self.points.shape[0])} nodes on {self.device}.")

    # -- construction ---------------------------------------------------------
    def construct_graph(self, set_edge_weights_from_distance: bool = True):
        """cupoch Graph::ConstructGraph: only the weights need making
        (no CSR table)."""
        if set_edge_weights_from_distance or not self.has_weights():
            self.set_edge_weights_from_distance()
        return self

    def set_edge_weights_from_distance(self):
        li = self.lines.long()
        d = self.points[li[:, 0]] - self.points[li[:, 1]]
        self.edge_weights = norm_f32(d[:, 0], d[:, 1], d[:, 2])
        return self

    def add_edge(self, edge, weight: float = 1.0, lazy_add: bool = False):
        return self.add_edges(np.asarray(edge, np.int32)[None],
                              np.asarray([weight], np.float32), lazy_add)

    def add_edges(self, edges, weights=None, lazy_add: bool = False):
        """cupoch Graph::AddEdges (graph.cu:342-383): an undirected graph
        gets the reversed copies too."""
        edges = as_i32(edges, self.device, 2)
        weights = torch.ones(0) if weights is None \
            else as_f32(weights, self.device, ()).reshape(-1)
        if weights.shape[0] == 0:
            weights = torch.ones(edges.shape[0], device=self.device)
        if weights.shape[0] != edges.shape[0]:
            console.log_error("[AddEdges] edges size is not equal to "
                              "weights size.")
        if not self.is_directed:
            edges = torch.cat([edges, edges.flip(1)], 0)
            weights = torch.cat([weights, weights], 0)
        self.lines = torch.cat([self.lines, edges], 0)
        self.edge_weights = torch.cat([self.edge_weights, weights], 0)
        return self

    def remove_edge(self, edge):
        return self.remove_edges(np.asarray(edge, np.int32)[None])

    def _edge_hits(self, edges, both: bool) -> torch.Tensor:
        """[E] bool: which rows of `lines` are among `edges` (or their
        reverses when `both`)."""
        edges = as_i32(edges, self.device, 2)
        if both:
            edges = torch.cat([edges, edges.flip(1)], 0)
        n = max(int(self.points.shape[0]),
                int(self.lines.max()) + 1 if self.lines.shape[0] else 0,
                int(edges.max()) + 1 if edges.shape[0] else 0)
        return torch.isin(_edge_keys(self.lines, n), _edge_keys(edges, n))

    def remove_edges(self, edges):
        """cupoch Graph::RemoveEdges (graph.cu:418-470)."""
        kill = self._edge_hits(edges, not self.is_directed)
        n_lines = kill.shape[0]
        self.lines = self.lines[~kill]
        if self.edge_weights.shape[0] == n_lines:
            self.edge_weights = self.edge_weights[~kill]
        if self.colors.shape[0] == n_lines:
            self.colors = self.colors[~kill]
        return self

    def add_node_and_connect(self, point, max_edge_distance: float = 0.0,
                             lazy_add: bool = False):
        """A new node joined to every node within max_edge_distance (to
        every node when it is 0), weights the distances (cupoch
        Graph::AddNodeAndConnect, graph.cu:300-321)."""
        p = as_f32(np.asarray(point, np.float32).reshape(1, 3), self.device)
        n = int(self.points.shape[0])
        e = self.points - p
        d = norm_f32(e[:, 0], e[:, 1], e[:, 2])
        sel = torch.nonzero(d <= max_edge_distance)[:, 0] \
            if max_edge_distance > 0 else torch.arange(n, device=self.device)
        self.points = torch.cat([self.points, p], 0)
        if sel.shape[0] > 0:
            edges = torch.stack([torch.full_like(sel, n), sel], -1)
            self.add_edges(edges, d[sel], lazy_add)
        return self

    def connect_to_nearest_neighbors(self, max_edge_distance: float,
                                     max_num_edges: int = 30):
        """Each node joined to its neighbours within max_edge_distance,
        at most max_num_edges of them (cupoch
        Graph::ConnectToNearestNeighbors), over the port's k-NN search."""
        from ..knn import KDTreeSearchParamRadius, search_neighbors

        idx, _ = search_neighbors(
            self.points, self.points,
            KDTreeSearchParamRadius(max_edge_distance, max_num_edges))
        idx_np = idx.cpu().numpy()
        n = idx_np.shape[0]
        rows = np.repeat(np.arange(n), idx_np.shape[1])
        cols = idx_np.reshape(-1)
        keep = (cols >= 0) & (cols != rows)
        uv = np.unique(np.sort(np.stack([rows[keep], cols[keep]], -1),
                               axis=1), axis=0)
        if len(uv) > 0:
            pts = self.points.cpu().numpy()
            w = np.linalg.norm(pts[uv[:, 0]] - pts[uv[:, 1]], axis=-1)
            self.add_edges(uv, w.astype(np.float32))
        return self

    def set_edge_weights(self, edges, weight: float):
        """The weight of the given (directed) edges (cupoch
        Graph::SetEdgeWeights)."""
        hit = self._edge_hits(edges, False)
        self.edge_weights = torch.where(hit, float(np.float32(weight)),
                                        self.edge_weights)
        return self

    # -- painting -------------------------------------------------------------
    def paint_node_color(self, node: int, color):
        if not self.has_node_colors():
            self.node_colors = torch.ones((int(self.points.shape[0]), 3),
                                          device=self.device)
        c = self.node_colors.clone()
        c[node] = as_f32(color, self.device)
        self.node_colors = c
        return self

    def paint_nodes_color(self, nodes, color):
        for n in np.asarray(nodes).reshape(-1):
            self.paint_node_color(int(n), color)
        return self

    def paint_edge_color(self, edge, color):
        hits = self._edge_hits(np.asarray(edge, np.int32)[None], True)
        if not self.has_colors():
            self.colors = torch.ones((int(self.lines.shape[0]), 3),
                                     device=self.device)
        self.colors = torch.where(hits[:, None], as_f32(color, self.device),
                                  self.colors)
        return self

    def paint_edges_color(self, edges, color):
        for e in np.asarray(edges).reshape(-1, 2):
            self.paint_edge_color(e, color)
        return self

    # -- shortest paths ---------------------------------------------------
    def _sssp(self, start_node_index: int):
        if not self.is_constructed():
            self.construct_graph(set_edge_weights_from_distance=not
                                 self.has_weights())
        n = int(self.points.shape[0])
        dist, prev, self.last_sssp_iterations = sssp(
            self.lines[:, 0], self.lines[:, 1], self.edge_weights,
            start_node_index, n, max_iter=n)
        return dist.cpu().numpy(), prev.cpu().numpy()

    def dijkstra_paths(self, start_node_index: int,
                       end_node_index: int = -1) -> List[SSSPResult]:
        """The shortest-path table of every node (cupoch
        Graph::DijkstraPaths, graph.cu:668-727)."""
        n = int(self.points.shape[0])
        if self.lines.shape[0] == 0:
            out = [SSSPResult() for _ in range(n)]
            if 0 <= start_node_index < n:
                out[start_node_index] = SSSPResult(0.0, -1)
            return out
        dist, prev = self._sssp(start_node_index)
        return [SSSPResult(d, p) for d, p in zip(dist, prev)]

    def dijkstra_path(self, start_node_index: int,
                      end_node_index: int) -> Tuple[List[int], float]:
        """The path and its length (cupoch Graph::DijkstraPath,
        graph.cu:729-757); ([], inf) when the end is unreachable."""
        if self.lines.shape[0] == 0:
            return ([start_node_index], 0.0) \
                if start_node_index == end_node_index else ([], float("inf"))
        dist, prev = self._sssp(start_node_index)
        d = float(dist[end_node_index])
        if not np.isfinite(d):
            return [], float("inf")
        path = [end_node_index]
        node = end_node_index
        while node != start_node_index:
            node = int(prev[node])
            if node < 0:
                return [], float("inf")
            path.append(node)
        return path[::-1], d

    @staticmethod
    def create_from_triangle_mesh(mesh) -> "Graph":
        """The graph of the mesh's edges (cupoch graph.cu
        CreateFromTriangleMesh), on the mesh's device."""
        v = mesh.vertices.cpu().numpy()
        t = mesh.triangles.cpu().numpy()
        g = Graph(v, device=mesh.device)
        edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], 0)
        uv = np.unique(np.sort(edges, axis=1), axis=0)
        w = np.linalg.norm(v[uv[:, 0]] - v[uv[:, 1]], axis=-1)
        return g.add_edges(uv, w.astype(np.float32))

    @staticmethod
    def create_from_axis_aligned_bounding_box(box, resolutions,
                                              device=None) -> "Graph":
        """A lattice graph filling an AABB, `resolutions` nodes an axis
        (cupoch graph.cu CreateFromAxisAlignedBoundingBox)."""
        try:
            min_b = np.asarray(box.get_min_bound(), np.float32)
            max_b = np.asarray(box.get_max_bound(), np.float32)
        except AttributeError:
            min_b, max_b = [np.asarray(b, np.float32) for b in box]
        res = np.asarray(resolutions, np.int64)
        axes = [np.linspace(min_b[i], max_b[i], res[i]) for i in range(3)]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        g = Graph(pts.astype(np.float32), device=device)
        nx, ny, nz = res

        def lid(i, j, k):
            return (i * ny + j) * nz + k

        ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                 indexing="ij")
        base = lid(ii, jj, kk)
        edges = np.concatenate([
            np.stack([base[lim], d[lim]], -1) for d, lim in (
                (lid(ii + 1, jj, kk), ii + 1 < nx),
                (lid(ii, jj + 1, kk), jj + 1 < ny),
                (lid(ii, jj, kk + 1), kk + 1 < nz))], 0)
        w = np.linalg.norm(pts[edges[:, 0]] - pts[edges[:, 1]], axis=-1)
        return g.add_edges(edges, w.astype(np.float32))
