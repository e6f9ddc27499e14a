"""The port's line set, graph and shortest paths, roadmap planner, URDF
kinematics and 2D map (cupoch_tpu_torch.geometry, .planning,
.kinematics) against the JAX package on the same seeded numpy inputs,
on the CPU, with graphs of a few thousand edges.

Tolerances: SSSP distances and predecessors bit-equal (the same float32
weights carried over by `Graph.from_numpy`); graph nodes, edges and
weights equal; planner paths equal point for point, their lengths
within 1e-6 relative; FK poses within 1e-6; line-set points within
1e-6.
"""
import copy
import io

import numpy as np
import pytest
import torch

import chip_smoke
import torch_port_bridge as bridge
from cupoch_tpu.geometry import Graph as JGraph
from cupoch_tpu.geometry import Image as JImage
from cupoch_tpu.geometry import LineSet as JLineSet
from cupoch_tpu.geometry import Map2D as JMap2D
from cupoch_tpu.geometry import OccupancyGrid as JOcc
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.geometry import TriangleMesh as JMesh
from cupoch_tpu.geometry import VoxelGrid as JVG
from cupoch_tpu.geometry.graph import _sssp as jsssp
from cupoch_tpu.kinematics import KinematicChain as JChain
from cupoch_tpu.planning import Pos3DPlanner as JPlanner
from cupoch_tpu_torch.geometry import Graph as TGraph
from cupoch_tpu_torch.geometry import Image as TImage
from cupoch_tpu_torch.geometry import LineSet as TLineSet
from cupoch_tpu_torch.geometry import Map2D as TMap2D
from cupoch_tpu_torch.geometry import graph as tgraph
from cupoch_tpu_torch.kinematics import KinematicChain as TChain
from cupoch_tpu_torch.planning import Pos3DPlanner as TPlanner

CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# line set
# ---------------------------------------------------------------------------

def _line_sets(dim=3):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (30, dim)).astype(np.float32)
    lines = rng.integers(0, 30, (40, 2)).astype(np.int32)
    return JLineSet(pts, lines, dim=dim), TLineSet(pts, lines, dim=dim,
                                                   device=CPU)


def test_torch_lineset_matches_jax():
    j, t = _line_sets()
    for name in ("get_min_bound", "get_max_bound", "get_center"):
        np.testing.assert_allclose(getattr(t, name)(), getattr(j, name)(),
                                   atol=1e-6)
    for a, b in zip(t.get_line_coordinate(7), j.get_line_coordinate(7)):
        np.testing.assert_array_equal(a, b)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    T[:3, 3] = (0.5, -0.2, 0.1)
    for ls in (j, t):
        ls.transform(T)
        ls.translate((0.1, 0.2, 0.3))
        ls.scale(1.5)
        ls.rotate(T[:3, :3])
        ls.translate((1.0, 1.0, 1.0), relative=False)
        ls.scale(0.5, center=False)
        ls.paint_uniform_color((0.2, 0.4, 0.6))
    np.testing.assert_allclose(_np(t.points), np.asarray(j.points),
                               atol=1e-6)
    np.testing.assert_allclose(_np(t.colors), np.asarray(j.colors))
    assert t.has_colors() and repr(t).startswith(repr(j)[:-1])
    path = np.asarray([[0, 0, 0], [1, 0, 0], [2, 1, 0]], np.float32)
    np.testing.assert_array_equal(
        _np(TLineSet.from_path(path, device=CPU).lines),
        np.asarray(JLineSet.from_path(path).lines))
    carried = bridge.line_set(j)
    np.testing.assert_array_equal(_np(carried.points), np.asarray(j.points))


def test_torch_lineset_2d_matches_jax():
    j, t = _line_sets(2)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[0.6, -0.8], [0.8, 0.6]]
    T[:2, 2] = (0.3, -0.1)
    j.transform(T)
    t.transform(T)
    np.testing.assert_allclose(_np(t.points), np.asarray(j.points),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# graph and shortest paths
# ---------------------------------------------------------------------------

def _lattice_pair(res=(9, 7, 6), box=((0, 0, 0), (2.0, 1.5, 1.25))):
    j = JGraph.create_from_axis_aligned_bounding_box(box, res)
    t = TGraph.create_from_axis_aligned_bounding_box(box, res, device=CPU)
    return j, t


def _same_graph(j, t):
    np.testing.assert_array_equal(_np(t.points), np.asarray(j.points))
    np.testing.assert_array_equal(_np(t.lines), np.asarray(j.lines))
    np.testing.assert_array_equal(_np(t.edge_weights),
                                  np.asarray(j.edge_weights))


def test_torch_graph_lattice_matches_jax():
    j, t = _lattice_pair()
    assert int(t.lines.shape[0]) > 1000
    _same_graph(j, t)
    from cupoch_tpu_torch.geometry import AxisAlignedBoundingBox
    box = AxisAlignedBoundingBox((0, 0, 0), (2.0, 1.5, 1.25), device=CPU)
    _same_graph(j, TGraph.create_from_axis_aligned_bounding_box(
        box, (9, 7, 6), device=CPU))


def test_torch_graph_from_triangle_mesh_matches_jax():
    jm = JMesh.create_sphere(1.0, 10)
    j = JGraph.create_from_triangle_mesh(jm)
    t = TGraph.create_from_triangle_mesh(bridge.mesh(jm))
    _same_graph(j, t)


def _random_graph(seed, n=600, e=3000, directed=False):
    rng = np.random.default_rng(seed)
    j = JGraph(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    j.is_directed = directed
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    w = rng.uniform(0.01, 1.0, e).astype(np.float32)
    w[::37] = np.inf                       # edges a planner removed
    j.add_edges(edges, w)
    return j, bridge.graph(j)


@pytest.mark.parametrize("case", ["lattice", "random", "directed"])
def test_torch_sssp_bit_equal(case):
    if case == "lattice":
        j, t = _lattice_pair()
    else:
        j, t = _random_graph(1, directed=case == "directed")
    n = int(j.points.shape[0])
    jd, jp = jsssp(j.lines[:, 0], j.lines[:, 1], j.edge_weights, 3, n,
                   max_iter=n)
    td, tp, it = tgraph.sssp(t.lines[:, 0], t.lines[:, 1], t.edge_weights,
                             3, n, n)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert 0 < it < n and np.isfinite(np.asarray(jd)).mean() > 0.5
    jr = j.dijkstra_paths(3)
    tr = t.dijkstra_paths(3)
    assert [(r.shortest_distance, r.prev_index) for r in tr] == \
        [(r.shortest_distance, r.prev_index) for r in jr]
    far = int(np.nanargmax(np.where(np.isfinite(jd), jd, np.nan)))
    assert t.dijkstra_path(3, far) == j.dijkstra_path(3, far)


def test_torch_sssp_check_interval_keeps_result(monkeypatch):
    _, t = _random_graph(2)
    n = int(t.points.shape[0])
    out = []
    for k in (1, 3, 64):
        monkeypatch.setattr(tgraph, "SSSP_CHECK_ITERATIONS", k)
        out.append(tgraph.sssp(t.lines[:, 0], t.lines[:, 1],
                               t.edge_weights, 0, n, n))
    for d, p, _ in out[1:]:
        assert torch.equal(d, out[0][0]) and torch.equal(p, out[0][1])


def test_torch_dijkstra_edge_cases_match_jax():
    j = JGraph(np.asarray([[0, 0, 0], [1, 0, 0], [5, 5, 5]], np.float32))
    t = TGraph(np.asarray([[0, 0, 0], [1, 0, 0], [5, 5, 5]], np.float32),
               device=CPU)
    assert t.dijkstra_paths(0)[0].shortest_distance == 0.0
    for g in (j, t):
        g.add_edge([0, 1], 1.0)
    assert t.dijkstra_path(0, 2) == j.dijkstra_path(0, 2) == ([], np.inf)
    assert t.dijkstra_path(0, 1) == j.dijkstra_path(0, 1)


def test_torch_graph_editing_matches_jax():
    j, t = _random_graph(3, n=200, e=600)
    rng = np.random.default_rng(4)
    kill = rng.integers(0, 200, (50, 2)).astype(np.int32)
    kill[:20] = np.asarray(j.lines)[rng.integers(0, 1200, 20)]
    for g in (j, t):
        g.add_edge([1, 2], 0.5)
        g.add_edges([[3, 4], [5, 6]])
        g.remove_edges(kill)
        g.remove_edge([1, 2])
        g.set_edge_weights(np.asarray(j.lines)[:30], 2.5)
        g.add_node_and_connect([0.5, 0.5, 0.5], 0.3)
        g.add_node_and_connect([0.1, 0.2, 0.3])
    _same_graph(j, t)
    for g in (j, t):
        g.set_edge_weights_from_distance()
    np.testing.assert_allclose(_np(t.edge_weights),
                               np.asarray(j.edge_weights), rtol=1e-6)
    assert t.is_constructed() and t.has_weights()


def test_torch_graph_painting_matches_jax():
    j, t = _random_graph(5, n=50, e=120)
    for g in (j, t):
        g.paint_node_color(3, (1.0, 0.0, 0.0))
        g.paint_nodes_color([4, 5], (0.0, 1.0, 0.0))
        g.paint_edge_color(np.asarray(j.lines)[0], (0.0, 0.0, 1.0))
        g.paint_edges_color(np.asarray(j.lines)[5:8], (0.5, 0.5, 0.5))
    np.testing.assert_array_equal(_np(t.node_colors),
                                  np.asarray(j.node_colors))
    np.testing.assert_array_equal(_np(t.colors), np.asarray(j.colors))
    assert t.has_node_colors() and t.has_colors()


def test_torch_connect_to_nearest_neighbors_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    j = JGraph(pts).connect_to_nearest_neighbors(0.12, 10)
    t = TGraph(pts, device=CPU).connect_to_nearest_neighbors(0.12, 10)
    assert int(t.lines.shape[0]) > 500
    _same_graph(j, t)


def test_torch_graph_deepcopy_and_state():
    j, t = _random_graph(7, n=100, e=300)
    c = copy.deepcopy(t)
    c.add_edge([0, 1], 9.0)
    assert int(c.lines.shape[0]) == int(t.lines.shape[0]) + 2
    _same_graph(j, t)
    assert repr(t).startswith("Graph with 600 edges and 100 nodes")


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _wall_obstacle(kind):
    wall = np.asarray([[1.0, y, z] for y in np.linspace(0, 2, 21)
                       for z in np.linspace(0, 1.6, 17)], np.float32)
    if kind == "voxel":
        j = JVG.create_from_point_cloud(JPointCloud(wall), 0.1)
        return j, bridge.voxel_grid(j)
    j = JOcc(0.1, 64)
    j.insert(wall, np.asarray([0.2, 1.0, 0.8], np.float32))
    return j, bridge.occupancy_grid(j)


@pytest.mark.parametrize("kind", ["voxel", "occupancy"])
def test_torch_planner_matches_jax(kind):
    jl, tl = _lattice_pair((9, 9, 9), ((0, 0, 0), (2, 2, 2)))
    jo, to = _wall_obstacle(kind)
    jp = JPlanner(jl, object_radius=0.05, max_edge_distance=0.5)
    tp = TPlanner(tl, object_radius=0.05, max_edge_distance=0.5)
    jp.add_obstacle(jo)
    tp.add_obstacle(to)
    jp.update_graph()
    tp.update_graph()
    np.testing.assert_array_equal(_np(tp.graph.edge_weights),
                                  np.asarray(jp.graph.edge_weights))
    start, goal = [0.1, 1.0, 0.1], [1.9, 1.0, 0.1]
    want = np.asarray(jp.find_path(start, goal))
    got = np.asarray(tp.find_path(start, goal))
    assert len(want) > 2
    np.testing.assert_array_equal(got, want)
    assert int(tl.lines.shape[0]) == int(jl.lines.shape[0])  # a copy


def test_torch_planner_without_path():
    _, tl = _lattice_pair((5, 5, 5), ((0, 0, 0), (2, 2, 2)))
    full = np.asarray([[1.0, y, z] for y in np.linspace(-0.2, 2.2, 25)
                       for z in np.linspace(-0.2, 2.2, 25)], np.float32)
    vg = bridge.voxel_grid(JVG.create_from_point_cloud(JPointCloud(full),
                                                       0.1))
    tp = TPlanner(tl, object_radius=0.05, max_edge_distance=0.3)
    tp.add_obstacle(vg)
    tp.update_graph()
    assert tp.find_path([0.1, 1.0, 0.1], [1.9, 1.0, 0.1]) == []


# ---------------------------------------------------------------------------
# kinematics
# ---------------------------------------------------------------------------

@pytest.fixture
def arm_urdf(tmp_path):
    p = tmp_path / "arm.urdf"
    p.write_text(chip_smoke.ARM_URDF)
    return str(p)


def test_torch_urdf_parse_matches_jax(arm_urdf):
    j = JChain(arm_urdf)
    t = TChain(arm_urdf, device=CPU)

    def walk(f):
        yield f.link.name, f.joint.name, int(f.joint.type), \
            f.joint.axis.tolist(), f.joint.offset.tolist(), \
            len(f.link.collisions), len(f.link.visuals)
        for c in f.children:
            yield from walk(c)

    assert list(walk(t.root)) == list(walk(j.root))
    assert len(list(walk(t.root))) == 8
    for name, link in t.link_map.items():
        for a, b in zip(link.collisions, j.link_map[name].collisions):
            assert a.primitive.type == b.primitive.type
            np.testing.assert_array_equal(a.primitive.transform,
                                          b.primitive.transform)


@pytest.mark.parametrize("case", ["zero", "joints", "base"])
def test_torch_fk_matches_jax(arm_urdf, case):
    j = JChain(arm_urdf)
    t = TChain(arm_urdf, device=CPU)
    rng = np.random.default_rng(8)
    q = {} if case == "zero" else {
        f"joint_{k}": float(v) for k, v in enumerate(
            rng.uniform(-np.pi, np.pi, 6))}
    base = None if case != "base" else chip_smoke.arm_base(np)
    jp = j.forward_kinematics(q, base)
    tp = t.forward_kinematics(q, base)
    assert sorted(tp) == sorted(jp) and len(tp) == 8
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], atol=1e-6)


def test_torch_visual_geometry_map_matches_jax(arm_urdf):
    j = JChain(arm_urdf)
    t = TChain(arm_urdf, device=CPU)
    q = {"joint_1": 0.4, "joint_2": -0.7}
    jm = j.get_transformed_visual_geometry_map(j.forward_kinematics(q))
    tm = t.get_transformed_visual_geometry_map(t.forward_kinematics(q))
    assert sorted(tm) == sorted(jm) and len(tm) >= 5
    for name in jm:
        for a, b in zip(tm[name], jm[name]):
            np.testing.assert_allclose(a.vertices.numpy(),
                                       np.asarray(b.vertices), atol=1e-5)


def test_torch_urdf_mesh_shape_raises(tmp_path):
    """A mesh file whose read raises (an unknown format), or that is
    missing, leaves its shape without a mesh and keeps the link, as in
    the reference (a failed read logs a warning)."""
    (tmp_path / "a.xyz").write_text("not a mesh")
    p = tmp_path / "mesh.urdf"
    p.write_text('<robot name="r"><link name="a"><visual><geometry>'
                 '<mesh filename="package://a.xyz"/></geometry></visual>'
                 '<collision><geometry><mesh filename="missing.stl"/>'
                 '</geometry></collision></link></robot>')
    for chain in (TChain(str(p), device=CPU), JChain(str(p))):
        link = chain.link_map["a"]
        assert len(link.visuals) == len(link.collisions) == 1
        assert link.visuals[0].mesh is None
        assert link.collisions[0].mesh is None
    # a URDF given as a file object (as chip_smoke.py's robotics phase
    # gives it) resolves mesh files against the working directory
    chain = TChain(device=CPU).build_from_urdf(io.StringIO(p.read_text()))
    assert chain.link_map["a"].visuals[0].mesh is None


def test_torch_urdf_mesh_link_matches_jax(tmp_path):
    """A link shape given as an STL file next to the URDF (`package://`,
    a scale and an origin) posed by forward kinematics in both
    packages."""
    from cupoch_tpu_torch.geometry import TriangleMesh as TMesh
    from cupoch_tpu_torch.io import write_triangle_mesh

    box = TMesh.create_box(0.2, 0.1, 0.3, device=CPU)
    assert write_triangle_mesh(str(tmp_path / "part.stl"), box)
    urdf = chip_smoke.ARM_URDF.replace(
        '<link name="forearm_link">',
        '<link name="forearm_link"><visual><origin xyz="0.1 -0.2 0.05" '
        'rpy="0.3 -0.1 0.7"/><geometry><mesh filename="package://part.stl"'
        ' scale="1.5 0.5 2.0"/></geometry></visual>', 1)
    assert urdf != chip_smoke.ARM_URDF
    path = tmp_path / "arm_mesh.urdf"
    path.write_text(urdf)
    j = JChain(str(path))
    t = TChain(str(path), device=CPU)
    shape = t.link_map["forearm_link"].visuals[0]
    assert shape.primitive is None and shape.mesh is not None
    assert len(shape.mesh.triangles) == 12
    q = {"joint_1": 0.4, "joint_2": -0.7}
    jm = j.get_transformed_visual_geometry_map(j.forward_kinematics(q))
    tm = t.get_transformed_visual_geometry_map(t.forward_kinematics(q))
    assert sorted(tm) == sorted(jm)
    assert len(tm["forearm_link"]) == len(jm["forearm_link"]) >= 1
    for name in jm:
        for a, b in zip(tm[name], jm[name]):
            np.testing.assert_allclose(a.vertices.numpy(),
                                       np.asarray(b.vertices), atol=1e-5)
            np.testing.assert_array_equal(a.triangles.numpy(),
                                          np.asarray(b.triangles))


# ---------------------------------------------------------------------------
# 2D map
# ---------------------------------------------------------------------------

def test_torch_map2d_matches_jax():
    img = np.random.default_rng(9).uniform(0, 1, (12, 20)).astype(
        np.float32)
    j = JMap2D(JImage(img), 0.1, (0.5, -0.5))
    t = TMap2D(TImage(img, device=CPU), 0.1, (0.5, -0.5))
    for name in ("get_min_bound", "get_max_bound", "get_center"):
        np.testing.assert_array_equal(getattr(t, name)(), getattr(j, name)())
    for m in (j, t):
        m.translate((1.0, 2.0))
        m.scale(2.0)
    np.testing.assert_array_equal(t.origin, j.origin)
    assert t.cell_size == j.cell_size and repr(t) == repr(j)
    assert not t.is_empty() and TMap2D(device=CPU).is_empty()
    with pytest.raises(RuntimeError):
        t.rotate(np.eye(2))
