"""The port's visualization package (cupoch_tpu_torch.visualization)
against the JAX package's on the CPU: the colour maps, ViewControl's
camera math, view trajectories, JSON round trips, the HTML export, the
offscreen renderer, and the package without matplotlib."""
import base64
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_bridge as bridge
from cupoch_tpu import visualization as jvis
from cupoch_tpu.geometry import LineSet as JLineSet
from cupoch_tpu.geometry import PointCloud as JPointCloud
from cupoch_tpu.geometry.trianglemesh_factory import create_box as jbox
from cupoch_tpu_torch import io as tio
from cupoch_tpu_torch import visualization as tvis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_TOL = 1e-6
VIEW_TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(seed=0):
    """Seeded values in [-0.2, 1.2] and the maps' break points."""
    v = np.random.default_rng(seed).uniform(-0.2, 1.2, (7, 13))
    v.flat[:6] = [0.0, 1 / 3, 2 / 3, 1.0, 0.25, 0.75]
    return v.astype(np.float32)


@pytest.mark.parametrize("option", list(tvis.ColorMapOption))
def test_torch_color_map_matches_jax(option):
    v = _values()
    want = np.asarray(jvis.get_color_map_color(jnp.asarray(v), option))
    for got in (tvis.get_color_map_color(v, option, device="cpu"),
                tvis.get_color_map_color(torch.from_numpy(v), option)):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert got.shape == (7, 13, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MAP_TOL)


def test_torch_global_color_map_option():
    v = _values(1)
    assert tvis.get_global_color_map_option() == tvis.ColorMapOption.Jet
    try:
        tvis.set_global_color_map_option(tvis.ColorMapOption.Hot)
        jvis.set_global_color_map_option(jvis.ColorMapOption.Hot)
        assert tvis.get_global_color_map_option() == tvis.ColorMapOption.Hot
        np.testing.assert_allclose(
            tvis.get_color_map_color(v, device="cpu").numpy(),
            np.asarray(jvis.get_color_map_color(jnp.asarray(v))),
            rtol=0, atol=MAP_TOL)
    finally:
        tvis.set_global_color_map_option(tvis.ColorMapOption.Jet)
        jvis.set_global_color_map_option(jvis.ColorMapOption.Jet)


def _scene(seed=3):
    """(JAX cloud, mesh and line set; the port's, on the CPU)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 2.0, (400, 3)).astype(np.float32)
    cols = rng.uniform(-0.3, 1.3, (400, 3)).astype(np.float32)
    jpc = JPointCloud(pts)
    jpc.colors = cols
    jm = jbox(1.0, 2.0, 0.5)
    ls_pts = rng.uniform(size=(6, 3)).astype(np.float32)
    jls = JLineSet(ls_pts, np.asarray([[0, 1], [1, 2], [3, 5]], np.int32))
    return (jpc, jm, jls), (bridge.cloud(jpc), bridge.mesh(jm),
                            bridge.line_set(jls))


def _drive(vc, geoms):
    """The same sequence of operations on either package's ViewControl;
    returns the extrinsic of each pinhole conversion."""
    vc.fit_in_geometry(*geoms)
    vc.change_window_size(640, 480)
    exts = []
    for step in ((120.0, -45.0), (-30.0, 80.0)):
        vc.rotate(*step)
        vc.scale(3.0)
        vc.translate(50.0, -30.0)
        vc.roll(100.0)
        vc.change_field_of_view(-1.0)
        p = vc.convert_to_pinhole_camera_parameters()
        exts.append(np.asarray(p.extrinsic, np.float64))
        assert vc.convert_from_pinhole_camera_parameters(p)
    return exts


def test_torch_view_control_matches_jax():
    jg, tg = _scene()
    jvc, tvc = jvis.ViewControl(), tvis.ViewControl()
    jext = _drive(jvc, jg[:2])
    text = _drive(tvc, tg[:2])
    pts = np.concatenate([tg[0].points.numpy(), tg[1].vertices.numpy()])
    np.testing.assert_array_equal(tvc.bounding_box_min, pts.min(0))
    np.testing.assert_array_equal(tvc.bounding_box_max, pts.max(0))
    for a, b in zip(text, jext):
        np.testing.assert_allclose(a, b, rtol=0, atol=VIEW_TOL)
    td, jd = tvc.to_dict(), jvc.to_dict()
    assert td.keys() == jd.keys()
    assert td.pop("class_name") == jd.pop("class_name") == "ViewControl"
    for k in td:
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=VIEW_TOL)
    for name in ("eye", "right", "distance", "view_ratio"):
        np.testing.assert_allclose(getattr(tvc, name), getattr(jvc, name),
                                   rtol=0, atol=VIEW_TOL)


def _trajectory(vis, loop):
    traj = vis.ViewTrajectory()
    traj.is_loop = loop
    traj.interval = 5
    for k, frac in enumerate((0.0, 0.4, 0.9, 1.3)):
        s = vis.ViewParameters()
        s.front = np.asarray([np.sin(frac), 0.2 * k, np.cos(frac)])
        s.lookat = np.full(3, 0.5 + 0.1 * k)
        s.zoom = 0.5 + 0.05 * k
        s.boundingbox_max = np.ones(3) * (1 + k)
        traj.view_status.append(s)
    return traj


@pytest.mark.parametrize("loop", [False, True])
def test_torch_view_trajectory_matches_jax(loop, tmp_path):
    tt, jt = _trajectory(tvis, loop), _trajectory(jvis, loop)
    n = tt.num_of_frames()
    assert n == jt.num_of_frames() == (24 if loop else 19)
    for k in range(n + 1):
        (tok, ts), (jok, js) = (tt.get_interpolated_frame(k),
                                jt.get_interpolated_frame(k))
        assert tok == jok == (k < n)
        np.testing.assert_allclose(ts.convert_to_vector17(),
                                   js.convert_to_vector17(), rtol=0,
                                   atol=VIEW_TOL)
    path = str(tmp_path / "traj.json")
    assert tvis.write_view_trajectory(path, tt)
    for back in (tvis.read_view_trajectory(path),
                 jvis.read_view_trajectory(path)):
        assert back.to_json_dict() == tt.to_json_dict()
    # a frame through both packages' ViewControl
    tvc, jvc = tvis.ViewControl(), jvis.ViewControl()
    tvc.convert_from_view_parameters(tt.get_interpolated_frame(7)[1])
    jvc.convert_from_view_parameters(jt.get_interpolated_frame(7)[1])
    np.testing.assert_allclose(
        tvc.convert_to_view_parameters().convert_to_vector17(),
        jvc.convert_to_view_parameters().convert_to_vector17(), rtol=0,
        atol=VIEW_TOL)


def test_torch_render_option_json_roundtrip(tmp_path):
    opt = tvis.RenderOption()
    opt.point_size = 9.0
    opt.background_color = np.asarray([0.1, 0.2, 0.3], np.float32)
    opt.point_color_option = tvis.PointColorOption.ZCoordinate
    opt.mesh_show_wireframe = True
    path = str(tmp_path / "render.json")
    assert tio.write_ijson_convertible_to_json(path, opt)
    back = tio.read_ijson_convertible_from_json(path, tvis.RenderOption)
    jback = jvis.RenderOption.from_dict(json.load(open(path)))
    assert back.to_dict() == jback.to_dict() == opt.to_dict()


def _scene_of(html: str) -> dict:
    m = re.search(r"const SCENE = (\{.*?\});\n", html, re.S)
    assert m, "SCENE literal not found"
    return json.loads(m.group(1))


def _decoded(g: dict) -> dict:
    out = {"mode": g["mode"]}
    for k, dt in (("points", np.float32), ("colors", np.float32),
                  ("lines", np.uint32)):
        if k in g:
            out[k] = np.frombuffer(base64.b64decode(g[k]), dt)
    return out


def test_torch_html_export_matches_jax(tmp_path):
    jg, tg = _scene()
    jpath, tpath = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    assert jvis.export_html_viewer(list(jg), jpath)
    assert tvis.draw_geometries(list(tg), filename=tpath)
    thtml = open(tpath).read()
    tscene, jscene = _scene_of(thtml), _scene_of(open(jpath).read())
    assert len(tscene["geoms"]) == len(jscene["geoms"]) == 3
    for tgeo, jgeo in zip(tscene["geoms"], jscene["geoms"]):
        a, b = _decoded(tgeo), _decoded(jgeo)
        assert a.keys() == b.keys()
        for k in a:
            if k == "mode":
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k].view(np.uint32),
                                              b[k].view(np.uint32))
    cols = _decoded(tscene["geoms"][0])["colors"].reshape(-1, 3)
    np.testing.assert_array_equal(cols, np.clip(tg[0].colors.numpy(), 0, 1))
    assert tscene["background"] == jscene["background"]
    assert tscene["point_size"] == jscene["point_size"]
    # the CSS fills the window: no %-escapes left in it
    assert "height:100%;" in thtml and "width:100%;" in thtml
    assert "100%%" not in thtml
    assert "http://" not in thtml and "https://" not in thtml


def test_torch_html_export_grids_match_jax(tmp_path):
    """Voxel grids export their voxel centres and colours, occupancy
    grids their occupied voxels' centres, as the JAX package's do."""
    from cupoch_tpu.geometry import OccupancyGrid as JOcc
    from cupoch_tpu.geometry import VoxelGrid as JVG

    jg, _ = _scene(7)
    jvg = JVG.create_from_point_cloud(jg[0], 0.25)
    jocc = JOcc(0.1, 32)
    rng = np.random.default_rng(8)
    jocc.insert(rng.uniform(-1.0, 1.0, (500, 3)).astype(np.float32),
                np.zeros(3, np.float32))
    tg = [bridge.voxel_grid(jvg), bridge.occupancy_grid(jocc)]
    jpath, tpath = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    assert jvis.export_html_viewer([jvg, jocc], jpath)
    assert tvis.export_html_viewer(tg, tpath)
    tscene = _scene_of(open(tpath).read())["geoms"]
    jscene = _scene_of(open(jpath).read())["geoms"]
    assert len(tscene) == len(jscene) == 2
    for tgeo, jgeo in zip(tscene, jscene):
        a, b = _decoded(tgeo), _decoded(jgeo)
        assert a.keys() == b.keys() and a["points"].size > 0
        for k in ("points", "colors"):
            if k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)


def test_torch_html_export_subsamples_as_jax(tmp_path):
    jg, tg = _scene(5)
    jpath, tpath = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    assert jvis.export_html_viewer([jg[0], jg[1]], jpath, max_points=100)
    assert tvis.export_html_viewer([tg[0], tg[1]], tpath, max_points=100)
    for tgeo, jgeo in zip(_scene_of(open(tpath).read())["geoms"],
                          _scene_of(open(jpath).read())["geoms"]):
        a, b = _decoded(tgeo), _decoded(jgeo)
        assert a.keys() == b.keys()
        for k in ("points", "colors"):
            if k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_torch_draw_geometries_png(tmp_path):
    pytest.importorskip("matplotlib")
    _, (pc, mesh, ls) = _scene()
    out = str(tmp_path / "scene.png")
    assert tvis.draw_geometries([pc, mesh, ls], filename=out,
                                width=320, height=240)
    assert os.path.getsize(out) > 1000
    vis = tvis.Visualizer()
    assert vis.create_window("w", 320, 240)
    vis.add_geometry(pc)
    cap = str(tmp_path / "cap.png")
    assert vis.capture_screen_image(cap)
    assert os.path.getsize(cap) > 1000
    vis.destroy_window()


def test_torch_trajectory_playback_writes_frames(tmp_path):
    pytest.importorskip("matplotlib")
    _, (pc, mesh, _) = _scene()
    traj = tvis.ViewTrajectory()
    traj.interval = 1
    for frac in (0.0, 0.5, 1.0):
        s = tvis.ViewParameters()
        s.front = np.asarray([np.sin(frac), 0.2, np.cos(frac)])
        s.lookat = np.full(3, 0.5)
        s.boundingbox_max = np.ones(3)
        traj.view_status.append(s)
    pattern = str(tmp_path / "frame_%05d.png")
    assert tvis.draw_geometries([pc, mesh], filename=pattern,
                                trajectory=traj, width=160, height=120)
    frames = sorted(os.listdir(tmp_path))
    assert frames == [f"frame_{k:05d}.png" for k in range(5)]


def test_torch_visualization_without_matplotlib(tmp_path):
    """With matplotlib unimportable the package imports, the HTML export
    works, and a PNG render raises a RuntimeError that names it."""
    code = f"""
import sys
sys.modules["matplotlib"] = None
import numpy as np
import cupoch_tpu_torch as ctt
pc = ctt.geometry.PointCloud(np.random.default_rng(0).uniform(
    size=(100, 3)).astype(np.float32), device="cpu")
vis = ctt.visualization
assert vis.export_html_viewer([pc], {str(tmp_path / "a.html")!r})
try:
    vis.draw_geometries([pc], filename={str(tmp_path / "a.png")!r})
except RuntimeError as e:
    assert "matplotlib" in str(e), e
else:
    raise SystemExit("a PNG render without matplotlib did not raise")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stdout + out.stderr
    assert os.path.getsize(tmp_path / "a.html") > 1000
    assert not (tmp_path / "a.png").exists()
