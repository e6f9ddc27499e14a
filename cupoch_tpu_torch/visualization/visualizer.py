"""Host-side visualizer (cupoch visualization/visualizer/visualizer.h:
113-142 and draw_geometry.cpp's DrawGeometries).

cupoch renders through CUDA-GL interop (simple_shader.cu:367-388). Here,
as in the JAX package, the API is kept (`Visualizer`, `draw_geometries`)
and the image is drawn on the host by matplotlib after one
device-to-host copy of each geometry's arrays. matplotlib is imported
only when a render needs it; without it a render raises a
`RuntimeError` that names it. `capture_screen_image` and the
`filename=` argument save PNGs; a `.html` filename writes the
navigable viewer of `html_viewer` instead, which needs no matplotlib.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utility import console
from .render_option import RenderOption, ViewControl


def _pyplot():
    """matplotlib's pyplot on the offscreen Agg backend; raises
    RuntimeError when matplotlib cannot be imported."""
    try:
        import matplotlib
    except ImportError:
        console.log_error("[Visualizer] matplotlib is not available "
                          "for host-side rendering.")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    return x.cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _geometry_arrays(g):
    """(points, colors or None, lines or None) host arrays of any
    supported geometry."""
    from ..geometry import (
        Graph,
        LineSet,
        OccupancyGrid,
        PointCloud,
        TriangleMesh,
        VoxelGrid,
    )

    if isinstance(g, PointCloud):
        cols = _host(g.colors) if g.has_colors() else None
        return _host(g.points), cols, None
    if isinstance(g, TriangleMesh):
        cols = g.vertex_colors if g.has_vertex_colors() \
            else g.sample_texture_vertex_colors()
        tris = _host(g.triangles)
        lines = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                tris[:, [2, 0]]]) if len(tris) else None
        return _host(g.vertices), _host(cols), lines
    if isinstance(g, (LineSet, Graph)):
        cols = _host(g.colors) if g.has_colors() else None
        return _host(g.points), cols, _host(g.lines)
    if isinstance(g, VoxelGrid):
        colors = _host(g.voxels_colors)
        return (_host(g.get_voxel_centers()),
                colors if colors.shape[0] else None, None)
    if isinstance(g, OccupancyGrid):
        from ..geometry.pointcloud_factory import create_from_occupancy_grid

        return _host(create_from_occupancy_grid(g).points), None, None
    # anything else with points
    pts = getattr(g, "points", None)
    if pts is not None:
        return _host(pts), None, None
    console.log_warning("[Visualizer] Unsupported geometry type %s",
                        type(g).__name__)
    return np.zeros((0, 3), np.float32), None, None


class Visualizer:
    """cupoch visualizer.h: add and update geometries, then render; the
    render loop is one host-side render."""

    def __init__(self):
        self._geometries: List[object] = []
        self.render_option = RenderOption()
        self.view_control = ViewControl()
        self._window_name = "cupoch_tpu_torch"
        self._fig = None

    def create_window(self, window_name: str = "cupoch_tpu_torch",
                      width: int = 1024, height: int = 768,
                      left: int = 50, top: int = 50,
                      visible: bool = True) -> bool:
        self._window_name = window_name
        self._size = (width, height)
        return True

    def destroy_window(self):
        if self._fig is not None:
            _pyplot().close(self._fig)
            self._fig = None

    def add_geometry(self, geometry) -> bool:
        self._geometries.append(geometry)
        return True

    def update_geometry(self, geometry=None) -> bool:
        return True  # the arrays are read again at render time

    def clear_geometries(self) -> bool:
        self._geometries = []
        return True

    def get_render_option(self) -> RenderOption:
        return self.render_option

    def get_view_control(self) -> ViewControl:
        return self.view_control

    def _render(self):
        plt = _pyplot()
        opt = self.render_option
        fig = plt.figure(
            figsize=(self._size[0] / 100, self._size[1] / 100)
            if hasattr(self, "_size") else (10, 7.5))
        ax = fig.add_subplot(111, projection="3d")
        ax.set_facecolor(tuple(opt.background_color))
        for g in self._geometries:
            pts, cols, lines = _geometry_arrays(g)
            if pts.shape[0] == 0:
                continue
            # a very large cloud is subsampled for the host plot
            if pts.shape[0] > 200000:
                sel = np.random.default_rng(0).choice(
                    pts.shape[0], 200000, replace=False)
                pts_p = pts[sel]
                cols_p = cols[sel] if cols is not None else None
            else:
                pts_p, cols_p = pts, cols
            ax.scatter(pts_p[:, 0], pts_p[:, 1], pts_p[:, 2],
                       s=opt.point_size * 0.2,
                       c=np.clip(cols_p, 0, 1) if cols_p is not None
                       else None)
            if lines is not None and len(lines):
                from mpl_toolkits.mplot3d.art3d import Line3DCollection

                segs = pts[np.asarray(lines)]  # [E, 2, 3], one batch
                ax.add_collection3d(Line3DCollection(
                    segs, linewidths=opt.line_width * 0.5))
        ax.set_box_aspect((1, 1, 1))
        self._fig = fig
        return fig

    def run(self):
        """Render once (cupoch's interactive loop needs a display;
        offscreen this draws the figure to capture)."""
        self._render()

    def poll_events(self) -> bool:
        return False  # headless: no event loop

    def update_renderer(self):
        pass

    def capture_screen_image(self, filename: str, do_render: bool = True
                             ) -> bool:
        if do_render or self._fig is None:
            self._render()
        self._fig.savefig(filename, dpi=100)
        return True


def _render_projected(geometries, view, width: int, height: int,
                      render_option: Optional[RenderOption] = None,
                      filename: Optional[str] = None):
    """Render through the ViewControl's pinhole camera: every point
    projected with cupoch's extrinsic and intrinsic
    (view_control.cpp:115-157) and drawn far to near, so the camera
    math, not matplotlib's axes, decides the image."""
    plt = _pyplot()
    opt = render_option or RenderOption()
    view.change_window_size(width, height)
    params = view.convert_to_pinhole_camera_parameters()
    if params is None:
        console.log_warning("[Visualizer] cannot render an orthogonal "
                            "view through the pinhole path.")
        return None
    K = np.asarray(params.intrinsic.intrinsic_matrix, np.float64)
    E = np.asarray(params.extrinsic, np.float64)
    fig = plt.figure(figsize=(width / 100, height / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_facecolor(tuple(opt.background_color))
    ax.set_xlim(0, width)
    ax.set_ylim(height, 0)
    ax.axis("off")
    for g in geometries:
        pts, cols, lines = _geometry_arrays(g)
        if pts.shape[0] == 0:
            continue
        if pts.shape[0] > 200000:
            sel = np.random.default_rng(0).choice(
                pts.shape[0], 200000, replace=False)
            pts = pts[sel]
            cols = cols[sel] if cols is not None else None
            lines = None
        cam = pts @ E[:3, :3].T + E[:3, 3]
        z = cam[:, 2]
        vis_m = z > 1e-6
        uv = (cam[:, :2] / np.maximum(z[:, None], 1e-6)) \
            * K[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]
        order = np.argsort(-z[vis_m])
        uvo = uv[vis_m][order]
        c = None
        if cols is not None:
            c = np.clip(cols[vis_m][order], 0, 1)
        ax.scatter(uvo[:, 0], uvo[:, 1], s=opt.point_size * 0.2, c=c)
        if lines is not None and len(lines):
            from matplotlib.collections import LineCollection

            both = vis_m[lines].all(-1)
            segs = uv[lines[both]]
            ax.add_collection(LineCollection(
                segs, linewidths=opt.line_width * 0.5))
    if filename is not None:
        fig.savefig(filename, dpi=100)
        plt.close(fig)
        return None
    return fig


def play_view_trajectory(geometry_list, trajectory,
                         filename_pattern: str = "frame_%05d.png",
                         width: int = 1024, height: int = 768,
                         render_option: Optional[RenderOption] = None
                         ) -> List[str]:
    """Trajectory playback: each interpolated camera frame
    (view_trajectory.cpp:110-126) rendered to a PNG through the pinhole
    path. Returns the paths written (any encoder can join them into a
    video)."""
    view = ViewControl()
    written: List[str] = []
    n = trajectory.num_of_frames()
    for k in range(n):
        ok, status = trajectory.get_interpolated_frame(k)
        if not ok:
            break
        view.convert_from_view_parameters(status)
        path = filename_pattern % k if "%" in filename_pattern \
            else filename_pattern
        _render_projected(geometry_list, view, width, height,
                          render_option, filename=path)
        written.append(path)
    return written


def draw_geometries(geometry_list, window_name: str = "cupoch_tpu_torch",
                    width: int = 1024, height: int = 768,
                    left: int = 50, top: int = 50,
                    filename: Optional[str] = None,
                    trajectory=None) -> bool:
    """cupoch DrawGeometries (draw_geometry.cpp) and
    DrawGeometriesWithCustomAnimation (camera trajectory playback).
    With `filename` one frame is written to disk (headless); with
    `trajectory` (a ViewTrajectory) a sequence of frames, `filename`
    being the %-pattern (default frame_%05d.png); a `.html` filename
    writes the navigable viewer."""
    if trajectory is not None:
        pattern = filename or "frame_%05d.png"
        return len(play_view_trajectory(
            geometry_list, trajectory, pattern, width, height)) > 0
    if filename is not None and filename.endswith(".html"):
        # the navigable single-file viewer (orbit, zoom and pan in any
        # browser, no network): the headless counterpart of cupoch's
        # GLFW window (visualizer.cpp:256-299)
        from .html_viewer import export_html_viewer

        return export_html_viewer(geometry_list, filename,
                                  window_name=window_name)
    vis = Visualizer()
    vis.create_window(window_name, width, height, left, top)
    for g in geometry_list:
        vis.add_geometry(g)
    if filename is not None:
        ok = vis.capture_screen_image(filename)
        vis.destroy_window()
        return ok
    vis.run()
    vis.destroy_window()
    return True
