"""Visualization (cupoch src/cupoch/visualization/): colour maps on the
geometry's device; render and view options, view trajectories, the
navigable HTML export and an offscreen matplotlib renderer on the host,
fed by one device-to-host copy of each geometry. matplotlib is imported
only by a render."""
from .color_map import (
    ColorMapOption,
    get_color_map_color,
    get_global_color_map_option,
    set_global_color_map_option,
)
from .render_option import (
    MeshColorOption,
    MeshShadeOption,
    PointColorOption,
    RenderOption,
    ViewControl,
)
from .view_trajectory import (
    ViewParameters,
    ViewTrajectory,
    read_view_trajectory,
    write_view_trajectory,
)
from .html_viewer import export_html_viewer
from .visualizer import Visualizer, draw_geometries

__all__ = [
    "ViewParameters",
    "ViewTrajectory",
    "read_view_trajectory",
    "write_view_trajectory",
    "ColorMapOption",
    "get_color_map_color",
    "get_global_color_map_option",
    "set_global_color_map_option",
    "RenderOption",
    "ViewControl",
    "PointColorOption",
    "MeshShadeOption",
    "MeshColorOption",
    "Visualizer",
    "draw_geometries",
    "export_html_viewer",
]
