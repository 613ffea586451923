"""Open3D visualization bridge (host-side, optional).

Keeps viz where SURVEY.md §2.2 puts it: behind the script-level API, with
Open3D's GLFW viewer when installed and a headless no-op fallback otherwise
(so every pipeline runs in CI / on display-less GPU hosts).

Covers the reference's viewer surface: ``VisualizerWithKeyCallback`` with the
full key map — S save, R reset/recalibrate, C color-mode/clear, M mesh
toggle, V view, T TSDF toggle, O originals, U update, =/- and [/] live
depth-scale/trunc tuning, 1 reset view (reference CreateMesh.py:394-502,
:572-579; BetterVisualizer2CamWorksTOGGLE.py:450-505) — plus persistent
in-place geometry updates (first-add vs update, CreateMesh.py:723-833) and
window-close detection (Visualizer-base.py:141-148).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from azurekinect3dreconstruction_tpu.core.types import PointCloudHost, TriangleMeshHost
from azurekinect3dreconstruction_tpu.core.se3 import FLIP_TRANSFORM
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info, log_warning


def _o3d():
    try:
        import open3d as o3d  # noqa

        return o3d
    except ImportError:
        return None


def is_available() -> bool:
    return _o3d() is not None


class LiveViewer:
    """Persistent-geometry live viewer with keyboard callbacks.

    ``register_key(char, fn)`` binds callbacks; ``update_cloud``/
    ``update_mesh`` add or update geometry in place (no per-frame
    clear_geometries flicker — the fix the reference evolved toward in
    ROTATEsave2); ``tick()`` polls events and returns False when the window
    closes. Headless (no Open3D): callbacks still registerable + invokable
    programmatically, updates are no-ops, ``tick`` returns True.
    """

    def __init__(self, window_name: str = "kinect-recon", width: int = 1280,
                 height: int = 720, flip_display: bool = True):
        self._o3d = _o3d()
        self._callbacks: Dict[str, Callable] = {}
        self._geoms: Dict[str, object] = {}
        self.flip_display = flip_display
        self.headless = self._o3d is None
        if self.headless:
            log_warning("open3d not installed; running headless (no window)")
            self.vis = None
            return
        self.vis = self._o3d.visualization.VisualizerWithKeyCallback()
        self.vis.create_window(window_name=window_name, width=width, height=height)
        opt = self.vis.get_render_option()
        opt.point_size = 2.0
        opt.background_color = np.array([0.05, 0.05, 0.08])

    # -- keys ---------------------------------------------------------------
    def register_key(self, char: str, fn: Callable[[], None],
                     description: str = "") -> None:
        self._callbacks[char.upper()] = fn
        if self.vis is not None:
            self.vis.register_key_callback(ord(char.upper()), lambda v: (fn(), False)[1])
        if description:
            log_info(f"key [{char.upper()}]: {description}")

    def press(self, char: str) -> None:
        """Programmatic key press (testing + remote control)."""
        fn = self._callbacks.get(char.upper())
        if fn:
            fn()

    # -- geometry -----------------------------------------------------------
    def _display_transform(self, pts: np.ndarray) -> np.ndarray:
        if not self.flip_display:
            return pts
        return pts @ FLIP_TRANSFORM[:3, :3].T

    def update_cloud(self, name: str, cloud: PointCloudHost) -> None:
        if self.vis is None:
            return
        o3d = self._o3d
        pts = self._display_transform(np.asarray(cloud.points, np.float64))
        if name in self._geoms:
            g = self._geoms[name]
            g.points = o3d.utility.Vector3dVector(pts)
            if cloud.colors is not None:
                g.colors = o3d.utility.Vector3dVector(cloud.colors.astype(np.float64))
            self.vis.update_geometry(g)
        else:
            g = o3d.geometry.PointCloud()
            g.points = o3d.utility.Vector3dVector(pts)
            if cloud.colors is not None:
                g.colors = o3d.utility.Vector3dVector(cloud.colors.astype(np.float64))
            self._geoms[name] = g
            self.vis.add_geometry(g)

    def update_mesh(self, name: str, mesh: TriangleMeshHost) -> None:
        if self.vis is None:
            return
        o3d = self._o3d
        v = self._display_transform(np.asarray(mesh.vertices, np.float64))
        if name in self._geoms:
            g = self._geoms[name]
            g.vertices = o3d.utility.Vector3dVector(v)
            g.triangles = o3d.utility.Vector3iVector(mesh.triangles.astype(np.int64))
        else:
            g = o3d.geometry.TriangleMesh()
            g.vertices = o3d.utility.Vector3dVector(v)
            g.triangles = o3d.utility.Vector3iVector(mesh.triangles.astype(np.int64))
            self._geoms[name] = g
            self.vis.add_geometry(g)
        if mesh.vertex_colors is not None:
            self._geoms[name].vertex_colors = o3d.utility.Vector3dVector(
                mesh.vertex_colors.astype(np.float64))
        self._geoms[name].compute_vertex_normals()
        self.vis.update_geometry(self._geoms[name])

    def remove(self, name: str) -> None:
        if self.vis is not None and name in self._geoms:
            self.vis.remove_geometry(self._geoms.pop(name))
        else:
            self._geoms.pop(name, None)

    def reset_view(self) -> None:
        if self.vis is not None:
            self.vis.reset_view_point(True)

    def tick(self) -> bool:
        """Poll events + render. False => window closed (stop the loop)."""
        if self.vis is None:
            return True
        alive = self.vis.poll_events()
        self.vis.update_renderer()
        return bool(alive)

    def close(self) -> None:
        if self.vis is not None:
            self.vis.destroy_window()
            self.vis = None


def view_geometry(path: str) -> bool:
    """One-shot viewer for a saved .ply/.obj (offline browsers)."""
    o3d = _o3d()
    if o3d is None:
        log_warning(f"open3d not installed; cannot display {path}")
        return False
    if path.endswith(".obj") or "mesh" in path:
        geom = o3d.io.read_triangle_mesh(path)
        geom.compute_vertex_normals()
    else:
        geom = o3d.io.read_point_cloud(path)
    o3d.visualization.draw_geometries([geom])
    return True
