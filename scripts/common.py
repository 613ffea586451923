"""Shared CLI plumbing for the script-level entry points.

Every script accepts ``--source`` choosing the frame backend:
  synthetic            deterministic rendered scene (default; no hardware)
  replay:<dir>         npz frame-log replay (reference Depth2PC.py:224-303)
  mkv:<file>           k4arecorder .mkv replay (pyk4a-gated)
  k4a[:device_id]      live Azure Kinect via pyk4a (if installed)
so each reference workflow runs unchanged with or without a camera
(SURVEY.md §4: replay is the first-class headless backend).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
from typing import Iterator, Optional, Tuple

import numpy as np

# make the package importable whether scripts run from the repo root or from
# inside scripts/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu.io.replay import NpzReplaySource
from azurekinect3dreconstruction_tpu.io.synthetic import (
    SyntheticCamera,
    orbit_trajectory,
)
from azurekinect3dreconstruction_tpu.utils.telemetry import log_error, log_info


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--source", default="synthetic",
                    help="synthetic | replay:<dir> | mkv:<file> | k4a[:device_id]")
    ap.add_argument("--frames", type=int, default=60,
                    help="frame budget (synthetic/replay)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="intrinsics/image scale (e.g. 0.25 for quick runs)")
    ap.add_argument("--output", default="results", help="output directory")
    ap.add_argument("--headless", action="store_true",
                    help="never open a window")
    ap.add_argument("--serve", type=int, nargs="?", const=0, default=None,
                    metavar="PORT",
                    help="serve a live browser viewer on PORT (0 = ephemeral)"
                         " instead of an Open3D window; works headless")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU JAX backend instead of the GPU")


def apply_backend_overrides(args) -> None:
    """Honor --cpu before any jax computation runs (the platform is fixed at
    the first backend touch)."""
    if getattr(args, "cpu", False):
        import jax

        jax.config.update("jax_platforms", "cpu")


def make_source(args) -> Tuple[Iterator[Tuple[np.ndarray, np.ndarray]], Intrinsics]:
    """Returns (frame iterator, depth intrinsics)."""
    apply_backend_overrides(args)
    spec = args.source
    if spec == "synthetic":
        intr = Intrinsics.azure_kinect_depth_nfov().scaled(args.scale)
        cam = SyntheticCamera(intrinsics=intr)
        poses = orbit_trajectory(args.frames, radius=0.35, angle_span=1.0)
        # ground truth is knowable here and nowhere else — expose it so
        # scripts can save a gt_trajectory for eval_trajectory.py scoring
        args.gt_poses = [np.asarray(T, np.float64) for T in poses]
        it = (cam.capture(T) for T in poses)
        return it, intr
    if spec.startswith("replay:"):
        src = NpzReplaySource(spec.split(":", 1)[1], limit=args.frames or None)
        intr = (src.calibration.depth if src.calibration
                else Intrinsics.azure_kinect_depth_nfov())
        if args.scale != 1.0:
            log_info("--scale ignored for replay sources")
        return iter(src), intr
    if spec.startswith("mkv:"):
        from azurekinect3dreconstruction_tpu.io.mkv import MkvReplaySource

        src = MkvReplaySource(spec.split(":", 1)[1], limit=args.frames or None)
        intr = (src.calibration.color if src.calibration
                else Intrinsics.fallback_from_size(1280, 720))
        return iter(src), intr
    if spec.startswith("k4a"):
        from azurekinect3dreconstruction_tpu.io.k4a_live import K4ALiveSource

        device_id = int(spec.split(":")[1]) if ":" in spec else 0
        src = K4ALiveSource(device_id=device_id)
        intr = src.calibration.color  # frames are color-aligned
        it = itertools.islice(src.frames(), args.frames) if args.frames else src.frames()
        return it, intr
    log_error(f"unknown source {spec!r}")
    raise SystemExit(2)


def make_viewer(args, name: str):
    from azurekinect3dreconstruction_tpu.viz.o3d_bridge import LiveViewer, is_available

    if getattr(args, "serve", None) is not None:
        # live browser viewer: geometry + the reconstruction key map over
        # HTTP — the display-free live window (reference CreateMesh.py
        # run loop, but headless-capable)
        from azurekinect3dreconstruction_tpu.viz.live_server import (
            BrowserLiveViewer,
        )

        return BrowserLiveViewer(port=args.serve, window_name=name)
    if args.headless or not is_available():
        class _Null:
            headless = True

            def register_key(self, *a, **k):
                pass

            def press(self, *a):
                pass

            def update_cloud(self, *a):
                pass

            def update_mesh(self, *a):
                pass

            def tick(self):
                return True

            def close(self):
                pass

            def reset_view(self):
                pass

        return _Null()
    return LiveViewer(window_name=name)
