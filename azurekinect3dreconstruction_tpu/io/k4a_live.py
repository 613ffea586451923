"""Optional live Azure Kinect capture via pyk4a (gated import).

Covers the reference's device layer: NFOV_UNBINNED config with synchronized
color/depth (reference CreateMesh.py:85-89), the init fallback ladder across
pyk4a API variants (:91-106), device enumeration by index/serial
(InitialReconstruction-CUDA-2cam:139-170), calibration-matrix probing with
the width*1.03 fallback (Visualizer-base.py:99-112), and BGRA->RGB +
``transformed_depth`` consumption (GoodColorReconstruction.py:127-128,151-160).

Everything degrades cleanly when pyk4a is not installed (the normal state in
CI/GPU hosts): ``is_available()`` is False and the replay/synthetic sources
serve every pipeline instead.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu.core.camera import CameraCalibration, Intrinsics
from azurekinect3dreconstruction_tpu.io.replay import FrameSource
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info, log_warning


def _pyk4a():
    try:
        import pyk4a  # noqa

        return pyk4a
    except ImportError:
        return None


def is_available() -> bool:
    return _pyk4a() is not None


def detect_cameras(max_devices: int = 2) -> List[int]:
    """Probe device ids by open/close (reference CreateMesh.py:504-559)."""
    k4a = _pyk4a()
    if k4a is None:
        return []
    found = []
    for device_id in range(max_devices):
        try:
            dev = k4a.PyK4A(device_id=device_id)
            dev.start()
            dev.stop()
            found.append(device_id)
        except Exception:
            break
    log_info(f"detected {len(found)} Azure Kinect device(s)")
    return found


def rig_serials(max_devices: int = 2) -> List[str]:
    """Serial numbers of the attached rig, in device-id order — used to
    validate saved rig calibrations (reference serial check
    InitialReconstruction-CUDA-2cam:542-623)."""
    k4a = _pyk4a()
    serials = []
    if k4a is None:
        return serials
    for device_id in detect_cameras(max_devices):
        try:
            dev = k4a.PyK4A(device_id=device_id)
            dev.start()
            serials.append(getattr(dev, "serial", "") or "")
            dev.stop()
        except Exception:
            serials.append("")
    return serials


class K4ALiveSource(FrameSource):
    """Live frames as (transformed_depth_u16, rgb_u8) aligned to color."""

    def __init__(self, device_id: int = 0, color_resolution: str = "RES_720P",
                 depth_mode: str = "NFOV_UNBINNED", fps: str = "FPS_30"):
        k4a = _pyk4a()
        if k4a is None:
            raise RuntimeError(
                "pyk4a is not installed — use NpzReplaySource or SyntheticSource")
        config = None
        # init fallback ladder across pyk4a API variants (CreateMesh.py:91-106)
        for attempt in range(3):
            try:
                if attempt == 0:
                    config = k4a.Config(
                        color_resolution=getattr(k4a.ColorResolution, color_resolution),
                        depth_mode=getattr(k4a.DepthMode, depth_mode),
                        camera_fps=getattr(k4a.FPS, fps),
                        synchronized_images_only=True,
                    )
                elif attempt == 1:
                    config = k4a.Config(
                        color_resolution=getattr(k4a.ColorResolution, color_resolution),
                        depth_mode=getattr(k4a.DepthMode, depth_mode),
                        synchronized_images_only=True,
                    )
                else:
                    config = k4a.Config()
                self.device = k4a.PyK4A(config=config, device_id=device_id)
                self.device.start()
                break
            except Exception as e:
                log_warning(f"k4a init attempt {attempt} failed: {e}")
                if attempt == 2:
                    raise
        self.device_id = device_id
        self.serial = getattr(self.device, "serial", "") or ""
        self.calibration = self._probe_calibration()

    def _probe_calibration(self) -> CameraCalibration:
        """Calibration probing with nominal fallback (Visualizer-base.py:99-112)."""
        try:
            cal = self.device.calibration
            m = np.asarray(cal.get_camera_matrix(1))  # color camera
            color = Intrinsics(1280, 720, float(m[0, 0]), float(m[1, 1]),
                               float(m[0, 2]), float(m[1, 2]))
            md = np.asarray(cal.get_camera_matrix(0))  # depth camera
            depth = Intrinsics(640, 576, float(md[0, 0]), float(md[1, 1]),
                               float(md[0, 2]), float(md[1, 2]))
            return CameraCalibration(depth=depth, color=color, serial=self.serial)
        except Exception:
            log_warning("calibration probe failed; using nominal k4a model "
                        "(fx = width * 1.03 fallback)")
            nominal = CameraCalibration.azure_kinect_nominal(self.serial)
            fb = Intrinsics.fallback_from_size(1280, 720)
            return CameraCalibration(depth=nominal.depth, color=fb,
                                     serial=self.serial)

    def capture(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        cap = self.device.get_capture()
        if cap.color is None or cap.transformed_depth is None:
            return None
        color = np.asarray(cap.color)
        if color.ndim == 3 and color.shape[2] == 4:
            color = color[..., 2::-1]  # BGRA -> RGB
        return np.asarray(cap.transformed_depth), color

    def frames(self):
        while True:
            f = self.capture()
            if f is not None:
                yield f

    def stop(self) -> None:
        try:
            self.device.stop()
        except Exception:
            pass
