"""Camera models: pinhole intrinsics + k4a (Brown–Conrady) distortion.

Replaces the reference's three intrinsics sources:
- live k4a calibration matrix probing with a width*1.03 fallback
  (reference CodeThatWorks/Visualizer-base.py:99-112,
  CodeThatWorks/1camera-detectsSceneChanges.py:98-118)
- PrimeSense defaults (reference CodeThatKindaWorks/Depth2PC.py:70-84,
  azure-kinect-DK/Reconstruction/Visualizer-blue.py:53-55)
- hard-coded Azure Kinect 720p color intrinsics
  (reference CodeThatWorks/GoodColorReconstruction.py:33-37)

Everything is a frozen pytree-friendly dataclass of plain floats so that
intrinsics may be closed over by jit or passed as traced values.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )

    def scaled(self, factor: float) -> "Intrinsics":
        """Intrinsics for an image resized by ``factor`` (pyramid levels).

        Uses the pixel-center convention: cx' = (cx + 0.5) * f - 0.5.
        """
        return Intrinsics(
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=(self.cx + 0.5) * factor - 0.5,
            cy=(self.cy + 0.5) * factor - 0.5,
        )

    @staticmethod
    def azure_kinect_depth_nfov() -> "Intrinsics":
        """Nominal NFOV_UNBINNED 640x576 depth intrinsics (typical factory cal)."""
        return Intrinsics(640, 576, 504.0, 504.2, 321.9, 333.1)

    @staticmethod
    def azure_kinect_color_720p() -> "Intrinsics":
        """The reference's hard-coded 720p color intrinsics
        (GoodColorReconstruction.py:33-37)."""
        return Intrinsics(1280, 720, 605.286, 605.699, 637.134, 366.758)

    @staticmethod
    def primesense_default() -> "Intrinsics":
        """Open3D PrimeSenseDefault, used by several reference scripts
        (Depth2PC.py:70-84)."""
        return Intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5)

    @staticmethod
    def fallback_from_size(width: int, height: int) -> "Intrinsics":
        """The reference's last-resort guess: fx = fy = width * 1.03
        (Visualizer-base.py:99-112)."""
        f = width * 1.03
        return Intrinsics(width, height, f, f, width / 2.0, height / 2.0)


@dataclasses.dataclass(frozen=True)
class Distortion:
    """Brown–Conrady rational model, the k4a calibration parameterization:
    x' = x * (1 + k1 r2 + k2 r4 + k3 r6) / (1 + k4 r2 + k5 r4 + k6 r6) + tangential.
    All-zero means an ideal pinhole.
    """

    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    k6: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def is_zero(self) -> bool:
        return all(
            getattr(self, f) == 0.0 for f in ("k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2")
        )

    def distort(self, xn, yn):
        """Apply distortion to normalized camera coords (jit-safe)."""
        r2 = xn * xn + yn * yn
        r4 = r2 * r2
        r6 = r4 * r2
        num = 1.0 + self.k1 * r2 + self.k2 * r4 + self.k3 * r6
        den = 1.0 + self.k4 * r2 + self.k5 * r4 + self.k6 * r6
        radial = num / den
        xd = xn * radial + 2.0 * self.p1 * xn * yn + self.p2 * (r2 + 2.0 * xn * xn)
        yd = yn * radial + self.p1 * (r2 + 2.0 * yn * yn) + 2.0 * self.p2 * xn * yn
        return xd, yd

    def undistort(self, xd, yd, iters: int = 8):
        """Invert the model by fixed-point iteration (jit-safe, fixed iters)."""
        xn, yn = xd, yd
        for _ in range(iters):
            r2 = xn * xn + yn * yn
            r4 = r2 * r2
            r6 = r4 * r2
            num = 1.0 + self.k1 * r2 + self.k2 * r4 + self.k3 * r6
            den = 1.0 + self.k4 * r2 + self.k5 * r4 + self.k6 * r6
            radial = num / den
            dx = 2.0 * self.p1 * xn * yn + self.p2 * (r2 + 2.0 * xn * xn)
            dy = self.p1 * (r2 + 2.0 * yn * yn) + 2.0 * self.p2 * xn * yn
            xn = (xd - dx) / radial
            yn = (yd - dy) / radial
        return xn, yn


@dataclasses.dataclass(frozen=True)
class CameraCalibration:
    """Full per-device calibration: depth + color cameras and their extrinsic.

    ``T_color_depth`` maps depth-camera coordinates into color-camera
    coordinates (the role k4a's transformation engine plays for
    ``capture.transformed_depth`` — reference CreateMesh.py:151-163 consumes
    the SDK's output; here we compute the reprojection ourselves in
    :mod:`..ops.depth_to_color`).
    """

    depth: Intrinsics
    color: Intrinsics
    depth_distortion: Distortion = Distortion()
    color_distortion: Distortion = Distortion()
    T_color_depth: Optional[Tuple[Tuple[float, ...], ...]] = None  # 4x4 row tuples
    serial: str = ""

    @property
    def color_from_depth(self) -> np.ndarray:
        if self.T_color_depth is None:
            return np.eye(4)
        return np.array(self.T_color_depth, dtype=np.float64)

    @staticmethod
    def azure_kinect_nominal(serial: str = "") -> "CameraCalibration":
        # ~32 mm baseline between depth and color sensors on the Kinect DK,
        # expressed as a pure translation for the nominal (zero-distortion) model.
        T = np.eye(4)
        T[0, 3] = -0.032
        return CameraCalibration(
            depth=Intrinsics.azure_kinect_depth_nfov(),
            color=Intrinsics.azure_kinect_color_720p(),
            T_color_depth=tuple(map(tuple, T.tolist())),
            serial=serial,
        )

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "CameraCalibration":
        d = json.loads(s)
        return CameraCalibration(
            depth=Intrinsics(**d["depth"]),
            color=Intrinsics(**d["color"]),
            depth_distortion=Distortion(**d.get("depth_distortion", {})),
            color_distortion=Distortion(**d.get("color_distortion", {})),
            T_color_depth=(
                tuple(map(tuple, d["T_color_depth"])) if d.get("T_color_depth") else None
            ),
            serial=d.get("serial", ""),
        )


def pixel_rays(intr: Intrinsics, distortion: Optional[Distortion] = None, dtype=jnp.float32):
    """Precompute the per-pixel unit-z ray table (H, W, 2) = (x/z, y/z).

    For a distorted camera this is the undistortion LUT: each *observed* pixel
    maps to the normalized ray that produced it. Computed once per session and
    reused by every backprojection — the device-side equivalent of the k4a SDK's
    internal undistortion tables.
    """
    u = jnp.arange(intr.width, dtype=dtype)
    v = jnp.arange(intr.height, dtype=dtype)
    xd = (u[None, :] - intr.cx) / intr.fx
    yd = (v[:, None] - intr.cy) / intr.fy
    xd, yd = jnp.broadcast_to(xd, (intr.height, intr.width)), jnp.broadcast_to(
        yd, (intr.height, intr.width)
    )
    if distortion is not None and not distortion.is_zero():
        xn, yn = distortion.undistort(xd, yd)
    else:
        xn, yn = xd, yd
    return jnp.stack([xn, yn], axis=-1)
