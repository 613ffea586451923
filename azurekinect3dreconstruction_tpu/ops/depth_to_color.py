"""Depth -> color-camera registration (the k4a ``transformed_depth`` op).

The reference consumes ``capture.transformed_depth`` everywhere
(CreateMesh.py:151-163, GoodColorReconstruction.py:151-160) — the Azure
Kinect SDK computes it natively on the host. This is the device-native
equivalent: backproject the depth image through the depth camera's (possibly
distorted) ray table, transform into the color camera with the calibration
extrinsic, project with the color intrinsics, and z-buffer with a scatter-min
(nearest surface wins, exactly the SDK's occlusion semantics).

Forward splatting leaves sub-pixel holes where the color image is denser than
the depth image; ``fill_holes=1`` closes single-pixel gaps with a 3x3
neighborhood minimum (valid neighbors only), mirroring the SDK's interpolated
mode closely enough for 640x576 -> 1280x720.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from azurekinect3dreconstruction_tpu.core.camera import CameraCalibration, Intrinsics
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.ops.backproject import backproject_depth

_INF = 1e9


@partial(jax.jit, static_argnames=("calib", "fill_holes", "splat"))
def transformed_depth(depth, rays, calib: CameraCalibration,
                      fill_holes: int = 1, splat: int = 1):
    """(Hd, Wd) depth [m] -> (Hc, Wc) depth [m] seen from the color camera.

    rays: depth-camera ray table from core.camera.pixel_rays (undistortion
    included when the calibration has distortion). ``splat`` widens each
    depth sample to a splat x splat pixel footprint in the color image
    (forward-warp coverage), ``fill_holes`` applies that many 3x3 min-fill
    passes afterwards.
    """
    ci = calib.color
    T = jnp.asarray(calib.color_from_depth, jnp.float32)
    pts = backproject_depth(jnp.asarray(depth), rays)  # (Hd, Wd, 3)
    flat = pts.reshape(-1, 3)
    valid = flat[:, 2] > 0
    p = se3.transform_points(T, flat)
    z = p[:, 2]
    zs = jnp.maximum(z, 1e-6)
    u = p[:, 0] / zs * ci.fx + ci.cx
    v = p[:, 1] / zs * ci.fy + ci.cy
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)

    out = jnp.full((ci.height * ci.width,), _INF, jnp.float32)
    for dy in range(splat):
        for dx in range(splat):
            uu = ui + dx
            vv = vi + dy
            ok = valid & (z > 0) & (uu >= 0) & (vv >= 0) & (uu < ci.width) & (vv < ci.height)
            idx = jnp.where(ok, vv * ci.width + uu, ci.height * ci.width)
            out = out.at[idx].min(jnp.where(ok, z, _INF), mode="drop")
    img = out.reshape(ci.height, ci.width)

    for _ in range(fill_holes):
        # 3x3 valid-neighbor minimum, applied only to holes
        pad = jnp.pad(img, 1, constant_values=_INF)
        neigh = jnp.stack([
            pad[i : i + ci.height, j : j + ci.width]
            for i in range(3) for j in range(3)
        ])
        nmin = jnp.min(neigh, axis=0)
        img = jnp.where(img >= _INF, nmin, img)

    return jnp.where(img >= _INF, 0.0, img)
