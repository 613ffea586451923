"""Depth -> point-cloud backprojection (organized and flat forms).

Device-native replacement for Open3D's ``PointCloud.create_from_rgbd_image`` /
``create_from_depth_image`` (used at reference CreateMesh.py:584-594 and
CodeThatKindaWorks/Depth2PC.py:60-84). The whole op is a per-pixel FMA over a
precomputed ray table (:func:`..core.camera.pixel_rays`), which XLA fuses into
a single VPU pass; there is no gather/scatter so a handwritten kernel buys
nothing here — the fusion-friendly jnp form *is* the fast form.

Outputs keep the organized (H, W, ...) layout, which downstream consumers rely
on (projective ICP correspondence, image-space normals); ``flatten_organized``
converts to the fixed-capacity :class:`..core.types.PointCloud`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from azurekinect3dreconstruction_tpu.core.camera import Distortion, Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu.core.types import PointCloud


def backproject_depth(depth, rays):
    """Organized backprojection: (H, W) depth [m] x (H, W, 2) ray table ->
    (H, W, 3) camera-space points; invalid pixels (depth == 0) give (0,0,0)."""
    depth = jnp.asarray(depth)
    xy = rays * depth[..., None]
    return jnp.concatenate([xy, depth[..., None]], axis=-1)


def backproject_intrinsics(depth, intr: Intrinsics, distortion: Optional[Distortion] = None):
    """Convenience wrapper that builds the ray table on the fly."""
    return backproject_depth(depth, pixel_rays(intr, distortion, dtype=jnp.asarray(depth).dtype))


def project_points(points, intr: Intrinsics):
    """Camera-space (..., 3) points -> pixel coords (..., 2) + z (...,).

    The pinhole projection used by TSDF integration and projective ICP.
    """
    z = points[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    u = points[..., 0] / safe_z * intr.fx + intr.cx
    v = points[..., 1] / safe_z * intr.fy + intr.cy
    return jnp.stack([u, v], axis=-1), z


def flatten_organized(points, mask, colors=None, normals=None) -> PointCloud:
    """(H, W, 3) organized maps -> fixed-capacity flat PointCloud (N = H*W)."""
    h, w = points.shape[:2]
    flat = lambda a: None if a is None else a.reshape(h * w, -1)
    return PointCloud(
        points=flat(points),
        mask=mask.reshape(h * w),
        colors=flat(colors),
        normals=flat(normals),
    )


def bilinear_sample(img, uv, valid_fill=0.0):
    """Bilinear interpolation of (H, W) or (H, W, C) ``img`` at float pixel
    coords ``uv`` (..., 2). Returns (values, in_bounds_mask).

    Used by odometry/ICP warps; matches the edge semantics of Open3D's
    odometry sampling (out-of-bounds -> invalid, not clamped).
    """
    img = jnp.asarray(img)
    h, w = img.shape[:2]
    u, v = uv[..., 0], uv[..., 1]
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    du = u - u0
    dv = v - v0
    u0i = u0.astype(jnp.int32)
    v0i = v0.astype(jnp.int32)
    inb = (u0i >= 0) & (v0i >= 0) & (u0i < w - 1) & (v0i < h - 1)
    u0c = jnp.clip(u0i, 0, w - 2)
    v0c = jnp.clip(v0i, 0, h - 2)

    def gather(vi, ui):
        return img[vi, ui]

    c00 = gather(v0c, u0c)
    c01 = gather(v0c, u0c + 1)
    c10 = gather(v0c + 1, u0c)
    c11 = gather(v0c + 1, u0c + 1)
    if img.ndim == 3:
        du = du[..., None]
        dv = dv[..., None]
    val = (
        c00 * (1 - du) * (1 - dv)
        + c01 * du * (1 - dv)
        + c10 * (1 - du) * dv
        + c11 * du * dv
    )
    if img.ndim == 3:
        val = jnp.where(inb[..., None], val, valid_fill)
    else:
        val = jnp.where(inb, val, valid_fill)
    return val, inb


def nearest_sample(img, uv):
    """Nearest-neighbor sample (for depth, where bilinear blends edges)."""
    img = jnp.asarray(img)
    h, w = img.shape[:2]
    ui = jnp.round(uv[..., 0]).astype(jnp.int32)
    vi = jnp.round(uv[..., 1]).astype(jnp.int32)
    inb = (ui >= 0) & (vi >= 0) & (ui < w) & (vi < h)
    uic = jnp.clip(ui, 0, w - 1)
    vic = jnp.clip(vi, 0, h - 1)
    val = img[vic, uic]
    if img.ndim == 3:
        val = jnp.where(inb[..., None], val, 0.0)
    else:
        val = jnp.where(inb, val, 0.0)
    return val, inb
