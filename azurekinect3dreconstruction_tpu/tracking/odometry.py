"""Hybrid photometric + geometric RGB-D odometry (Gauss–Newton, pyramids).

Device-native replacement for Open3D's ``compute_rgbd_odometry`` with the
Hybrid/Color term Jacobians (used at reference
CodeThatWorks/RGBD_Odometry.py:22-35,
CodeThatWorks/1camera-detectsSceneChanges.py:235-260, and with pyramid
iterations [20,10,5] / max_depth_diff at
CodeThatWorks/bundlefusionattemps/bundlefusion_reconstruction.py:118-129).

Everything is one jitted function: the image pyramid, the per-iteration
dense warp, the per-pixel 6-dof Jacobians, and the (N,6)->(6,6) normal-
equation reduction (a single matmul). Control flow is a fixed
``lax.fori_loop`` per level — no data-dependent Python branching, so one
compilation serves every frame.

Convention: returns ``T_target_source`` — the transform taking source-camera
points into the target camera (same direction as Open3D's odometry result).
The photometric term warps *source* pixels into the *target* image.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from azurekinect3dreconstruction_tpu.config import OdometryConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu.core import linalg
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.ops.backproject import bilinear_sample
from azurekinect3dreconstruction_tpu.ops.image import (
    build_pyramid,
    sobel_gradients,
)

_PP = jax.lax.Precision.HIGHEST


class OdometryResult(NamedTuple):
    T_target_source: jax.Array  # (4, 4)
    fitness: jax.Array  # inlier fraction of valid source pixels
    rmse: jax.Array  # final weighted residual RMS
    inliers: jax.Array  # int32 count


def _huber_weight(r, delta):
    a = jnp.abs(r)
    return jnp.where(a <= delta, 1.0, delta / jnp.maximum(a, 1e-12))


def _level_step(T, data, intr: Intrinsics, cfg: OdometryConfig):
    """One Gauss-Newton iteration at one pyramid level. Returns (T', stats)."""
    (i_s, d_s, i_t, d_t, gx_t, gy_t, gdx_t, gdy_t) = data
    h, w = d_s.shape
    fx, fy, cx, cy = intr.fx, intr.fy, intr.cx, intr.cy

    # source points
    u = jnp.arange(w, dtype=jnp.float32)[None, :]
    v = jnp.arange(h, dtype=jnp.float32)[:, None]
    z = d_s
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    valid_s = (z > cfg.min_depth) & (z < cfg.max_depth)

    R = T[:3, :3]
    t = T[:3, 3]
    px = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    py = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    pz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    zs = jnp.maximum(pz, 1e-6)
    ut = px / zs * fx + cx
    vt = py / zs * fy + cy
    uv = jnp.stack([ut, vt], axis=-1)

    it_w, inb1 = bilinear_sample(i_t, uv)
    dt_w, inb2 = bilinear_sample(d_t, uv)
    gx_w, _ = bilinear_sample(gx_t, uv)
    gy_w, _ = bilinear_sample(gy_t, uv)
    gdx_w, _ = bilinear_sample(gdx_t, uv)
    gdy_w, _ = bilinear_sample(gdy_t, uv)

    r_i = it_w - i_s
    r_d = dt_w - pz
    valid = (
        valid_s
        & inb1
        & inb2
        & (pz > cfg.min_depth)
        & (dt_w > cfg.min_depth)
        & (jnp.abs(r_d) < cfg.max_depth_diff)
    )

    # projection Jacobian rows (du/dp', dv/dp')
    inv_z = 1.0 / zs
    ju = jnp.stack([fx * inv_z, jnp.zeros_like(pz), -fx * px * inv_z * inv_z], -1)
    jv = jnp.stack([jnp.zeros_like(pz), fy * inv_z, -fy * py * inv_z * inv_z], -1)

    # dp'/dxi with xi = (v, w): [I | -hat(p')]
    def dp_dxi(jp):
        """contract (.., 3) point-Jacobian with dp'/dxi -> (.., 6)."""
        jx, jy, jz = jp[..., 0], jp[..., 1], jp[..., 2]
        return jnp.stack(
            [
                jx,
                jy,
                jz,
                -jy * pz + jz * py,
                jx * pz - jz * px,
                -jx * py + jy * px,
            ],
            axis=-1,
        )

    j_uv_i = gx_w[..., None] * ju + gy_w[..., None] * jv  # (..,3)
    J_i = dp_dxi(j_uv_i)
    # geometric: d r_d/dxi = grad(D_t) J_uv dp'/dxi - e_z dp'/dxi
    j_uv_d = gdx_w[..., None] * ju + gdy_w[..., None] * jv
    ez = jnp.zeros_like(j_uv_d).at[..., 2].set(1.0)
    J_d = dp_dxi(j_uv_d - ez)

    s_i = 1.0 / cfg.sigma_intensity
    s_d = 1.0 / cfg.sigma_depth
    w_i = _huber_weight(r_i * s_i, cfg.huber_delta) * valid
    w_d = _huber_weight(r_d * s_d, cfg.huber_delta) * valid
    if cfg.term == "color":
        w_d = jnp.zeros_like(w_d)
    elif cfg.term == "depth":
        w_i = jnp.zeros_like(w_i)

    n = h * w
    Ji = (J_i * (w_i[..., None] * s_i)).reshape(n, 6)
    Jd = (J_d * (w_d[..., None] * s_d)).reshape(n, 6)
    ri = (r_i * w_i * s_i).reshape(n)
    rd = (r_d * w_d * s_d).reshape(n)
    J = jnp.concatenate([Ji, Jd], axis=0)
    r = jnp.concatenate([ri, rd], axis=0)
    # note: residual/Jacobian rows are pre-multiplied by sqrt-weights twice
    # (w * s), matching a weighted least squares with weight w^2 s^2 — the
    # same normal equations as IRLS with Huber weights w.
    JtJ = jnp.matmul(J.T, J, precision=_PP)
    Jtr = jnp.matmul(J.T, r, precision=_PP)

    delta = linalg.solve_spd6(JtJ + cfg.damping * jnp.eye(6, dtype=JtJ.dtype), -Jtr)
    ok = jnp.all(jnp.isfinite(delta))
    delta = jnp.where(ok, delta, jnp.zeros_like(delta))
    T_new = jnp.matmul(se3.se3_exp(delta), T, precision=_PP)

    n_valid = jnp.sum(valid.astype(jnp.int32))
    sq = jnp.sum(jnp.where(valid, (r_i * s_i) ** 2 + (r_d * s_d) ** 2, 0.0))
    rmse = jnp.sqrt(sq / jnp.maximum(n_valid, 1))
    n_src = jnp.sum(valid_s.astype(jnp.int32))
    fitness = n_valid / jnp.maximum(n_src, 1)
    return T_new, (fitness, rmse, n_valid)


@partial(jax.jit, static_argnames=("intr", "cfg"))
def compute_odometry(
    intensity_s, depth_s, intensity_t, depth_t, intr: Intrinsics,
    cfg: OdometryConfig = OdometryConfig(), init=None,
) -> OdometryResult:
    """Dense hybrid odometry source->target over an image pyramid.

    intensity_*: (H, W) f32 in [0,1]; depth_*: (H, W) f32 meters (0 invalid).
    """
    levels = len(cfg.pyramid_iters)
    pyr_s = build_pyramid(jnp.asarray(intensity_s), jnp.asarray(depth_s), levels)
    pyr_t = build_pyramid(jnp.asarray(intensity_t), jnp.asarray(depth_t), levels)

    T = jnp.eye(4, dtype=jnp.float32) if init is None else jnp.asarray(init, jnp.float32)
    stats = (jnp.zeros(()), jnp.zeros(()), jnp.zeros((), jnp.int32))

    # coarse -> fine; cfg.pyramid_iters[l] = iterations at level l (0 = finest)
    for lvl in reversed(range(levels)):
        i_s, d_s = pyr_s[lvl]
        i_t, d_t = pyr_t[lvl]
        gx_t, gy_t = sobel_gradients(i_t)
        gdx_t, gdy_t = sobel_gradients(d_t)
        # zero depth gradients near invalid pixels (they are meaningless)
        dv = d_t > 0
        ok = (
            dv
            & jnp.roll(dv, 1, 0) & jnp.roll(dv, -1, 0)
            & jnp.roll(dv, 1, 1) & jnp.roll(dv, -1, 1)
        )
        gdx_t = jnp.where(ok, gdx_t, 0.0)
        gdy_t = jnp.where(ok, gdy_t, 0.0)
        lintr = intr.scaled(1.0 / (1 << lvl))
        data = (i_s, d_s, i_t, d_t, gx_t, gy_t, gdx_t, gdy_t)

        def body(_, carry):
            T, _stats = carry
            return _level_step(T, data, lintr, cfg)

        T, stats = jax.lax.fori_loop(0, cfg.pyramid_iters[lvl], body, (T, stats))

    fitness, rmse, n_valid = stats
    return OdometryResult(T_target_source=T, fitness=fitness, rmse=rmse, inliers=n_valid)


def compute_odometry_frames(frame_s, frame_t, intr: Intrinsics,
                            cfg: OdometryConfig = OdometryConfig(), init=None):
    """Convenience overload on core.types.RGBDFrame pairs."""
    return compute_odometry(
        frame_s.intensity, frame_s.depth, frame_t.intensity, frame_t.depth,
        intr, cfg, init,
    )
