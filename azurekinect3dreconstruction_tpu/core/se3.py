"""SE(3) rigid-transform utilities (dtype-polymorphic, jit-safe).

One convention everywhere: a pose ``T`` is the 4x4 **camera-to-world** matrix
(``X_world = T @ X_cam``). The reference mixes conventions — forward transform
into ``volume.integrate`` at reference
CodeThatWorks/1camera-detectsSceneChanges.py:270-274, the inverse at
GoodColorReconstruction.py:264-272, and a flip-conjugated pose at
bundlefusion_reconstruction.py:224-231. Here the TSDF layer always receives
camera-to-world and inverts internally, and the Open3D "flip" is a display
concern handled in viz (see :data:`FLIP_TRANSFORM`).

All functions accept/return jnp or np arrays and are safe inside jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# All matmuls in this module are 3x3/4x4: force full f32 precision (an
# accelerator default may be bf16 or TF32 inputs — a ~1e-3 relative error that would corrupt pose
# chains). These contractions are trivially small; HIGHEST costs nothing.
_PP = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PP)

# Open3D-style display flip (reference CreateMesh.py:597: pcd.transform(flip)).
FLIP_TRANSFORM = np.array(
    [[1.0, 0, 0, 0], [0, -1.0, 0, 0], [0, 0, -1.0, 0], [0, 0, 0, 1.0]]
)


def hat(w):
    """3-vector -> skew-symmetric matrix, so that hat(w) @ v == cross(w, v)."""
    w = jnp.asarray(w)
    z = jnp.zeros((), w.dtype)
    return jnp.stack(
        [
            jnp.stack([z, -w[2], w[1]]),
            jnp.stack([w[2], z, -w[0]]),
            jnp.stack([-w[1], w[0], z]),
        ]
    )


def so3_exp(w):
    """Rodrigues: axis-angle 3-vector -> rotation matrix. Taylor-safe at 0."""
    w = jnp.asarray(w)
    theta2 = jnp.sum(w * w)
    theta = jnp.sqrt(theta2 + 1e-32)
    W = hat(w)
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks near zero.
    a = jnp.where(theta2 > 1e-6, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(
        theta2 > 1e-6, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-32), 0.5 - theta2 / 24.0
    )
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a * W + b * _mm(W, W)


def so3_log(R):
    """Rotation matrix -> axis-angle 3-vector (principal branch)."""
    R = jnp.asarray(R)
    cos_t = jnp.clip((jnp.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    # vee of the antisymmetric part; |v| = 2 sin(theta)
    v = jnp.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    # atan2(sin, cos) stays well-conditioned at small angles, where
    # arccos(trace) would round theta^2 out of the f32 trace entirely.
    sin_t = 0.5 * jnp.sqrt(jnp.sum(v * v) + 1e-38)
    theta = jnp.arctan2(sin_t, cos_t)
    scale = jnp.where(sin_t > 1e-6, theta / (2.0 * sin_t + 1e-32), 0.5 + theta * theta / 12.0)
    w_generic = scale * v
    # Near theta == pi the vee part vanishes; recover axis from diagonal.
    axis2 = jnp.clip((jnp.diagonal(R) + 1.0) * 0.5, 0.0, 1.0)
    axis = jnp.sqrt(axis2)
    # fix signs using off-diagonals
    axis = axis * jnp.stack(
        [
            jnp.where(R[2, 1] - R[1, 2] >= 0, 1.0, -1.0),
            jnp.where(R[0, 2] - R[2, 0] >= 0, 1.0, -1.0),
            jnp.where(R[1, 0] - R[0, 1] >= 0, 1.0, -1.0),
        ]
    ).astype(R.dtype)
    w_pi = axis * theta
    return jnp.where(theta > 3.1, w_pi, w_generic)


def se3_exp(xi):
    """Twist (vx, vy, vz, wx, wy, wz) -> 4x4 transform.

    Translation first, rotation last — the ordering used by our odometry/ICP
    Jacobians throughout.
    """
    xi = jnp.asarray(xi)
    v, w = xi[:3], xi[3:]
    theta2 = jnp.sum(w * w)
    theta = jnp.sqrt(theta2 + 1e-32)
    W = hat(w)
    R = so3_exp(w)
    b = jnp.where(
        theta2 > 1e-6, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-32), 0.5 - theta2 / 24.0
    )
    c = jnp.where(
        theta2 > 1e-6,
        (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, 1e-32),
        1.0 / 6.0 - theta2 / 120.0,
    )
    V = jnp.eye(3, dtype=xi.dtype) + b * W + c * _mm(W, W)
    t = _mm(V, v)
    T = jnp.eye(4, dtype=xi.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def se3_log(T):
    """4x4 transform -> twist (vx, vy, vz, wx, wy, wz)."""
    T = jnp.asarray(T)
    w = so3_log(T[:3, :3])
    theta2 = jnp.sum(w * w)
    theta = jnp.sqrt(theta2 + 1e-32)
    W = hat(w)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - theta sin/(2(1-cos))) W^2
    A = jnp.sin(theta) / jnp.maximum(theta, 1e-32)
    B = (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-32)
    coef = jnp.where(
        theta2 > 1e-6,
        (1.0 - A / jnp.maximum(2.0 * B, 1e-32)) / jnp.maximum(theta2, 1e-32),
        1.0 / 12.0 + theta2 / 720.0,
    )
    Vinv = jnp.eye(3, dtype=T.dtype) - 0.5 * W + coef * _mm(W, W)
    v = _mm(Vinv, T[:3, 3])
    return jnp.concatenate([v, w])


def inverse(T):
    """Rigid inverse: [R t]^-1 = [R^T, -R^T t]."""
    T = jnp.asarray(T)
    Rt = T[:3, :3].T
    t = -_mm(Rt, T[:3, 3])
    out = jnp.eye(4, dtype=T.dtype)
    out = out.at[:3, :3].set(Rt)
    out = out.at[:3, 3].set(t)
    return out


def compose_renormalized(T_a, T_b):
    """``T_a @ T_b`` with the rotation snapped back to SO(3).

    Long pose chains compose in f32 on device (device f64 is slow or emulated); of the
    two f32 error modes, translation rounding is a benign ~1e-7 random walk,
    but rotation non-orthogonality compounds MULTIPLICATIVELY through the
    chain — so snap R with one Newton iteration of the polar decomposition
    (R <- 1.5 R - 0.5 R Rᵀ R; quadratic convergence, and one step from a
    near-orthogonal start lands at f32 roundoff). Three 3x3 matmuls: free
    next to any tracking workload. Every device-side pose accumulator must
    route through here (the flat SLAM gate, the recorder's keyframe chain)."""
    T = _mm(jnp.asarray(T_a, jnp.float32), jnp.asarray(T_b, jnp.float32))
    R = T[:3, :3]
    R = 1.5 * R - 0.5 * _mm(R, _mm(R.T, R))
    return T.at[:3, :3].set(R)


def transform_points(T, pts):
    """Apply 4x4 to (..., 3) points.

    Full-f32 matmul precision: a TF32 or bf16 default keeps ~3 significant
    digits, which would inject millimeter-scale error at room range —
    on par with the 5 mm voxels we fuse into. These K=3 contractions are
    bandwidth-bound anyway, so HIGHEST costs nothing.
    """
    T = jnp.asarray(T)
    pts = jnp.asarray(pts)
    return (
        jnp.matmul(pts, T[:3, :3].T, precision=jax.lax.Precision.HIGHEST) + T[:3, 3]
    )


def rotate_vectors(T, vecs):
    """Apply only the rotation of a 4x4 (for normals/directions)."""
    return jnp.matmul(
        jnp.asarray(vecs), jnp.asarray(T)[:3, :3].T, precision=jax.lax.Precision.HIGHEST
    )


def rpy_from_matrix(R):
    """Roll/pitch/yaw (XYZ intrinsic, radians) — matches the reference's
    calibration printout (CreateMesh.py:645-659)."""
    R = np.asarray(R)
    sy = float(np.hypot(R[0, 0], R[1, 0]))
    if sy > 1e-6:
        roll = float(np.arctan2(R[2, 1], R[2, 2]))
        pitch = float(np.arctan2(-R[2, 0], sy))
        yaw = float(np.arctan2(R[1, 0], R[0, 0]))
    else:
        roll = float(np.arctan2(-R[1, 2], R[1, 1]))
        pitch = float(np.arctan2(-R[2, 0], sy))
        yaw = 0.0
    return roll, pitch, yaw


def matrix_from_rpy(roll, pitch, yaw, dtype=np.float64):
    """Inverse of :func:`rpy_from_matrix` (numpy, host-side)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, syaw = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -syaw, 0], [syaw, cy, 0], [0, 0, 1]], dtype=dtype)
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], dtype=dtype)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], dtype=dtype)
    return Rz @ Ry @ Rx


def is_valid_transform(T, tol=1e-3) -> bool:
    """Host-side sanity gate used where the reference checks trace==4 identity
    (CreateMesh.py:248) and rejects degenerate registrations."""
    T = np.asarray(T)
    if not np.all(np.isfinite(T)):
        return False
    R = T[:3, :3]
    return bool(
        np.allclose(R @ R.T, np.eye(3), atol=10 * tol) and abs(np.linalg.det(R) - 1.0) < 10 * tol
    )


jax.tree_util  # keep jax import referenced even when only numpy paths are used
