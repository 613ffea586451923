"""ICP: point-to-plane and colored variants with projective data association.

Device-native replacement for Open3D's ``registration_icp`` (point-to-plane,
reference CreateMesh.py:258-262, GoodColorReconstruction.py:189-204) and
``registration_colored_icp`` (GoodColorReconstruction.py:246-254).

Correspondence search is **projective** instead of KD-tree (SURVEY.md §7.3):
the source cloud is transformed by the current estimate and projected into
the target camera's organized maps (points / normals / intensity), which is a
fixed-shape bilinear/nearest sample — no trees, no dynamic neighbor lists.
This matches the reference's actual usage: every ICP call there registers
geometry that originated from a camera frame, so organized target maps are
always available. (Cloud-to-cloud ICP without a camera uses grid-hash
association — tracking.grid_icp.)

Colored ICP follows Park et al. 2017's objective — (1-λ) photometric +
λ geometric point-to-plane — with the photometric gradient taken from the
target intensity image (the projective analog of their tangent-plane color
gradients).

Fitness/rmse semantics mirror Open3D's: fitness = inliers / valid source
points; inlier_rmse over matched correspondences — the reference gates on
fitness ≥ 0.5 (ICP) / ≥ 0.6 (colored) (GoodColorReconstruction.py:200,256).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from azurekinect3dreconstruction_tpu.config import RegistrationConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu.core import linalg
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.ops.backproject import bilinear_sample, nearest_sample
from azurekinect3dreconstruction_tpu.ops.image import sobel_gradients

_PP = jax.lax.Precision.HIGHEST


class ICPResult(NamedTuple):
    T: jax.Array  # (4,4) transform source -> target frame
    fitness: jax.Array
    inlier_rmse: jax.Array
    inliers: jax.Array


class TargetMaps(NamedTuple):
    """Organized target-frame geometry for projective association."""

    points: jax.Array  # (H, W, 3) camera-space points (z=0 invalid)
    normals: jax.Array  # (H, W, 3) unit normals (0 invalid)
    intensity: Optional[jax.Array] = None  # (H, W)
    grad_u: Optional[jax.Array] = None
    grad_v: Optional[jax.Array] = None

    @staticmethod
    def from_depth(depth, intr: Intrinsics, intensity=None, rays=None):
        from azurekinect3dreconstruction_tpu.core.camera import pixel_rays
        from azurekinect3dreconstruction_tpu.ops.backproject import backproject_depth
        from azurekinect3dreconstruction_tpu.ops.normals import organized_normals

        if rays is None:
            rays = pixel_rays(intr)
        pts = backproject_depth(jnp.asarray(depth), rays)
        nrm = organized_normals(pts)
        gu = gv = None
        if intensity is not None:
            gu, gv = sobel_gradients(jnp.asarray(intensity))
        return TargetMaps(points=pts, normals=nrm, intensity=None if intensity is None
                          else jnp.asarray(intensity), grad_u=gu, grad_v=gv)


def _gn_step(T, src_pts, src_int, src_mask, tgt: TargetMaps, intr: Intrinsics,
             dist_thr, lambda_geometric, colored: bool):
    p = se3.transform_points(T, src_pts)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    zs = jnp.maximum(pz, 1e-6)
    u = px / zs * intr.fx + intr.cx
    v = py / zs * intr.fy + intr.cy
    uv = jnp.stack([u, v], axis=-1)

    q, inb = nearest_sample(tgt.points, uv)
    n, _ = nearest_sample(tgt.normals, uv)
    has_n = jnp.sum(n * n, axis=-1) > 0.5
    diff = p - q
    dist = jnp.linalg.norm(diff, axis=-1)
    r_g = jnp.sum(diff * n, axis=-1)
    valid = src_mask & inb & (pz > 1e-4) & (q[..., 2] > 0) & has_n & (dist < dist_thr)

    # geometric rows: J = [n, p x n]
    pxn = jnp.cross(p, n)
    J_g = jnp.concatenate([n, pxn], axis=-1)  # (N, 6)
    sg = jnp.sqrt(lambda_geometric) if colored else 1.0
    w = valid.astype(jnp.float32)
    rows_J = [J_g * (w[..., None] * sg)]
    rows_r = [r_g * w * sg]

    if colored:
        it, _ = bilinear_sample(tgt.intensity, uv)
        gu, _ = bilinear_sample(tgt.grad_u, uv)
        gv_, _ = bilinear_sample(tgt.grad_v, uv)
        r_c = it - src_int
        inv_z = 1.0 / zs
        ju = jnp.stack([intr.fx * inv_z, jnp.zeros_like(pz),
                        -intr.fx * px * inv_z * inv_z], -1)
        jv = jnp.stack([jnp.zeros_like(pz), intr.fy * inv_z,
                        -intr.fy * py * inv_z * inv_z], -1)
        jp = gu[..., None] * ju + gv_[..., None] * jv  # (N,3) dI/dp'
        jw = jnp.stack(
            [
                jp[..., 0], jp[..., 1], jp[..., 2],
                -jp[..., 1] * pz + jp[..., 2] * py,
                jp[..., 0] * pz - jp[..., 2] * px,
                -jp[..., 0] * py + jp[..., 1] * px,
            ],
            axis=-1,
        )
        sc = jnp.sqrt(1.0 - lambda_geometric)
        rows_J.append(jw * (w[..., None] * sc))
        rows_r.append(r_c * w * sc)

    J = jnp.concatenate(rows_J, axis=0)
    r = jnp.concatenate(rows_r, axis=0)
    JtJ = jnp.matmul(J.T, J, precision=_PP)
    Jtr = jnp.matmul(J.T, r, precision=_PP)
    delta = linalg.solve_spd6(JtJ + 1e-6 * jnp.eye(6, dtype=JtJ.dtype), -Jtr)
    ok = jnp.all(jnp.isfinite(delta))
    delta = jnp.where(ok, delta, jnp.zeros_like(delta))
    T_new = jnp.matmul(se3.se3_exp(delta), T, precision=_PP)

    n_in = jnp.sum(valid.astype(jnp.int32))
    n_src = jnp.sum(src_mask.astype(jnp.int32))
    fitness = n_in / jnp.maximum(n_src, 1)
    rmse = jnp.sqrt(jnp.sum(jnp.where(valid, dist**2, 0.0)) / jnp.maximum(n_in, 1))
    return T_new, (fitness, rmse, n_in), jnp.linalg.norm(delta)


@partial(jax.jit, static_argnames=("intr", "max_iters", "colored"))
def icp_projective(src_points, src_mask, tgt: TargetMaps, intr: Intrinsics,
                   init=None, max_iters: int = 30, dist_thr: float = 0.05,
                   lambda_geometric: float = 0.968, colored: bool = False,
                   src_intensity=None, rel_tol: float = 1e-6) -> ICPResult:
    """Register a flat (N,3) masked source cloud onto organized target maps.

    Returns T such that ``T @ src ~= target-frame geometry``.

    ``rel_tol`` is the convergence criterion the reference configures on
    Open3D (``ICPConvergenceCriteria(relative_fitness=1e-6,
    relative_rmse=1e-6, max_iteration=100)``,
    GoodColorReconstruction.py:251-253): stop iterating once consecutive
    iterations stop changing. Open3D tests f64 fitness/rmse deltas; here
    fitness is f32 and quantized at 1/n_src (~4e-5 for a 23k-point source,
    ABOVE 1e-6 — a single correspondence toggling would keep the delta test
    from ever firing), so the implementation tests the quantity those
    deltas proxy: the GN update's tangent-space norm. ``|delta| < rel_tol``
    (1e-6 ~ a micrometre/microradian step) means the pose is stationary to
    far below sensor noise — iteration ``i+1`` would recompute the same
    correspondences and re-solve to the same pose. Measured on the
    recorder's keyframe at 640x576: a converged registration stops after
    ~10-25 of the 100-iteration ceiling, cutting the keyframe dispatch
    ~4-8x. Pass 0 to force exactly ``max_iters`` iterations.
    """
    src_points = jnp.asarray(src_points, jnp.float32)
    src_mask = jnp.asarray(src_mask, jnp.bool_)
    if src_intensity is None:
        src_intensity = jnp.zeros(src_points.shape[:-1], jnp.float32)
    T0 = jnp.eye(4, dtype=jnp.float32) if init is None else jnp.asarray(init, jnp.float32)

    stats0 = (jnp.zeros(()), jnp.zeros(()), jnp.zeros((), jnp.int32))

    def cond(carry):
        _T, _stats, i, done = carry
        return (i < max_iters) & ~done

    def body(carry):
        T, _stats, i, _ = carry
        T2, stats, dnorm = _gn_step(T, src_points, src_intensity,
                                    src_mask, tgt, intr, dist_thr,
                                    lambda_geometric, colored)
        return T2, stats, i + 1, dnorm < rel_tol

    T, (fitness, rmse, n_in), _i, _d = jax.lax.while_loop(
        cond, body, (T0, stats0, jnp.int32(0), jnp.asarray(False)))
    return ICPResult(T=T, fitness=fitness, inlier_rmse=rmse, inliers=n_in)


def icp_point_to_plane(src_points, src_mask, tgt: TargetMaps, intr: Intrinsics,
                       init=None, cfg: RegistrationConfig = RegistrationConfig()):
    """Open3D ``TransformationEstimationPointToPlane`` analog
    (reference CreateMesh.py:258-262)."""
    return icp_projective(src_points, src_mask, tgt, intr, init=init,
                          max_iters=cfg.icp_max_iters,
                          dist_thr=cfg.icp_distance_threshold, colored=False)


def colored_icp(src_points, src_intensity, src_mask, tgt: TargetMaps,
                intr: Intrinsics, init=None,
                cfg: RegistrationConfig = RegistrationConfig()):
    """Open3D ``registration_colored_icp`` analog
    (reference GoodColorReconstruction.py:246-254)."""
    return icp_projective(src_points, src_mask, tgt, intr, init=init,
                          max_iters=cfg.colored_icp_max_iters,
                          dist_thr=cfg.icp_distance_threshold,
                          lambda_geometric=cfg.colored_icp_lambda_geometric,
                          colored=True, src_intensity=src_intensity)


# ---------------------------------------------------------------------------
# cloud-to-cloud ICP via grid-hash association (no camera needed)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("max_iters", "capacity", "max_per_cell"))
def icp_grid(src_points, src_mask, tgt_points, tgt_normals, tgt_mask,
             init=None, max_iters: int = 30, dist_thr: float = 0.05,
             capacity: int = 16384, max_per_cell: int = 8) -> ICPResult:
    """Point-to-plane ICP between two unorganized clouds.

    Correspondences are 1-NN through the voxel-grid hash (cell size =
    dist_thr, so the 27-cell search is complete within the gate) — the
    Device-shaped stand-in for Open3D's KDTree used by ``registration_icp``
    on clouds (reference azure-kinect-DK/Reconstruction/3Dreconstruction.py:
    112-160 fragment register/refine; Reconstruction.py:97-135).
    """
    from azurekinect3dreconstruction_tpu.ops.neighbors import (
        build_cell_lists,
        knn_gather,
    )

    src = jnp.asarray(src_points, jnp.float32)
    tgt = jnp.asarray(tgt_points, jnp.float32)
    nrm = jnp.asarray(tgt_normals, jnp.float32)
    cells = build_cell_lists(tgt, tgt_mask, dist_thr, capacity, max_per_cell)
    T0 = jnp.eye(4, dtype=jnp.float32) if init is None else jnp.asarray(init, jnp.float32)

    def body(_, carry):
        T, _stats = carry
        p = se3.transform_points(T, src)
        nn, dist = knn_gather(cells, tgt, p, src_mask, k=1, max_radius=dist_thr)
        idx = nn[:, 0]
        ok = src_mask & (idx >= 0)
        idx_c = jnp.where(ok, idx, 0)
        q = tgt[idx_c]
        n = nrm[idx_c]
        has_n = jnp.sum(n * n, axis=-1) > 0.5
        ok = ok & has_n
        r = jnp.sum((p - q) * n, axis=-1)
        J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)
        w = ok.astype(jnp.float32)
        Jw = J * w[:, None]
        JtJ = jnp.matmul(Jw.T, Jw, precision=_PP)
        Jtr = jnp.matmul(Jw.T, r * w, precision=_PP)
        delta = linalg.solve_spd6(JtJ + 1e-6 * jnp.eye(6), -Jtr)
        delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, jnp.zeros_like(delta))
        T_new = jnp.matmul(se3.se3_exp(delta), T, precision=_PP)
        n_in = jnp.sum(ok.astype(jnp.int32))
        fit = n_in / jnp.maximum(jnp.sum(src_mask.astype(jnp.int32)), 1)
        rmse = jnp.sqrt(jnp.sum(jnp.where(ok, dist[:, 0] ** 2, 0.0)) / jnp.maximum(n_in, 1))
        return T_new, (fit, rmse, n_in)

    stats0 = (jnp.zeros(()), jnp.zeros(()), jnp.zeros((), jnp.int32))
    T, (fit, rmse, n_in) = jax.lax.fori_loop(0, max_iters, body, (T0, stats0))
    return ICPResult(T=T, fitness=fit, inlier_rmse=rmse, inliers=n_in)


@partial(jax.jit, static_argnames=("max_iters", "capacity", "max_per_cell",
                                   "cell_size"))
def icp_point_to_point(src_points, src_mask, tgt_points, tgt_mask,
                       init=None, max_iters: int = 30, dist_thr: float = 0.05,
                       capacity: int = 16384, max_per_cell: int = 8,
                       cell_size: float = None) -> ICPResult:
    """Point-to-point ICP between two unorganized clouds — the fragment
    pipeline's registration mode (reference azure-kinect-DK/Reconstruction/
    3Dreconstruction.py:112-135: ``registration_icp(...,
    TransformationEstimationPointToPoint())`` on uniformly sampled mesh
    points).

    Per iteration: 1-NN correspondences through the voxel-grid hash, then
    the closed-form weighted Kabsch update (centroid-centered covariance ->
    3x3 SVD -> rotation with det fix) — Open3D's point-to-point estimator,
    fixed-shape for XLA.
    """
    from azurekinect3dreconstruction_tpu.ops.neighbors import (
        build_cell_lists,
        knn_gather,
    )

    src = jnp.asarray(src_points, jnp.float32)
    tgt = jnp.asarray(tgt_points, jnp.float32)
    # cell_size < dist_thr (with a larger capacity) keeps dense targets —
    # e.g. 100k uniform mesh samples — from being decimated to max_per_cell
    # points per dist_thr-sized cell; the 27-cell search then reaches
    # ~2*cell_size, so keep cell_size >= dist_thr / 2
    cs = float(cell_size) if cell_size is not None else dist_thr
    cells = build_cell_lists(tgt, tgt_mask, cs, capacity, max_per_cell)
    T0 = jnp.eye(4, dtype=jnp.float32) if init is None else jnp.asarray(init, jnp.float32)

    def body(_, carry):
        T, _stats = carry
        p = se3.transform_points(T, src)
        nn, dist = knn_gather(cells, tgt, p, src_mask, k=1,
                              max_radius=jnp.minimum(dist_thr, 1.5 * cs))
        idx = nn[:, 0]
        ok = src_mask & (idx >= 0)
        w = ok.astype(jnp.float32)
        q = tgt[jnp.where(ok, idx, 0)]
        nw = jnp.maximum(jnp.sum(w), 1.0)
        cp = jnp.sum(p * w[:, None], axis=0) / nw
        cq = jnp.sum(q * w[:, None], axis=0) / nw
        pc = (p - cp) * w[:, None]
        qc = (q - cq) * w[:, None]
        H = jnp.matmul(pc.T, qc, precision=_PP)  # (3,3)
        u, _, vt = jnp.linalg.svd(H)
        d = jnp.sign(jnp.linalg.det(jnp.matmul(vt.T, u.T, precision=_PP)))
        S = jnp.diag(jnp.stack([1.0 + 0 * d, 1.0 + 0 * d, d]))
        R = jnp.matmul(vt.T, jnp.matmul(S, u.T, precision=_PP), precision=_PP)
        t = cq - jnp.matmul(R, cp, precision=_PP)
        ok_R = jnp.all(jnp.isfinite(R)) & jnp.all(jnp.isfinite(t))
        dT = jnp.eye(4, dtype=jnp.float32)
        dT = dT.at[:3, :3].set(jnp.where(ok_R, R, jnp.eye(3)))
        dT = dT.at[:3, 3].set(jnp.where(ok_R, t, jnp.zeros(3)))
        T_new = jnp.matmul(dT, T, precision=_PP)
        n_in = jnp.sum(ok.astype(jnp.int32))
        fit = n_in / jnp.maximum(jnp.sum(src_mask.astype(jnp.int32)), 1)
        rmse = jnp.sqrt(jnp.sum(jnp.where(ok, dist[:, 0] ** 2, 0.0))
                        / jnp.maximum(n_in, 1))
        return T_new, (fit, rmse, n_in)

    stats0 = (jnp.zeros(()), jnp.zeros(()), jnp.zeros((), jnp.int32))
    T, (fit, rmse, n_in) = jax.lax.fori_loop(0, max_iters, body, (T0, stats0))
    return ICPResult(T=T, fitness=fit, inlier_rmse=rmse, inliers=n_in)


@partial(jax.jit, static_argnames=("intr",))
def projective_overlap(src_points, src_mask, tgt: TargetMaps,
                       intr: Intrinsics, T, dist_thr: float = 0.05):
    """(matched, visible, rmse) of ``src`` under ``T`` against organized
    target maps. ``visible`` counts source points that project in-bounds
    onto valid target depth/normals with positive depth both sides —
    i.e. points the FRAME can actually testify about; ``matched`` are the
    visible points within ``dist_thr`` of the surface.

    ``matched / visible`` is the density-robust form of an overlap gate
    when the source cloud is a budget-bounded MODEL sample and the target
    is a dense frame: normalizing by all source points punishes map
    regions outside the frustum (most of a grown map), while the
    cloud-to-sparse-cloud ``evaluate_registration`` direction saturates
    below 1 at the model's sampling density even for a perfect pose
    (measured: 0.56 at a 0.6 mm-true recovery against a truncated 32k
    sample — tracking/relocalize.py hint gate)."""
    p = se3.transform_points(jnp.asarray(T, jnp.float32),
                             jnp.asarray(src_points, jnp.float32))
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    zs = jnp.maximum(pz, 1e-6)
    uv = jnp.stack([px / zs * intr.fx + intr.cx,
                    py / zs * intr.fy + intr.cy], axis=-1)
    q, inb = nearest_sample(tgt.points, uv)
    n, _ = nearest_sample(tgt.normals, uv)
    has_n = jnp.sum(n * n, axis=-1) > 0.5
    visible = src_mask & inb & (pz > 1e-4) & (q[..., 2] > 0) & has_n
    dist = jnp.linalg.norm(p - q, axis=-1)
    matched = visible & (dist < dist_thr)
    n_m = jnp.sum(matched.astype(jnp.int32))
    rmse = jnp.sqrt(jnp.sum(jnp.where(matched, dist**2, 0.0))
                    / jnp.maximum(n_m, 1))
    return n_m, jnp.sum(visible.astype(jnp.int32)), rmse


@partial(jax.jit, static_argnames=("capacity",))
def evaluate_registration(src_points, src_mask, tgt_points, tgt_mask, T,
                          dist_thr: float = 0.02, capacity: int = 16384):
    """Open3D ``evaluate_registration`` analog: (fitness, inlier_rmse) of T
    applied to src vs tgt (used for the reference's overlap gates,
    CreateMesh.py:629-642)."""
    from azurekinect3dreconstruction_tpu.ops.neighbors import (
        build_cell_lists,
        knn_gather,
    )

    src = jnp.asarray(src_points, jnp.float32)
    tgt = jnp.asarray(tgt_points, jnp.float32)
    cells = build_cell_lists(tgt, tgt_mask, dist_thr, capacity)
    p = se3.transform_points(jnp.asarray(T, jnp.float32), src)
    nn, dist = knn_gather(cells, tgt, p, src_mask, k=1, max_radius=dist_thr)
    ok = src_mask & (nn[:, 0] >= 0)
    n_in = jnp.sum(ok.astype(jnp.int32))
    fit = n_in / jnp.maximum(jnp.sum(src_mask.astype(jnp.int32)), 1)
    rmse = jnp.sqrt(jnp.sum(jnp.where(ok, dist[:, 0] ** 2, 0.0)) / jnp.maximum(n_in, 1))
    return fit, rmse
