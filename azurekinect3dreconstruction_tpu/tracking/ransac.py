"""Feature-based global registration: massively-parallel RANSAC on the device.

Replaces ``registration_ransac_based_on_feature_matching`` with edge-length +
distance correspondence checkers (reference CreateMesh.py:236-246 runs
4,000,000 *sequential* host iterations with 500-sample validation;
GoodColorReconstruction.py:179-187 similar). The device formulation evaluates
thousands of hypotheses *simultaneously*: each hypothesis is a 4-sample
Kabsch fit (batched 3x3 SVD), checkers and inlier scoring are
dense masked reductions over the full correspondence set — so the per-round
cost is one batched pipeline instead of four million Python loop iterations.

Acceptance statistics mirror the reference: fitness = inliers / source
correspondences, gated by min_fitness_global = 0.3
(GoodColorReconstruction.py:183); the edge-length checker uses ratio 0.9
(CreateMesh.py:243-244).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from azurekinect3dreconstruction_tpu.config import RegistrationConfig

_PP = jax.lax.Precision.HIGHEST


class RANSACResult(NamedTuple):
    T: jax.Array  # (4,4)
    fitness: jax.Array
    inlier_rmse: jax.Array
    n_correspondences: jax.Array


@partial(jax.jit, static_argnames=("mutual",))
def match_features(feat_src, feat_tgt, mask_src, mask_tgt, mutual: bool = True):
    """Nearest-neighbor feature correspondences (optionally mutual).

    Returns (corr_tgt_idx int32[N_src] (-1 where unmatched)). The (N,M)
    distance matrix is one matmul — exactly what matrix units are for.
    """
    fs = jnp.asarray(feat_src, jnp.float32)
    ft = jnp.asarray(feat_tgt, jnp.float32)
    d = (
        jnp.sum(fs * fs, axis=1)[:, None]
        - 2.0 * jnp.matmul(fs, ft.T, precision=_PP)
        + jnp.sum(ft * ft, axis=1)[None, :]
    )
    big = jnp.float32(1e9)
    d = jnp.where(mask_src[:, None] & mask_tgt[None, :], d, big)
    nn_st = jnp.argmin(d, axis=1)
    ok = mask_src & (jnp.take_along_axis(d, nn_st[:, None], axis=1)[:, 0] < big)
    if mutual:
        nn_ts = jnp.argmin(d, axis=0)
        ok = ok & (nn_ts[nn_st] == jnp.arange(fs.shape[0]))
    return jnp.where(ok, nn_st, -1)


def _kabsch(src, tgt, w):
    """Weighted rigid fit src->tgt. src/tgt: (..., n, 3); w: (..., n)."""
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    ws = w[..., None] / wsum[..., None]
    cs = jnp.sum(src * ws, axis=-2, keepdims=True)
    ct = jnp.sum(tgt * ws, axis=-2, keepdims=True)
    H = jnp.matmul(
        jnp.swapaxes((src - cs) * ws, -1, -2), tgt - ct, precision=_PP
    )  # (..., 3, 3)
    U, S, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(jnp.matmul(jnp.swapaxes(Vt, -1, -2),
                                    jnp.swapaxes(U, -1, -2), precision=_PP))
    D = jnp.zeros_like(H).at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0).at[..., 2, 2].set(det)
    R = jnp.matmul(jnp.swapaxes(Vt, -1, -2),
                   jnp.matmul(D, jnp.swapaxes(U, -1, -2), precision=_PP), precision=_PP)
    t = ct[..., 0, :] - jnp.einsum("...ij,...j->...i", R, cs[..., 0, :], precision=_PP)
    return R, t


@partial(jax.jit, static_argnames=("cfg",))
def ransac_registration(src_points, tgt_points, corr, key,
                        cfg: RegistrationConfig = RegistrationConfig(),
                        distance_threshold=None) -> RANSACResult:
    """RANSAC over precomputed correspondences (src index i -> tgt corr[i]).

    corr: int32[N] target indices, -1 for unmatched source points.
    """
    if distance_threshold is None:
        distance_threshold = cfg.icp_distance_threshold * 1.5
    src = jnp.asarray(src_points, jnp.float32)
    tgt = jnp.asarray(tgt_points, jnp.float32)
    ok = corr >= 0
    corr_c = jnp.where(ok, corr, 0)
    q = tgt[corr_c]  # matched target points per source
    n_corr = jnp.sum(ok.astype(jnp.int32))

    H = cfg.ransac_hypotheses
    n = cfg.ransac_n
    N = src.shape[0]
    # sample from valid correspondences: draw uniform over [0, n_corr) ranks,
    # then map rank -> index via sorted order of validity
    rank_to_idx = jnp.argsort(~ok)  # valid entries first (stable)
    u = jax.random.randint(key, (H, n), 0, jnp.maximum(n_corr, 1))
    samp = rank_to_idx[u]  # (H, n) source indices
    s_pts = src[samp]  # (H, n, 3)
    t_pts = q[samp]

    # edge-length checker (CreateMesh.py:243): for every sample pair, the two
    # edge lengths must agree within ratio 0.9
    def edges(a):
        d = jnp.linalg.norm(a[:, :, None, :] - a[:, None, :, :], axis=-1)
        return d
    es, et = edges(s_pts), edges(t_pts)
    iu = jnp.triu_indices(n, k=1)
    ratio = jnp.minimum(es[:, iu[0], iu[1]], et[:, iu[0], iu[1]]) / jnp.maximum(
        jnp.maximum(es[:, iu[0], iu[1]], et[:, iu[0], iu[1]]), 1e-9
    )
    edge_ok = jnp.all(ratio > cfg.edge_length_check, axis=1)

    w = jnp.ones((H, n), jnp.float32)
    R, t = _kabsch(s_pts, t_pts, w)  # (H,3,3), (H,3)

    # score each hypothesis over ALL correspondences
    # (H, N, 3) = src @ R^T + t  — batched matmul
    src_ok = jnp.where(ok[:, None], src, 0.0)
    proj = jnp.einsum("hij,nj->hni", R, src, precision=_PP) + t[:, None, :]
    d2 = jnp.sum((proj - q[None]) ** 2, axis=-1)  # (H, N)
    inl = (d2 < distance_threshold**2) & ok[None, :]
    n_inl = jnp.sum(inl, axis=1)
    n_inl = jnp.where(edge_ok, n_inl, -1)
    best = jnp.argmax(n_inl)

    # refine: weighted Kabsch on the best hypothesis's inliers (2 rounds)
    T_R, T_t = R[best], t[best]
    for _ in range(2):
        proj1 = jnp.matmul(src, T_R.T, precision=_PP) + T_t
        d2b = jnp.sum((proj1 - q) ** 2, axis=-1)
        w_in = ((d2b < distance_threshold**2) & ok).astype(jnp.float32)
        T_R, T_t = _kabsch(src, q, w_in)

    proj1 = jnp.matmul(src, T_R.T, precision=_PP) + T_t
    d2b = jnp.sum((proj1 - q) ** 2, axis=-1)
    inl_f = (d2b < distance_threshold**2) & ok
    n_f = jnp.sum(inl_f.astype(jnp.int32))
    fitness = n_f / jnp.maximum(n_corr, 1)
    rmse = jnp.sqrt(jnp.sum(jnp.where(inl_f, d2b, 0.0)) / jnp.maximum(n_f, 1))

    T = jnp.eye(4, dtype=jnp.float32)
    T = T.at[:3, :3].set(T_R).at[:3, 3].set(T_t)
    return RANSACResult(T=T, fitness=fitness, inlier_rmse=rmse, n_correspondences=n_corr)


def global_registration(src_points, src_feat, src_mask, tgt_points, tgt_feat,
                        tgt_mask, key, cfg: RegistrationConfig = RegistrationConfig(),
                        distance_threshold=None) -> RANSACResult:
    """FPFH match + RANSAC: the reference's ``global_registration``
    (GoodColorReconstruction.py:161-187, CreateMesh.py:221-271)."""
    feat_ok_s = src_mask & (jnp.sum(jnp.abs(src_feat), axis=1) > 0)
    feat_ok_t = tgt_mask & (jnp.sum(jnp.abs(tgt_feat), axis=1) > 0)
    corr = match_features(src_feat, tgt_feat, feat_ok_s, feat_ok_t, mutual=True)
    return ransac_registration(src_points, tgt_points, corr, key, cfg,
                               distance_threshold)
