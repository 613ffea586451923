"""Normal estimation.

Two forms, replacing Open3D's ``estimate_normals`` + orientation passes
(reference CreateMesh.py:604-607, azure-kinect-DK/Reconstruction/
Reconstruction.py:80-95, orient_normals_consistent_tangent_plane at
Reconstruction-ResourceEfficient.py:169):

- :func:`organized_normals` — O(1)-neighborhood cross-product normals on an
  organized depth/point map (the device-friendly path used by projective ICP and
  live viz; fully fused elementwise math, no neighbor search at all).
- :func:`estimate_normals_grid` — local-PCA normals for unorganized clouds
  using voxel-grid hashing for neighborhoods (fixed K candidates/cell instead
  of a KD-tree; see ops.neighbors).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PP = jax.lax.Precision.HIGHEST


def organized_normals(points, max_edge: float = 0.1):
    """(H, W, 3) organized camera/world-space points -> (H, W, 3) unit
    normals oriented toward the camera (-z half-space for camera frames).

    Uses central differences with validity gating: a normal is zero where any
    required neighbor is invalid or an edge longer than ``max_edge`` (a depth
    discontinuity) crosses the stencil.
    """
    p = jnp.asarray(points)
    valid = p[..., 2] > 0

    right = jnp.roll(p, -1, axis=1)
    left = jnp.roll(p, 1, axis=1)
    down = jnp.roll(p, -1, axis=0)
    up = jnp.roll(p, 1, axis=0)
    vr = jnp.roll(valid, -1, axis=1)
    vl = jnp.roll(valid, 1, axis=1)
    vd = jnp.roll(valid, -1, axis=0)
    vu = jnp.roll(valid, 1, axis=0)

    du = right - left
    dv = down - up
    n = jnp.cross(du, dv)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)

    ok = (
        valid & vr & vl & vd & vu
        & (jnp.linalg.norm(du, axis=-1) < max_edge)
        & (jnp.linalg.norm(dv, axis=-1) < max_edge)
        & (norm[..., 0] > 1e-12)
    )
    # orient toward the camera: points are in camera frame, camera at origin
    flip = jnp.sum(n * p, axis=-1) > 0
    n = jnp.where(flip[..., None], -n, n)
    n = jnp.where(ok[..., None], n, 0.0)
    # zero the border rows/cols (roll wraps around)
    n = n.at[0].set(0.0).at[-1].set(0.0)
    n = n.at[:, 0].set(0.0).at[:, -1].set(0.0)
    return n


def pca_normal(neighbors, mask):
    """Smallest-eigenvector normal of a (K, 3) neighborhood with (K,) mask.
    Closed-form 3x3 eigen via the cross-product-of-differences trick is
    unstable; use one step of inverse iteration on the covariance."""
    w = mask.astype(jnp.float32)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=-2), 1.0)
    mean = jnp.sum(neighbors * w, axis=-2, keepdims=True) / cnt[..., None, :]
    d = (neighbors - mean) * w
    cov = jnp.matmul(jnp.swapaxes(d, -1, -2), d, precision=_PP) / cnt[..., None]
    # smallest eigenvector via eigh (3x3 batched — cheap, stable)
    wvals, vecs = jnp.linalg.eigh(cov)
    return vecs[..., 0]  # ascending order: first column = smallest eigenvalue


def orient_normals_consistent(points, normals, mask, radius: float,
                              k: int = 16):
    """Flip normals so neighboring normals agree — Open3D
    ``orient_normals_consistent_tangent_plane`` analog (reference
    azure-kinect-DK/Reconstruction/Reconstruction-ResourceEfficient.py:169
    orients the accumulated model cloud this way on save).

    The kNN graph comes from the device grid hash (ops.neighbors); sign
    propagation is a level-synchronous host BFS (numpy-batched per
    frontier) assigning each point a +-1 sign relative to its component's
    seed, then each component takes the GLOBAL sign that agrees with the
    MAJORITY of its incoming normals — so a viewpoint-oriented input (the
    usual case: estimate_normals_knn already oriented toward the camera)
    keeps its correct global orientation for interior scans as well as
    exterior ones, and the pass only repairs local inconsistencies.
    Offline save-time operation (SURVEY.md §2.2)."""
    import numpy as np

    from azurekinect3dreconstruction_tpu.ops.neighbors import (
        auto_capacity,
        build_cell_lists,
        knn_gather,
    )

    pts = jnp.asarray(points, jnp.float32)
    n = pts.shape[0]
    cells = build_cell_lists(pts, mask, radius, auto_capacity(n),
                             max_per_cell=8)
    idx, _ = knn_gather(cells, pts, pts, mask, k=k, max_radius=radius)
    idx = np.asarray(idx)
    m = np.asarray(mask)
    nr0 = np.array(jnp.asarray(normals, jnp.float32))
    sign = np.zeros(n, np.int8)  # 0 = unvisited; +-1 = sign vs component seed

    # SYMMETRIZED edge list: grid-hash kNN is asymmetric (cell overflow can
    # drop a point from candidate lists while it still has outgoing
    # neighbors), and a forward-only traversal would strand such points
    src0 = np.repeat(np.arange(n), idx.shape[1])
    dst0 = idx.reshape(-1)
    e_ok = (dst0 >= 0) & (dst0 != src0) & m[src0] & m[np.maximum(dst0, 0)]
    src = np.concatenate([src0[e_ok], dst0[e_ok]])
    dst = np.concatenate([dst0[e_ok], src0[e_ok]])
    # CSR adjacency so each BFS level touches only its frontier's edges
    # (scanning the whole edge array per level would be
    # O(components * edges) on fragmented clouds)
    eorder = np.argsort(src, kind="stable")
    src, dst = src[eorder], dst[eorder]
    starts = np.searchsorted(src, np.arange(n + 1))

    def frontier_edges(frontier):
        base = starts[frontier]
        cnt = starts[frontier + 1] - base
        total = int(cnt.sum())
        if not total:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        first = np.cumsum(cnt) - cnt
        eidx = (np.arange(total) - np.repeat(first, cnt)
                + np.repeat(base, cnt))
        return src[eidx], dst[eidx]

    for seed in range(n):
        if sign[seed] != 0 or not m[seed]:
            continue
        sign[seed] = 1
        comp = [seed]
        frontier = np.array([seed])
        while frontier.size:
            parent, child = frontier_edges(frontier)
            keep = sign[child] == 0 if child.size else np.empty(0, bool)
            parent, child = parent[keep], child[keep]
            if not child.size:
                break
            # one parent per child (first occurrence wins)
            child, first = np.unique(child, return_index=True)
            parent = parent[first]
            agree = np.einsum("ij,ij->i", nr0[child], nr0[parent]) >= 0
            sign[child] = np.where(agree, sign[parent], -sign[parent])
            comp.extend(child.tolist())
            frontier = child
        # component global sign: keep the majority of the incoming
        # orientation (local repairs only, no global flip surprises)
        comp = np.asarray(comp)
        if sign[comp].sum() < 0:
            sign[comp] = -sign[comp]

    out = nr0 * np.where(sign == 0, 1, sign)[:, None].astype(np.float32)
    return jnp.asarray(out)
