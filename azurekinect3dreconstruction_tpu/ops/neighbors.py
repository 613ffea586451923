"""Voxel-grid neighbor machinery for unorganized point clouds (no KD-trees).

Open3D backs ``voxel_down_sample`` / ``remove_statistical_outlier`` /
``estimate_normals`` / FPFH on a C++ KDTreeFlann (used at reference
CreateMesh.py:581-607, azure-kinect-DK/Reconstruction/Reconstruction.py:80-95).
KD-trees are pointer-chasing machines — hostile to accelerators. Everything here is
built from two fixed-shape primitives instead:

- ``sort`` by packed voxel key (runs of equal keys = points in one cell)
- the scatter-claim spatial hash from :mod:`..tsdf.hash` (cell -> slot)

giving voxel means (downsample), fixed-fanout cell lists, and K-nearest
queries over the 27-cell neighborhood — all static shapes, all batched.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from azurekinect3dreconstruction_tpu.tsdf import hash as vhash


def _cell_keys(points, mask, cell_size):
    coords = jnp.floor(jnp.asarray(points) / cell_size).astype(jnp.int32)
    coords = jnp.clip(coords, -511, 511)
    keys = vhash.pack_key(coords)
    return jnp.where(mask, keys, vhash.EMPTY_KEY)


@partial(jax.jit, static_argnames=("capacity",))
def voxel_downsample_arrays(points, mask, voxel_size, capacity: int,
                            colors=None, normals=None):
    """Voxel-mean downsample (Open3D ``voxel_down_sample`` semantics:
    centroid of points per voxel; colors/normals averaged too).

    Returns (points, mask, colors, normals) with fixed capacity.
    """
    pts = jnp.asarray(points, jnp.float32)
    n = pts.shape[0]
    keys = _cell_keys(pts, mask, voxel_size)
    table, counter, vals, _ = vhash.insert(
        vhash.HashTable.empty(2 * _next_pow2(capacity)),
        jnp.zeros((), jnp.int32), keys, jnp.int32(capacity),
    )
    slot = jnp.where(vals >= 0, vals, capacity)  # overflow/invalid -> dropped

    def accum(a, width):
        out = jnp.zeros((capacity + 1, width), jnp.float32)
        return out.at[slot].add(a, mode="drop")[:capacity]

    cnt = accum(mask.astype(jnp.float32)[:, None], 1)
    denom = jnp.maximum(cnt, 1.0)
    out_pts = accum(pts * mask[:, None], 3) / denom
    out_mask = cnt[:, 0] > 0
    out_cols = None if colors is None else accum(jnp.asarray(colors) * mask[:, None], 3) / denom
    out_nrm = None
    if normals is not None:
        s = accum(jnp.asarray(normals) * mask[:, None], 3)
        out_nrm = s / jnp.maximum(jnp.linalg.norm(s, axis=-1, keepdims=True), 1e-12)
    return out_pts, out_mask, out_cols, out_nrm


@jax.jit
def count_occupied_cells(points, mask, cell_size):
    """Exact distinct-cell count at ``cell_size`` (sort + adjacent-diff —
    no table, so nothing to overflow). Callers use it to FIT a downsample
    voxel to a fixed capacity before calling voxel_downsample_arrays: a
    saturated grid silently DROPS overflow cells (the ``slot = capacity``
    drop above), and when two clouds saturate differently the surviving
    cell sets diverge — measured to break FPFH matching between a full-res
    frame and a model cloud (tracking.relocalize). ``cell_size`` is traced:
    one compile per cloud shape serves every rung of a voxel ladder."""
    keys = _cell_keys(points, mask, cell_size)
    sk = jnp.sort(keys)
    first = jnp.concatenate([sk[:1] != vhash.EMPTY_KEY,
                             (sk[1:] != sk[:-1]) & (sk[1:] != vhash.EMPTY_KEY)])
    return first.sum()


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def auto_capacity(n_points: int, floor: int = 4096) -> int:
    """Cell-table capacity that cannot overflow for ``n_points`` distinct
    cells (each point occupies at most one cell). Use this instead of the
    16384 default whenever the cloud size is not known to be small — an
    overflowing table silently drops points from neighbor queries."""
    return max(floor, _next_pow2(max(n_points, 1)))


class CellLists(NamedTuple):
    """Fixed-fanout cell -> point-index lists for neighbor queries."""

    table_keys: jax.Array
    table_vals: jax.Array
    lists: jax.Array  # int32[capacity, max_per_cell], -1 padded
    cell_size: jax.Array  # f32 scalar


@partial(jax.jit, static_argnames=("capacity", "max_per_cell"))
def build_cell_lists(points, mask, cell_size, capacity: int,
                     max_per_cell: int = 8) -> CellLists:
    """Bucket points into grid cells. Cells overflowing ``max_per_cell`` keep
    an arbitrary subset (fine for density-limited clouds: pre-downsample)."""
    pts = jnp.asarray(points, jnp.float32)
    n = pts.shape[0]
    keys = _cell_keys(pts, mask, cell_size)
    table, counter, vals, _ = vhash.insert(
        vhash.HashTable.empty(2 * _next_pow2(capacity)),
        jnp.zeros((), jnp.int32), keys, jnp.int32(capacity),
    )
    slot = jnp.where(vals >= 0, vals, capacity)

    # rank of each point within its cell: sort by slot, index within run
    order = jnp.argsort(slot)
    sorted_slot = slot[order]
    first = jnp.concatenate([jnp.ones((1,), jnp.bool_), sorted_slot[1:] != sorted_slot[:-1]])
    run_id = jnp.cumsum(first.astype(jnp.int32)) - 1
    run_start = jnp.zeros((n,), jnp.int32).at[run_id].max(
        jnp.where(first, jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0], 0))
    rank = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0] - run_start[run_id]

    lists = jnp.full((capacity + 1, max_per_cell), -1, jnp.int32)
    # overflow ranks (>= max_per_cell) are routed to the spare row `capacity`,
    # which is sliced off below -> cells keep an arbitrary max_per_cell subset
    row = jnp.where((rank < max_per_cell) & (sorted_slot < capacity),
                    sorted_slot, capacity)
    col = jnp.clip(rank, 0, max_per_cell - 1)
    lists = lists.at[row, col].set(order, mode="drop")
    return CellLists(table.keys, table.vals, lists[:capacity], jnp.float32(cell_size))


import numpy as _np

_OFFS27_NP = _np.stack(
    _np.meshgrid(_np.arange(-1, 2), _np.arange(-1, 2), _np.arange(-1, 2), indexing="ij"),
    -1,
).reshape(27, 3).astype(_np.int32)


def _offsets27():
    # numpy constant: safe to close over inside any trace
    return jnp.asarray(_OFFS27_NP)


@partial(jax.jit, static_argnames=("k",))
def knn_gather(cells: CellLists, all_points, query_points, query_mask, k: int = 16,
               max_radius=jnp.inf):
    """K nearest neighbors of each query among bucketed points.

    Returns (idx int32[Q, k] (-1 pad), dist f32[Q, k]). Candidates come from
    the 27 surrounding cells (27 * max_per_cell fixed fanout).
    """
    q = jnp.asarray(query_points, jnp.float32)
    Q = q.shape[0]
    coords = jnp.floor(q / cells.cell_size).astype(jnp.int32)
    nbr_coords = coords[:, None, :] + _offsets27()[None]  # (Q, 27, 3)
    nbr_keys = vhash.pack_key(jnp.clip(nbr_coords, -511, 511))
    slots = vhash.lookup(vhash.HashTable(cells.table_keys, cells.table_vals), nbr_keys)
    slots_c = jnp.where(slots >= 0, slots, 0)
    cand = cells.lists[slots_c]  # (Q, 27, P)
    cand = jnp.where(slots[..., None] >= 0, cand, -1)
    P = cand.shape[-1]
    cand = cand.reshape(Q, 27 * P)
    cand_ok = cand >= 0
    cand_c = jnp.where(cand_ok, cand, 0)
    cpts = jnp.asarray(all_points, jnp.float32)[cand_c]  # (Q, 27P, 3)
    d2 = jnp.sum((cpts - q[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(cand_ok & query_mask[:, None] & (d2 <= max_radius**2), d2, jnp.inf)
    # top-k smallest
    neg, idx = jax.lax.top_k(-d2, k)
    dist = jnp.sqrt(jnp.maximum(-neg, 0.0))
    nn = jnp.take_along_axis(cand, idx, axis=1)
    nn = jnp.where(jnp.isfinite(neg), nn, -1)
    dist = jnp.where(jnp.isfinite(neg), dist, jnp.inf)
    return nn, dist


@partial(jax.jit, static_argnames=("capacity", "max_per_cell", "k"))
def knn(points, mask, radius, k: int = 16, capacity: int = 16384,
        max_per_cell: int = 8):
    """Self-KNN of a masked cloud (each point excludes itself)."""
    # cell size == radius: the 27-cell neighborhood is complete only within
    # one cell size, so the query radius must not exceed it.
    cells = build_cell_lists(points, mask, radius, capacity, max_per_cell)
    nn, dist = knn_gather(cells, points, points, mask, k=k + 1, max_radius=radius)
    # drop the self match (distance 0 at the front)
    self_col = nn == jax.lax.broadcasted_iota(jnp.int32, nn.shape, 0)
    dist = jnp.where(self_col, jnp.inf, dist)
    neg, idx = jax.lax.top_k(-dist, k)
    nn2 = jnp.take_along_axis(nn, idx, axis=1)
    d2 = jnp.where(jnp.isfinite(neg), -neg, jnp.inf)
    nn2 = jnp.where(jnp.isfinite(neg), nn2, -1)
    return nn2, d2


@partial(jax.jit, static_argnames=("k", "capacity"))
def remove_statistical_outliers(points, mask, k: int = 20, std_ratio: float = 2.0,
                                capacity: int = 16384, radius: float = 0.1):
    """Open3D ``remove_statistical_outlier`` analog (reference
    CreateMesh.py:589-592): drop points whose mean K-NN distance exceeds
    global mean + std_ratio * std. Returns the updated mask."""
    nn, dist = knn(points, mask, radius, k=k, capacity=capacity)
    have = jnp.isfinite(dist)
    cnt = jnp.sum(have, axis=1)
    mean_d = jnp.sum(jnp.where(have, dist, 0.0), axis=1) / jnp.maximum(cnt, 1)
    ok = mask & (cnt > 0)
    # sparse points with NO neighbors inside the radius are outliers too
    lonely = mask & (cnt == 0)
    mu = jnp.sum(jnp.where(ok, mean_d, 0.0)) / jnp.maximum(jnp.sum(ok), 1)
    var = jnp.sum(jnp.where(ok, (mean_d - mu) ** 2, 0.0)) / jnp.maximum(jnp.sum(ok), 1)
    thr = mu + std_ratio * jnp.sqrt(var)
    return mask & ~lonely & jnp.where(ok, mean_d <= thr, False)


@partial(jax.jit, static_argnames=("k", "capacity"))
def estimate_normals_knn(points, mask, radius: float = 0.05, k: int = 16,
                         capacity: int = 16384, orient_to=None):
    """PCA normals from grid-hash KNN (Open3D ``estimate_normals`` +
    ``orient_normals_towards_camera_location`` analog)."""
    from azurekinect3dreconstruction_tpu.ops.normals import pca_normal

    nn, dist = knn(points, mask, radius, k=k, capacity=capacity)
    ok = nn >= 0
    nn_c = jnp.where(ok, nn, 0)
    neigh = jnp.asarray(points, jnp.float32)[nn_c]  # (N, k, 3)
    # include the point itself in the neighborhood
    neigh = jnp.concatenate([jnp.asarray(points, jnp.float32)[:, None, :], neigh], axis=1)
    m = jnp.concatenate([mask[:, None], ok], axis=1)
    n = pca_normal(neigh, m)
    enough = jnp.sum(ok, axis=1) >= 3
    n = jnp.where((mask & enough)[:, None], n, 0.0)
    if orient_to is not None:
        to_cam = jnp.asarray(orient_to, jnp.float32)[None, :] - jnp.asarray(points)
        flip = jnp.sum(n * to_cam, axis=-1) < 0
        n = jnp.where(flip[:, None], -n, n)
    return n
