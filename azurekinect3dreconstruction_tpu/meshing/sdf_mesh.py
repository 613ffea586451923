"""First-party cloud -> mesh: oriented-point SDF splatting + marching cubes.

The reference meshes saved clouds with Open3D's Poisson solver
(CreateMesh.py:32-70, PointCloudToMesh.py:6-119) — an octree multigrid that
is neither accelerator-shaped nor available without Open3D. This module provides the
device-native equivalent of that capability: a VRIP/SSD-style narrow-band
signed-distance field built by SPLATTING oriented points into the block-pool
volume (every operation is a fixed-shape hash lookup, elementwise kernel
weight, or scatter-add — exactly the machinery TSDF integration already
uses), then meshed by the framework's own marching cubes.

For each point p with unit normal n, every voxel center c in its
(2*reach+1)^3 neighborhood accumulates

    w = exp(-|c - p|^2 / (2 sigma^2)),   d = (c - p) . n

and the voxel's signed distance is the weighted mean sum(w d) / sum(w) —
the local first-order (tangent-plane) surface fit, clamped to the
truncation band. Like Poisson, it needs oriented normals; unlike Poisson it
cannot hallucinate surface far from data (no low-density bubble artifacts,
so no density-quantile culling step is needed — the reference culls
Poisson's bubbles at CreateMesh.py:62-64).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.config import TSDFConfig
from azurekinect3dreconstruction_tpu.core.types import PointCloudHost, TriangleMeshHost
from azurekinect3dreconstruction_tpu.tsdf import hash as vhash
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf_volume
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info, log_warning

_CORNERS = np.array([[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1]
                     for k in range(8)], np.int32)


@partial(jax.jit, static_argnames=("cfg", "reach", "dedup_budget"))
def splat_cloud(pts, nrm, cols, mask, cfg: TSDFConfig, sigma, trunc,
                reach: int = 1, dedup_budget: int = 16384):
    """Build a narrow-band SDF volume from an oriented cloud (device).

    pts/nrm/cols: (P, 3) f32 (cols in [0,1]; pass zeros if uncolored);
    mask: (P,) bool. Returns a TSDFVolume ready for marching cubes.
    """
    vol = tsdf_volume.create(cfg)
    R = cfg.block_resolution
    voxel = cfg.voxel_size

    # ---- allocation: blocks covering each point's splat AABB --------------
    lo = jnp.floor(pts / voxel).astype(jnp.int32) - reach
    hi = lo + 2 * reach  # inclusive corner of the AABB in voxel coords
    keys = []
    for c in _CORNERS:
        vwc = jnp.where(c[None, :] > 0, hi, lo)
        keys.append(vhash.pack_key(jnp.floor_divide(vwc, R)))
    keys = jnp.stack(keys, 1).reshape(-1)  # (P*8,)
    keys = jnp.where(jnp.repeat(mask, 8), keys, vhash.EMPTY_KEY)
    # sort-dedup to a fixed budget (same recipe as tsdf.allocate)
    skeys = jnp.sort(keys)
    first = jnp.concatenate(
        [skeys[:1] != vhash.EMPTY_KEY,
         (skeys[1:] != skeys[:-1]) & (skeys[1:] != vhash.EMPTY_KEY)])
    order = jnp.cumsum(first.astype(jnp.int32)) - 1
    dst = jnp.where(first & (order < dedup_budget), order, dedup_budget)
    ukeys = jnp.full((dedup_budget,), vhash.EMPTY_KEY, jnp.int32
                     ).at[dst].set(skeys, mode="drop")
    table, counter, vals, overflowed = vhash.insert(
        vol.table, vol.n_blocks, ukeys, jnp.int32(cfg.block_capacity - 1))
    idx = jnp.where(vals >= 0, vals, cfg.block_capacity)
    bc = vol.block_coords.at[idx].set(vhash.unpack_key(ukeys), mode="drop")
    vol = vol._replace(table_keys=table.keys, table_vals=table.vals,
                       n_blocks=counter, block_coords=bc,
                       overflow=vol.overflow | overflowed)

    # ---- splat: scatter-add w / w*d / w*color over the neighborhood --------
    N = cfg.block_capacity
    V = R ** 3
    idx0 = jnp.floor(pts / voxel).astype(jnp.int32)  # (P, 3)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    side = 2 * reach + 1
    offs = np.stack(np.meshgrid(*([np.arange(-reach, reach + 1)] * 3),
                                indexing="ij"), -1).reshape(-1, 3).astype(np.int32)
    table = vhash.HashTable(vol.table_keys, vol.table_vals)

    def body(i, carry):
        W, WD, WC = carry
        vw = idx0 + jnp.asarray(offs)[i]
        blk = jnp.floor_divide(vw, R)
        loc = vw - blk * R
        slot = vhash.lookup(table, vhash.pack_key(blk))
        ok = mask & (slot >= 0)
        flat = (jnp.where(ok, slot, N) * V
                + loc[:, 0] * R * R + loc[:, 1] * R + loc[:, 2])
        center = (vw.astype(jnp.float32) + 0.5) * voxel
        delta = center - pts
        d = jnp.sum(delta * nrm, axis=-1)
        w = jnp.exp(-jnp.sum(delta * delta, axis=-1) * inv2s2)
        w = jnp.where(ok, w, 0.0)
        tgt = jnp.where(ok, flat, N * V)
        W = W.at[tgt].add(w, mode="drop")
        WD = WD.at[tgt].add(w * d, mode="drop")
        WC = WC.at[:, tgt].add(w[None, :] * cols.T, mode="drop")
        return W, WD, WC

    W, WD, WC = jax.lax.fori_loop(
        0, side ** 3, body,
        (jnp.zeros((N * V,), jnp.float32), jnp.zeros((N * V,), jnp.float32),
         jnp.zeros((3, N * V), jnp.float32)))

    eps = 1e-6
    valid = W > eps
    sdf = jnp.clip(WD / jnp.maximum(W, eps) / trunc, -1.0, 1.0)
    s128 = V // 128
    return vol._replace(
        tsdf=jnp.where(valid, sdf, 0.0).reshape(N, s128, 128),
        weight=jnp.where(valid, W, 0.0).reshape(N, s128, 128),
        color=(WC / jnp.maximum(W, eps)[None]).reshape(3, N, s128, 128)
        .transpose(1, 0, 2, 3),
    )


def sdf_mesh_from_cloud(cloud: PointCloudHost, voxel: float = 0.01,
                        trunc: Optional[float] = None,
                        sigma: Optional[float] = None,
                        block_capacity: int = 8192,
                        reach: int = 1,
                        viewpoint=(0.0, 0.0, 0.0)) -> Optional[TriangleMeshHost]:
    """Host entry point: cloud -> welded, normal-equipped mesh.

    Estimates + orients normals toward ``viewpoint`` if the cloud has none
    (the reference's clouds are camera captures, so the sensor position
    orients them — Reconstruction.py:80-95 does the same via Open3D).
    """
    pts = np.asarray(cloud.points, np.float32)
    if len(pts) < 16:
        log_warning("sdf_mesh_from_cloud: too few points")
        return None
    mask = jnp.ones((len(pts),), bool)
    if cloud.normals is not None:
        nrm = jnp.asarray(cloud.normals, jnp.float32)
    else:
        from azurekinect3dreconstruction_tpu.ops.neighbors import (
            estimate_normals_knn,
        )

        nrm = estimate_normals_knn(jnp.asarray(pts), mask, radius=3 * voxel,
                                   k=12,
                                   orient_to=np.asarray(viewpoint, np.float32))
    cols = (jnp.asarray(cloud.colors, jnp.float32) if cloud.colors is not None
            else jnp.zeros((len(pts), 3), jnp.float32))
    trunc = trunc if trunc is not None else 1.5 * voxel
    sigma = sigma if sigma is not None else voxel
    cfg = TSDFConfig(voxel_size=voxel, sdf_trunc=trunc, block_resolution=8,
                     block_capacity=block_capacity,
                     hash_capacity=4 * block_capacity)
    vol = splat_cloud(jnp.asarray(pts), nrm, cols, mask, cfg,
                      jnp.float32(sigma), jnp.float32(trunc), reach=reach)
    if bool(vol.overflow):
        log_warning("sdf_mesh_from_cloud: block pool overflow — increase "
                    "block_capacity or voxel size; mesh will have holes")
    mesh = mc.extract_mesh(vol, cfg).compact()
    if cloud.colors is None:
        mesh.vertex_colors = None
    mesh = mc.weld_vertices(mesh)
    mesh.compute_vertex_normals()
    log_info(f"sdf mesh: {len(pts)} pts -> {mesh.triangles.shape[0]} tris "
             f"({int(vol.n_blocks)} blocks at {voxel * 1000:.0f}mm)")
    return mesh
