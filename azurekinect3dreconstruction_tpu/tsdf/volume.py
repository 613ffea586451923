"""Block-hashed TSDF volume resident in device memory (functional,
jit/shard-friendly).

Device-resident replacement for Open3D's ``ScalableTSDFVolume``
(``integrate`` / ``extract_triangle_mesh`` / ``extract_point_cloud`` /
``reset`` used at reference CreateMesh.py:286-336,
CodeThatWorks/1camera-detectsSceneChanges.py:78-82,270-291,
bundlefusion_reconstruction.py:108-112, capture_frames.py:18-23).

Design (SURVEY.md §7.3): a fixed-capacity pool of ``block_resolution``^3
voxel blocks plus a vectorized open-addressing hash (:mod:`.hash`). Both
phases of integration are data-parallel with static shapes:

1. **allocate**: backproject a (strided) pixel grid, sample a few points
   along each ray inside the truncation band, quantize to block coords,
   batch insert-or-get into the hash. Deduplication is a side effect of the
   scatter-claim insert.
2. **update**: frustum-cull the live blocks into a worklist, gather those
   pool rows, project their R^3 voxel centers into the depth image and fuse
   (running weighted average, truncation band, weight clamp), then scatter
   the rows back (:func:`integrate_worklist`). :func:`integrate` does the
   same over every pool row and is the plain reference.

Pose convention: ``integrate`` takes **camera-to-world** (see core.se3); the
reference's inconsistent forward/inverse usage is documented there.

The state is a NamedTuple pytree: donate it through jit for in-place HBM
updates, or shard the leading (block) axis across a device mesh — block
identity is position-independent, so sharding is trivial (see
parallel.sharded_volume).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.config import TSDFConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.tsdf import hash as vhash


class TSDFVolume(NamedTuple):
    """The complete volume state (a pytree of fixed-shape arrays)."""

    table_keys: jax.Array  # int32[hash_capacity]
    table_vals: jax.Array  # int32[hash_capacity]
    n_blocks: jax.Array  # int32[] allocated block count
    block_coords: jax.Array  # int32[capacity, 3] grid coords of each block
    # voxel arrays are stored as (capacity, R^3/128, 128) (color:
    # (capacity, 3, R^3/128, 128)); voxel lin = x*R^2 + y*R + z sits at
    # [lin // 128, lin % 128]. Consumers reshape to (capacity, R^3) freely.
    tsdf: jax.Array  # f32[capacity, R^3/128, 128], normalized sdf in [-1, 1]
    weight: jax.Array  # f32[capacity, R^3/128, 128]
    color: jax.Array  # f32[capacity, 3, R^3/128, 128] channel-major
    overflow: jax.Array  # bool[] sticky pool-exhausted flag

    @property
    def table(self) -> vhash.HashTable:
        return vhash.HashTable(self.table_keys, self.table_vals)


def create(cfg: TSDFConfig) -> TSDFVolume:
    """Fresh volume. Also the implementation of ``reset()`` — the reference's
    'C' key / scene-change reset (1camera-detectsSceneChanges.py:202-212)
    just swaps in a new state pytree."""
    n = cfg.block_capacity
    r3 = cfg.block_resolution**3
    assert r3 % 128 == 0, "block_resolution^3 must be a multiple of 128"
    s128 = r3 // 128
    t = vhash.HashTable.empty(cfg.hash_capacity)
    return TSDFVolume(
        table_keys=t.keys,
        table_vals=t.vals,
        n_blocks=jnp.zeros((), jnp.int32),
        block_coords=jnp.zeros((n, 3), jnp.int32),
        tsdf=jnp.zeros((n, s128, 128), jnp.float32),
        weight=jnp.zeros((n, s128, 128), jnp.float32),
        color=jnp.zeros((n, 3, s128, 128), jnp.float32),
        overflow=jnp.zeros((), jnp.bool_),
    )


def reset(cfg: TSDFConfig) -> TSDFVolume:
    return create(cfg)


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "stride", "samples", "dedup_budget"))
def allocate(vol: TSDFVolume, depth, rays, T_world_cam, cfg: TSDFConfig,
             stride: int = 2, samples: int = 3,
             dedup_budget: int = 2048) -> TSDFVolume:
    """Ensure blocks exist along every ray's truncation band.

    depth: (H, W) meters (0 = invalid); rays: (H, W, 2) from pixel_rays.

    Candidate keys are massively duplicated (adjacent pixels share blocks,
    ~50-500x), so the hash insert would dominate if fed raw candidates. A
    sort + adjacent-diff dedups them to <= dedup_budget unique keys first;
    the probing insert then touches only ~1-5k keys.
    """
    d = jnp.asarray(depth)[::stride, ::stride]
    r = jnp.asarray(rays)[::stride, ::stride]
    T = jnp.asarray(T_world_cam, jnp.float32)

    valid = d > 0.0
    # camera-space surface points p = (xn*z, yn*z, z); band samples scale p
    # radially so they stay on the pixel ray.
    p = jnp.concatenate([r * d[..., None], d[..., None]], axis=-1)
    offs = jnp.linspace(-cfg.sdf_trunc, cfg.sdf_trunc, samples, dtype=jnp.float32)
    scale = 1.0 + offs[:, None, None] / jnp.maximum(d, 1e-6)[None]  # (S, h, w)
    pts = p[None] * scale[..., None]  # (S, h, w, 3)
    world = se3.transform_points(T, pts.reshape(-1, 3))
    coords = jnp.floor(world / cfg.block_size).astype(jnp.int32)
    keys = vhash.pack_key(coords)
    keys = jnp.where(jnp.tile(valid.reshape(-1), samples), keys, vhash.EMPTY_KEY)

    # dedup: sort (EMPTY = -1 sorts first), keep first of each run
    skeys = jnp.sort(keys)
    first = jnp.concatenate([skeys[:1] != vhash.EMPTY_KEY,
                             (skeys[1:] != skeys[:-1]) & (skeys[1:] != vhash.EMPTY_KEY)])
    order = jnp.cumsum(first.astype(jnp.int32)) - 1
    n_unique = order[-1] + 1
    dst = jnp.where(first & (order < dedup_budget), order, dedup_budget)
    ukeys = jnp.full((dedup_budget,), vhash.EMPTY_KEY, jnp.int32).at[dst].set(
        skeys, mode="drop"
    )
    # dedup overflow is SELF-HEALING, not an error: keys past the budget are
    # simply allocated by a later frame's allocate (surfaces are observed by
    # hundreds of pixels across many frames), so it does not set the sticky
    # overflow flag. Insert cost is gather-bound and linear in the budget —
    # keep it snug.

    # the last pool row is never allocated (a full pool holds capacity - 1
    # blocks; the streaming manager's sizing relies on it). 6 probe rounds suffice at the low load factors the config enforces
    # (hash_capacity >= 2x blocks); rare unresolved keys also retry on the
    # next frame's allocate.
    table, counter, vals, overflowed = vhash.insert(
        vol.table, vol.n_blocks, ukeys, jnp.int32(cfg.block_capacity - 1),
        max_probes=6,
    )
    # record coords of (possibly fresh) slots; duplicates write equal values
    idx = jnp.where(vals >= 0, vals, cfg.block_capacity)  # MISS -> dropped
    block_coords = vol.block_coords.at[idx].set(vhash.unpack_key(ukeys), mode="drop")
    return vol._replace(
        table_keys=table.keys,
        table_vals=table.vals,
        n_blocks=counter,
        block_coords=block_coords,
        overflow=vol.overflow | overflowed,
    )


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------


def voxel_world_centers(block_coords, cfg: TSDFConfig):
    """(N, 3) block coords -> (N, R^3, 3) world-space voxel centers."""
    R = cfg.block_resolution
    lin = jax.lax.broadcasted_iota(jnp.int32, (R * R * R, 1), 0)[:, 0]
    ijk = jnp.stack([lin // (R * R), (lin // R) % R, lin % R], axis=-1)  # x,y,z fast->slow? x slow
    base = block_coords[:, None, :] * R
    return (base + ijk[None] + 0.5).astype(jnp.float32) * cfg.voxel_size


def observe_rows(block_coords, active, depth, color, T_world_cam,
                 intr: Intrinsics, cfg: TSDFConfig):
    """One frame's observation of every voxel of the given blocks: project
    the voxel centers, take the nearest depth/colour pixel, keep voxels in
    front of (or within the truncation band behind) the surface.

    block_coords: (B, 3); active: (B, 1) bool rows allowed to change.
    Returns (upd (B, R^3) bool, tsdf_obs (B, R^3), colour (B, 3, R^3))."""
    T_cw = se3.inverse(jnp.asarray(T_world_cam, jnp.float32))
    pts_w = voxel_world_centers(block_coords, cfg)  # (B, V, 3)
    pts_c = se3.transform_points(T_cw, pts_w.reshape(-1, 3)).reshape(pts_w.shape)

    z = pts_c[..., 2]
    safe_z = jnp.maximum(z, 1e-6)
    u = pts_c[..., 0] / safe_z * intr.fx + intr.cx
    v = pts_c[..., 1] / safe_z * intr.fy + intr.cy
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    inb = (z > 1e-4) & (ui >= 0) & (vi >= 0) & (ui < intr.width) & (vi < intr.height)
    uic = jnp.clip(ui, 0, intr.width - 1)
    vic = jnp.clip(vi, 0, intr.height - 1)

    d = jnp.asarray(depth)[vic, uic]  # (B, V) gather
    sdf = d - z
    upd = inb & (d > 0.0) & (sdf > -cfg.sdf_trunc) & active
    tsdf_obs = jnp.minimum(sdf / cfg.sdf_trunc, 1.0)
    c = jnp.asarray(color)[vic, uic]  # (B, V, 3)
    return upd, tsdf_obs, jnp.swapaxes(c, 1, 2)  # channel-major like the pool


def _fuse_rows(t_v, w_v, c_v, block_coords, active, depth, color,
               T_world_cam, intr: Intrinsics, cfg: TSDFConfig):
    """The per-voxel fusion arithmetic shared by both integrate forms.

    t_v, w_v: (B, R^3) rows; c_v: (B, 3, R^3). Returns the updated
    (t_v, w_v, c_v): running weighted average and weight clamp of
    :func:`observe_rows`' observation."""
    upd, tsdf_obs, c = observe_rows(block_coords, active, depth, color,
                                    T_world_cam, intr, cfg)
    w_new = jnp.where(upd, jnp.minimum(w_v + 1.0, cfg.max_integration_weight), w_v)
    inv = 1.0 / jnp.maximum(w_v + 1.0, 1.0)
    t_new = jnp.where(upd, (t_v * w_v + tsdf_obs) * inv, t_v)
    c_new = jnp.where(upd[:, None, :], (c_v * w_v[:, None, :] + c) * inv[:, None, :],
                      c_v)
    return t_new, w_new, c_new


@partial(jax.jit, static_argnames=("cfg", "intr"), donate_argnames=("vol",))
def integrate(vol: TSDFVolume, depth, color, T_world_cam, intr: Intrinsics,
              cfg: TSDFConfig) -> TSDFVolume:
    """Fuse one registered RGB-D frame into EVERY pool row (update phase
    only — call :func:`allocate` first). The plain reference that
    :func:`integrate_worklist` is tested against.

    depth: (H, W) f32 meters; color: (H, W, 3) f32 in [0,1];
    T_world_cam: camera-to-world.
    """
    N_ = vol.tsdf.shape[0]
    V_ = cfg.block_resolution ** 3
    alive = jax.lax.broadcasted_iota(jnp.int32, (N_, 1), 0) < vol.n_blocks
    t, w, c = _fuse_rows(vol.tsdf.reshape(N_, V_), vol.weight.reshape(N_, V_),
                         vol.color.reshape(N_, 3, V_), vol.block_coords, alive,
                         depth, color, T_world_cam, intr, cfg)
    return vol._replace(tsdf=t.reshape(vol.tsdf.shape),
                        weight=w.reshape(vol.weight.shape),
                        color=c.reshape(vol.color.shape))


# worklist sizes ladder for the eager path (static shapes -> one compile
# per rung); fused steps take one static size and flag overflow instead
WORKLIST_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)


@partial(jax.jit, static_argnames=("cfg", "intr"))
def build_worklist(block_coords, n_blocks, T_world_cam, intr: Intrinsics,
                   cfg: TSDFConfig):
    """Frustum-cull the live blocks. Returns (slots int32[N], n_active):
    a permutation of the pool rows with the visible blocks first, so any
    prefix of it holds distinct slots.

    Conservative by construction: a block is culled only when no voxel
    center in it can pass :func:`_fuse_rows`' in-image test. Its corners'
    projections bound every voxel's (perspective maps the block's convex
    hull to the corners' hull when all corners are in front); a block with
    a corner at or behind the camera plane is kept unless every corner is.
    """
    N = block_coords.shape[0]
    R = cfg.block_resolution
    T_cw = se3.inverse(jnp.asarray(T_world_cam, jnp.float32))
    corners = jnp.asarray(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
         [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]], jnp.float32)
    pw = (block_coords[:, None, :].astype(jnp.float32) + corners[None]) * (
        R * cfg.voxel_size)  # (N, 8, 3)
    pc = se3.transform_points(T_cw, pw.reshape(-1, 3)).reshape(N, 8, 3)
    z = pc[..., 2]
    behind = z <= 1e-4
    zs = jnp.maximum(z, 1e-4)
    u = pc[..., 0] / zs * intr.fx + intr.cx
    v = pc[..., 1] / zs * intr.fy + intr.cy
    any_behind = jnp.any(behind, 1)
    # one pixel of slack: a voxel at u = -0.4 still rounds into column 0
    in_view = ((jnp.max(u, 1) > -1.0) & (jnp.min(u, 1) < intr.width)
               & (jnp.max(v, 1) > -1.0) & (jnp.min(v, 1) < intr.height))
    alive = jax.lax.broadcasted_iota(jnp.int32, (N,), 0) < n_blocks
    visible = alive & ~jnp.all(behind, 1) & (any_behind | in_view)

    vis_i = visible.astype(jnp.int32)
    n_active = jnp.sum(vis_i)
    dst = jnp.where(visible, jnp.cumsum(vis_i) - 1,
                    n_active + jnp.cumsum(1 - vis_i) - 1)
    slots = jnp.zeros((N,), jnp.int32).at[dst].set(
        jax.lax.broadcasted_iota(jnp.int32, (N,), 0), unique_indices=True)
    return slots, n_active


@partial(jax.jit, static_argnames=("cfg", "intr", "worklist_size"),
         donate_argnames=("vol",))
def integrate_worklist(vol: TSDFVolume, depth, color, T_world_cam,
                       intr: Intrinsics, cfg: TSDFConfig,
                       worklist_size: int = 2048) -> TSDFVolume:
    """Fuse one frame into the frustum-visible blocks only (update phase —
    call :func:`allocate` first). Same result as :func:`integrate` while at
    most ``worklist_size`` blocks are visible: the visible rows are
    gathered, fused by the same arithmetic and scattered back. Beyond that
    the excess visible blocks are skipped for this frame and the sticky
    ``overflow`` flag is set."""
    N = vol.tsdf.shape[0]
    V = cfg.block_resolution ** 3
    M = min(worklist_size, N)
    slots, n_active = build_worklist(vol.block_coords, vol.n_blocks,
                                     T_world_cam, intr, cfg)
    rows = slots[:M]
    t_pool = vol.tsdf.reshape(N, V)
    w_pool = vol.weight.reshape(N, V)
    c_pool = vol.color.reshape(N, 3, V)
    active = jax.lax.broadcasted_iota(jnp.int32, (M, 1), 0) < n_active
    t, w, c = _fuse_rows(t_pool[rows], w_pool[rows], c_pool[rows],
                         vol.block_coords[rows], active, depth, color,
                         T_world_cam, intr, cfg)
    put = lambda pool, x: pool.at[rows].set(x, unique_indices=True)
    return vol._replace(
        tsdf=put(t_pool, t).reshape(vol.tsdf.shape),
        weight=put(w_pool, w).reshape(vol.weight.shape),
        color=put(c_pool, c).reshape(vol.color.shape),
        overflow=vol.overflow | (n_active > M))


def integrate_frame(vol: TSDFVolume, depth, color, rays, T_world_cam,
                    intr: Intrinsics, cfg: TSDFConfig, stride: int = 2,
                    worklist_size: Optional[int] = None) -> TSDFVolume:
    """allocate + worklist integrate (the per-frame hot path).

    With a static ``worklist_size`` this is pure traced work, safe inside
    jit / lax.scan (every fused pipeline step calls it so). With ``None``
    (eager callers) it reads the visible-block count back and picks the
    smallest :data:`WORKLIST_SIZES` rung that holds it, so nothing is
    skipped.
    """
    vol = allocate(vol, depth, rays, T_world_cam, cfg, stride=stride)
    if worklist_size is None:
        _, n_active = build_worklist(vol.block_coords, vol.n_blocks,
                                     T_world_cam, intr, cfg)
        na = int(n_active)
        worklist_size = next((m for m in WORKLIST_SIZES if m >= na),
                             vol.tsdf.shape[0])
    return integrate_worklist(vol, depth, color, T_world_cam, intr, cfg,
                              worklist_size=worklist_size)


# ---------------------------------------------------------------------------
# queries / extraction helpers
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg",))
def sample_tsdf(vol: TSDFVolume, points, cfg: TSDFConfig):
    """Nearest-voxel TSDF/weight lookup at world points (N, 3) — used by
    golden tests and by frame-to-model tracking."""
    pts = jnp.asarray(points, jnp.float32)
    R = cfg.block_resolution
    vox = jnp.floor(pts / cfg.voxel_size).astype(jnp.int32)
    bc = jnp.floor_divide(vox, R)
    local = vox - bc * R
    slot = vhash.lookup(vol.table, vhash.pack_key(bc))
    lin = local[..., 0] * R * R + local[..., 1] * R + local[..., 2]
    ok = slot >= 0
    slot_c = jnp.where(ok, slot, 0)
    t = vol.tsdf[slot_c, lin // 128, lin % 128]
    w = vol.weight[slot_c, lin // 128, lin % 128]
    return jnp.where(ok, t, 1.0), jnp.where(ok, w, 0.0)


def extract_point_cloud(vol: TSDFVolume, cfg: TSDFConfig, max_points: Optional[int] = None):
    """Surface points by zero-crossing interpolation along +x/+y/+z within
    each block (parity target: ScalableTSDFVolume.extract_point_cloud,
    reference GoodColorReconstruction.py:536-541). Returns a host-side
    compacted (points, colors) pair."""
    import numpy as onp

    n = int(vol.n_blocks)
    if n == 0:
        return onp.zeros((0, 3), onp.float32), onp.zeros((0, 3), onp.float32)
    R = cfg.block_resolution
    tsdf = onp.asarray(vol.tsdf[:n]).reshape(n, R, R, R)
    weight = onp.asarray(vol.weight[:n]).reshape(n, R, R, R)
    color = onp.asarray(vol.color[:n]).reshape(n, 3, R * R * R).transpose(0, 2, 1).reshape(n, R, R, R, 3)
    coords = onp.asarray(vol.block_coords[:n])
    pts, cols = host_interior_crossings(tsdf, weight, color, coords, cfg)
    if max_points is not None and pts.shape[0] > max_points:
        sel = onp.random.RandomState(0).choice(pts.shape[0], max_points, replace=False)
        pts, cols = pts[sel], cols[sel]
    return pts, cols


def host_interior_crossings(tsdf, weight, color, coords, cfg: TSDFConfig):
    """The numpy crossing math behind :func:`extract_point_cloud`, on
    already-pulled per-block arrays — shared with the streaming manager,
    which runs it over its HOST-stored (evicted) blocks so full-scene cloud
    exports include them. tsdf/weight: (n, R, R, R); color: (n, R, R, R, 3);
    coords: (n, 3)."""
    import numpy as onp

    R = cfg.block_resolution
    pts_out = []
    col_out = []
    # host-side: numpy vectorized per axis (block-interior crossings only; the
    # marching-cubes path handles cross-block faces exactly)
    for axis in range(3):
        sl_a = [slice(None), slice(0, R - 1), slice(None), slice(None)]
        sl_b = [slice(None), slice(0, R - 1), slice(None), slice(None)]
        sl_b[axis + 1] = slice(1, R)
        sl_a[axis + 1] = slice(0, R - 1)
        t0 = tsdf[tuple(sl_a)]
        t1 = tsdf[tuple(sl_b)]
        w0 = weight[tuple(sl_a)]
        w1 = weight[tuple(sl_b)]
        cross = (w0 > 0) & (w1 > 0) & (onp.sign(t0) != onp.sign(t1)) & (t0 != 0)
        bi, xi, yi, zi = onp.nonzero(cross)
        if bi.size == 0:
            continue
        base = coords[bi] * R + onp.stack([xi, yi, zi], axis=-1)
        frac = t0[bi, xi, yi, zi] / (t0[bi, xi, yi, zi] - t1[bi, xi, yi, zi])
        p = (base + 0.5).astype(onp.float32)
        p[:, axis] += frac
        pts_out.append(p * cfg.voxel_size)
        c0 = color[tuple(sl_a)][bi, xi, yi, zi]
        c1 = color[tuple(sl_b)][bi, xi, yi, zi]
        col_out.append(c0 * (1 - frac[:, None]) + c1 * frac[:, None])

    if not pts_out:
        return onp.zeros((0, 3), onp.float32), onp.zeros((0, 3), onp.float32)
    return onp.concatenate(pts_out), onp.concatenate(col_out)


def memory_bytes(cfg: TSDFConfig) -> int:
    """HBM footprint of a volume with this config."""
    n, r3 = cfg.block_capacity, cfg.block_resolution**3
    return n * r3 * 4 * (1 + 1 + 3) + cfg.hash_capacity * 8 + n * 12


@partial(jax.jit, static_argnames=("cfg", "max_points", "extract_blocks"))
def extract_point_cloud_device(vol: TSDFVolume, cfg: TSDFConfig,
                               max_points: int = 65536,
                               extract_blocks: int = None):
    """Device-side surface points by zero-crossing along +x/+y/+z.

    Returns (points (max_points, 3), colors (max_points, 3), mask) — all on
    device, fixed capacity. This is the ``extract_point_cloud``-style API
    (colored surface samples); the frame-to-model PIPELINE
    (pipelines.mono_odometry_tsdf) sources its model from budget-bounded
    marching-cubes vertices instead, which share the extraction fast path
    and subsample without pool-order bias.
    """
    R = cfg.block_resolution
    N = vol.tsdf.shape[0]
    E = min(extract_blocks or N, N)
    t4 = vol.tsdf[:E].reshape(E, R, R, R)
    w4 = vol.weight[:E].reshape(E, R, R, R)
    c4 = vol.color[:E].reshape(E, 3, R, R, R)
    coords = vol.block_coords[:E]
    alive = (jax.lax.broadcasted_iota(jnp.int32, (E, 1, 1, 1), 0) < vol.n_blocks)

    pts_parts, col_parts, m_parts = [], [], []
    for axis in range(3):
        sl_a = [slice(None)] * 4
        sl_b = [slice(None)] * 4
        sl_a[axis + 1] = slice(0, R - 1)
        sl_b[axis + 1] = slice(1, R)
        t0 = t4[tuple(sl_a)]
        t1 = t4[tuple(sl_b)]
        w0 = w4[tuple(sl_a)]
        w1 = w4[tuple(sl_b)]
        cross = (w0 > 0) & (w1 > 0) & (jnp.sign(t0) != jnp.sign(t1)) & (t0 != 0)
        cross = cross & alive[:, : cross.shape[1], : cross.shape[2], : cross.shape[3]]
        frac = t0 / jnp.where(jnp.abs(t0 - t1) > 1e-12, t0 - t1, 1e-12)
        sh = t0.shape
        fr = jnp.clip(frac, 0.0, 1.0)
        # per-coordinate (no trailing 3-dim: it would lane-pad 3 -> 128)
        p = []
        for k in range(3):
            loc = (jax.lax.broadcasted_iota(jnp.int32, sh, k + 1)
                   .astype(jnp.float32) + 0.5)
            if k == axis:
                loc = loc + fr
            base_k = coords[:, None, None, None, k].astype(jnp.float32) * R
            p.append((base_k + loc) * cfg.voxel_size)
        p = jnp.stack(p, axis=0)  # (3, E, ...) — 3 on the MAJOR axis
        csel_a = [slice(None), slice(None)] + sl_a[1:]
        csel_b = [slice(None), slice(None)] + sl_b[1:]
        c0 = c4[tuple(csel_a)]
        c1 = c4[tuple(csel_b)]
        cmix = c0 + jnp.clip(frac, 0, 1)[:, None] * (c1 - c0)  # (E,3,...)
        # per-coordinate FLAT arrays: an (M, 3) layout lane-pads 3 -> 128
        # (42x memory — tens of GB at full pool scale)
        pts_parts.append([p[k].reshape(-1) for k in range(3)])
        col_parts.append([cmix[:, k].reshape(-1) for k in range(3)])
        m_parts.append(cross.reshape(-1))

    m = jnp.concatenate(m_parts)
    order = jnp.cumsum(m.astype(jnp.int32)) - 1
    dst = jnp.where(m & (order < max_points), order, max_points)
    outs = []
    for parts in (pts_parts, col_parts):
        chans = []
        for k in range(3):
            flat = jnp.concatenate([a[k] for a in parts])
            chans.append(jnp.zeros((max_points + 1,), jnp.float32)
                         .at[dst].set(flat, mode="drop")[:max_points])
        outs.append(jnp.stack(chans, axis=-1))
    out_p, out_c = outs
    n = jnp.minimum(order[-1] + 1, max_points)
    mask = jax.lax.broadcasted_iota(jnp.int32, (max_points, 1), 0)[:, 0] < n
    return out_p, out_c, mask
