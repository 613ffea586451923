"""Multi-chip TSDF fusion: cameras x block-shards over a device mesh.

The reference's only concurrency is one capture thread per camera feeding a
queue (reference CreateMesh.py:72-189; SURVEY.md §2.3 — no distributed
anything). The scale-out story here replaces that with SPMD over a
``jax.sharding.Mesh`` with two axes:

- ``cam`` (data parallel): each camera's frame lives on its own mesh row
  (decode, allocation candidates and odometry run there); the frames are
  all_gathered over cam and every device fuses all of them into its shard
  with the frustum-worklist integrate.
- ``blk`` (spatial parallel — this project's "tensor/sequence parallelism"):
  every device owns an independent sub-volume (hash + block pool) responsible
  for the block keys that hash to its shard. Allocation broadcasts candidate
  keys over the cam axis (one ``all_gather`` of strided key sets — kilobytes)
  and each shard inserts only the keys it owns, so the pools never overlap
  and extraction is a disjoint union.

All collectives run inside one jitted ``shard_map`` step; the host never
touches per-frame data. Capacity scales linearly with blk (each shard holds
``block_capacity`` blocks), and integration work scales 1/blk (each shard
culls its worklist to the blocks it owns).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from azurekinect3dreconstruction_tpu.config import TSDFConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.tsdf import hash as vhash
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf_volume
from azurekinect3dreconstruction_tpu.tsdf.volume import TSDFVolume


def make_mesh(n_cam: int, n_blk: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_cam * n_blk, "not enough devices for mesh"
    return Mesh(devices[: n_cam * n_blk].reshape(n_cam, n_blk), ("cam", "blk"))


def _owner(keys, n_shards):
    """Which blk shard owns a packed block key (salt-mixed, load-balanced)."""
    salt = jnp.asarray(np.int64(0x9E3779B9) - (1 << 32), jnp.int32)  # wrapped
    h = vhash._mix(keys ^ salt)
    return (h % jnp.uint32(n_shards)).astype(jnp.int32)


def create_sharded(cfg: TSDFConfig, mesh: Mesh) -> TSDFVolume:
    """A TSDFVolume whose leading (block/hash) axes carry one *independent*
    sub-volume per blk shard: arrays are (n_blk * capacity, ...) sharded on
    axis 0 and replicated over cam."""
    n_blk = mesh.shape["blk"]
    base = tsdf_volume.create(cfg)

    def rep(a, spec):
        big = jnp.concatenate([a] * n_blk, axis=0) if a.ndim else a
        return jax.device_put(big, jax.sharding.NamedSharding(mesh, spec))

    return TSDFVolume(
        table_keys=rep(base.table_keys, P("blk")),
        table_vals=rep(base.table_vals, P("blk")),
        n_blocks=jax.device_put(
            jnp.zeros((n_blk,), jnp.int32), jax.sharding.NamedSharding(mesh, P("blk"))
        ),
        block_coords=rep(base.block_coords, P("blk")),
        tsdf=rep(base.tsdf, P("blk")),
        weight=rep(base.weight, P("blk")),
        color=rep(base.color, P("blk")),
        overflow=jax.device_put(
            jnp.zeros((n_blk,), jnp.bool_), jax.sharding.NamedSharding(mesh, P("blk"))
        ),
    )


def _alloc_shard(local: TSDFVolume, depth, pose, rays,
                 cfg: TSDFConfig, n_blk: int,
                 stride: int, samples: int, dedup_budget: int) -> TSDFVolume:
    """Per-(cam, blk)-device allocation body (inside shard_map): insert into
    this blk shard the keys IT OWNS out of ALL cameras' candidate key sets
    (one kilobyte-scale all_gather over cam)."""
    my_blk = jax.lax.axis_index("blk")

    d = depth[::stride, ::stride]
    r = rays[::stride, ::stride]
    valid = d > 0
    p = jnp.concatenate([r * d[..., None], d[..., None]], axis=-1)
    offs = jnp.linspace(-cfg.sdf_trunc, cfg.sdf_trunc, samples,
                        dtype=jnp.float32)
    scale = 1.0 + offs[:, None, None] / jnp.maximum(d, 1e-6)[None]
    pts = (p[None] * scale[..., None]).reshape(-1, 3)
    world = se3.transform_points(pose, pts)
    keys = vhash.pack_key(jnp.floor(world / cfg.block_size).astype(jnp.int32))
    keys = jnp.where(jnp.tile(valid.reshape(-1), samples), keys,
                     vhash.EMPTY_KEY)
    # dedup my camera's keys, then gather every camera's dedup set
    skeys = jnp.sort(keys)
    first = jnp.concatenate(
        [skeys[:1] != vhash.EMPTY_KEY,
         (skeys[1:] != skeys[:-1]) & (skeys[1:] != vhash.EMPTY_KEY)])
    order = jnp.cumsum(first.astype(jnp.int32)) - 1
    dst = jnp.where(first & (order < dedup_budget), order, dedup_budget)
    ukeys = jnp.full((dedup_budget,), vhash.EMPTY_KEY, jnp.int32).at[dst].set(
        skeys, mode="drop")
    all_keys = jax.lax.all_gather(ukeys, "cam").reshape(-1)
    # keep only keys this blk shard owns
    mine = (_owner(all_keys, n_blk) == my_blk) & (all_keys != vhash.EMPTY_KEY)
    all_keys = jnp.where(mine, all_keys, vhash.EMPTY_KEY)
    table, counter, vals, overflowed = vhash.insert(
        local.table, local.n_blocks, all_keys,
        jnp.int32(cfg.block_capacity - 1), max_probes=8)
    idx = jnp.where(vals >= 0, vals, cfg.block_capacity)
    bc2 = local.block_coords.at[idx].set(vhash.unpack_key(all_keys),
                                         mode="drop")
    return local._replace(table_keys=table.keys, table_vals=table.vals,
                          n_blocks=counter, block_coords=bc2,
                          overflow=local.overflow | overflowed)


def _integrate_cameras(local: TSDFVolume, depth, color, pose,
                       intr: Intrinsics, cfg: TSDFConfig,
                       worklist_size: int) -> TSDFVolume:
    """Fuse EVERY camera's frame into my shard: all_gather the frames over
    cam, then integrate them in camera order with the worklist form
    (:func:`tsdf.integrate_worklist`), each culled to my shard's blocks.
    Replicas along the cam axis compute the same pool state, so no
    pool-sized collective is needed; the result is exactly single-device
    sequential integration of the same frames after one joint allocate."""
    depths = jax.lax.all_gather(depth, "cam")
    colors = jax.lax.all_gather(color, "cam")
    poses = jax.lax.all_gather(pose, "cam")
    for ci in range(depths.shape[0]):
        local = tsdf_volume.integrate_worklist(
            local, depths[ci], colors[ci], poses[ci], intr, cfg,
            worklist_size=worklist_size)
    return local


_VOL_SPECS = (P("blk"), P("blk"), P("blk"), P("blk"), P("blk"), P("blk"),
              P("blk"), P("blk"))


def _fuse_cam_shard(local: TSDFVolume, depth, color, pose, rays,
                    intr: Intrinsics, cfg: TSDFConfig, n_blk: int, stride: int,
                    samples: int, dedup_budget: int,
                    worklist_size: int) -> TSDFVolume:
    """Per-(cam, blk)-device fusion body shared by every sharded step: this
    camera's frame allocates into the local shard, then the shard fuses ALL
    cameras' frames (:func:`_integrate_cameras`)."""
    local = _alloc_shard(local, depth, pose, rays, cfg, n_blk,
                         stride, samples, dedup_budget)
    return _integrate_cameras(local, depth, color, pose, intr, cfg,
                              worklist_size)


def make_sharded_step(mesh: Mesh, intr: Intrinsics, cfg: TSDFConfig,
                      stride: int = 4, samples: int = 3,
                      dedup_budget: int = 2048, worklist_size: int = 2048):
    """Build the jitted multi-camera fusion step.

    step(vol, depths (n_cam, H, W), colors (n_cam, H, W, 3),
         poses (n_cam, 4, 4), rays (H, W, 2)) -> vol

    Per (cam, blk) device: allocate its shard from ALL cameras' candidate
    keys, then fuse every camera's frame (:func:`_integrate_cameras`;
    ``worklist_size`` bounds the visible blocks of one shard per camera).
    """
    n_blk = mesh.shape["blk"]

    def step(vol: TSDFVolume, depths, colors, poses, rays):
        def shard_fn(tk, tv, nb, bc, ts, wg, co, ovf, depth, color, pose, rays):
            local = TSDFVolume(tk, tv, nb[0], bc, ts, wg, co, ovf[0])
            local = _fuse_cam_shard(local, depth[0], color[0], pose[0], rays,
                                    intr, cfg, n_blk, stride, samples,
                                    dedup_budget, worklist_size)
            return (local.table_keys, local.table_vals, local.n_blocks[None],
                    local.block_coords, local.tsdf, local.weight, local.color,
                    local.overflow[None])

        fn = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=_VOL_SPECS + (P("cam"), P("cam"), P("cam"), P()),
            out_specs=_VOL_SPECS,
            check_vma=False,
        )

        out = fn(vol.table_keys, vol.table_vals, vol.n_blocks, vol.block_coords,
                 vol.tsdf, vol.weight, vol.color, vol.overflow,
                 depths, colors, poses, rays)
        return TSDFVolume(*out)

    return jax.jit(step, donate_argnums=(0,))


def make_sharded_raw_step(mesh: Mesh, intr: Intrinsics, cfg: TSDFConfig,
                          stride: int = 4, samples: int = 3,
                          dedup_budget: int = 2048,
                          worklist_size: int = 2048):
    """The sharded fusion step fed RAW sensor arrays — the live dual-camera
    hot path (reference CreateMesh.py:723-833 eagerly converts both frames
    on the host every loop; here decode + allocate + integrate for BOTH
    cameras is ONE collective dispatch).

    step(vol, depth_raw (n_cam, H, W) u16, color_raw (n_cam, H, W, 3) u8,
         poses (n_cam, 4, 4), rays, cam_on (n_cam,) f32,
         inv_scale, depth_min, depth_trunc) -> vol

    Each camera row decodes ITS frame (decode is elementwise, so it shards
    perfectly over the cam axis). ``cam_on[i] = 0`` zeroes camera *i*'s
    decoded depth — zero depth is invalid to every downstream consumer, so
    an uncalibrated camera contributes nothing without a recompile (the
    same trick as pipelines.mono_odometry_tsdf.apply_lost_latch). Decode
    parameters are traced scalars: runtime depth retuning ('=/-/[/]',
    reference CreateMesh.py:470-501) never recompiles.
    """
    from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
        decode_raw_frame,
    )

    n_blk = mesh.shape["blk"]

    def step(vol: TSDFVolume, depth_raw, color_raw, poses, rays, cam_on,
             inv_scale, depth_min, depth_trunc):
        def shard_fn(tk, tv, nb, bc, ts, wg, co, ovf, draw, craw, pose, rays,
                     on, inv_s, dmin, dtrunc):
            local = TSDFVolume(tk, tv, nb[0], bc, ts, wg, co, ovf[0])
            d, c, _ = decode_raw_frame(draw[0], craw[0], inv_s, dmin, dtrunc)
            d = d * on[0]
            local = _fuse_cam_shard(local, d, c, pose[0], rays,
                                    intr, cfg, n_blk, stride, samples,
                                    dedup_budget, worklist_size)
            return (local.table_keys, local.table_vals, local.n_blocks[None],
                    local.block_coords, local.tsdf, local.weight, local.color,
                    local.overflow[None])

        fn = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=_VOL_SPECS + (P("cam"), P("cam"), P("cam"), P(),
                                   P("cam"), P(), P(), P()),
            out_specs=_VOL_SPECS,
            check_vma=False,
        )
        out = fn(vol.table_keys, vol.table_vals, vol.n_blocks, vol.block_coords,
                 vol.tsdf, vol.weight, vol.color, vol.overflow,
                 depth_raw, color_raw, poses, rays,
                 jnp.asarray(cam_on, jnp.float32),
                 jnp.asarray(inv_scale, jnp.float32),
                 jnp.asarray(depth_min, jnp.float32),
                 jnp.asarray(depth_trunc, jnp.float32))
        return TSDFVolume(*out)

    return jax.jit(step, donate_argnums=(0,))


def make_sharded_slam_batch(mesh: Mesh, intr: Intrinsics, pcfg,
                            stride: int = 4, samples: int = 3,
                            dedup_budget: int = 2048,
                            min_fitness: float = 0.3,
                            worklist_size: int = 2048):
    """Multi-chip SLAM: every camera row TRACKS its own stream (hybrid GN
    odometry, replicated over its blk columns — odometry is per-camera
    independent, so the cam axis is pure data parallelism) while fusion
    stays block-sharded. One jitted dispatch scans a whole frame batch;
    collectives run inside the scan on every step.

    batch(vol, T0 (n_cam,4,4), intensities (n_cam,F,H,W),
          depths (n_cam,F,H,W), colors (n_cam,F,H,W,3), rays)
        -> (vol, poses (n_cam,F-1,4,4), fits (n_cam,F-1))

    Frame 0 of each stream is the tracking reference (pose T0[cam]); frames
    1..F-1 are tracked against their predecessor and integrated.
    """
    from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
        apply_odometry_gate,
    )
    from azurekinect3dreconstruction_tpu.tracking.odometry import compute_odometry

    n_blk = mesh.shape["blk"]
    cfg = pcfg.tsdf
    ocfg = pcfg.odometry

    def batch(vol: TSDFVolume, T0, intensities, depths, colors, rays):
        def shard_fn(tk, tv, nb, bc, ts, wg, co, ovf,
                     T0c, intens, depth, color, rays):
            local = TSDFVolume(tk, tv, nb[0], bc, ts, wg, co, ovf[0])
            T0c = T0c[0]
            intens = intens[0]
            depth = depth[0]
            color = color[0]

            def body(carry, fr):
                local, T_prev, prev_int, prev_depth = carry
                inten, d, c = fr
                res = compute_odometry(prev_int, prev_depth, inten, d, intr,
                                       ocfg)
                # same gate (and -1-fitness failure marker) as the flat steps
                T, fit = apply_odometry_gate(T_prev, res, min_fitness)
                local2 = _fuse_cam_shard(local, d, c, T, rays, intr, cfg,
                                         n_blk, stride, samples, dedup_budget,
                                         worklist_size)
                return (local2, T, inten, d), (T, fit)

            init = (local, jnp.asarray(T0c, jnp.float32), intens[0], depth[0])
            (local, _, _, _), (poses, fits) = jax.lax.scan(
                body, init, (intens[1:], depth[1:], color[1:]))
            return (local.table_keys, local.table_vals, local.n_blocks[None],
                    local.block_coords, local.tsdf, local.weight, local.color,
                    local.overflow[None], poses[None], fits[None])

        fn = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=_VOL_SPECS + (P("cam"), P("cam"), P("cam"), P("cam"), P()),
            out_specs=_VOL_SPECS + (P("cam"), P("cam")),
            check_vma=False,
        )
        out = fn(vol.table_keys, vol.table_vals, vol.n_blocks, vol.block_coords,
                 vol.tsdf, vol.weight, vol.color, vol.overflow,
                 T0, intensities, depths, colors, rays)
        return TSDFVolume(*out[:8]), out[8], out[9]

    return jax.jit(batch, donate_argnums=(0,))


def combine_shards(vol: TSDFVolume, cfg: TSDFConfig, n_blk: int) -> TSDFVolume:
    """Merge the disjoint per-shard sub-volumes into ONE standard TSDFVolume.

    Extraction needs each cell's +1 neighbors, which for shard-boundary
    blocks live on OTHER shards — per-shard extraction would triangulate
    those cells against missing data (seams). Combining first gives the
    extractor the full neighborhood, so the result is cell-identical to a
    single-device volume holding the same blocks. The alive prefix of each
    shard's pool is compacted host-side (extraction is a host-facing save /
    view operation already) and the hash is rebuilt on device with
    ``build_table`` mapping every key to its combined pool slot.
    """
    capN = cfg.block_capacity
    nb = np.asarray(vol.n_blocks).reshape(-1)
    assert nb.shape[0] == n_blk

    def segs(a, cap):
        an = np.asarray(a)
        return np.concatenate(
            [an[i * cap: i * cap + int(nb[i])] for i in range(n_blk)], axis=0)

    coords = segs(vol.block_coords, capN)
    total = coords.shape[0]
    N = capN * n_blk

    def pad(a):
        out = np.zeros((N,) + a.shape[1:], a.dtype)
        out[:total] = a
        return jnp.asarray(out)

    keys = np.full((N,), vhash.EMPTY_KEY, np.int32)
    keys[:total] = np.asarray(vhash.pack_key(jnp.asarray(coords)))
    # probing masks with (capacity - 1): capacity must be a power of two
    # (n_blk often is not — e.g. 3 or 6 shard columns)
    cap = 1 << int(np.ceil(np.log2(cfg.hash_capacity * n_blk)))
    table, ok = vhash.build_table(jnp.asarray(keys),
                                  jnp.arange(N, dtype=jnp.int32),
                                  capacity=cap)
    assert bool(ok), "combined hash table failed to place every key"
    return TSDFVolume(
        table_keys=table.keys,
        table_vals=table.vals,
        n_blocks=jnp.asarray(total, jnp.int32),
        block_coords=pad(coords),
        tsdf=pad(segs(vol.tsdf, capN)),
        weight=pad(segs(vol.weight, capN)),
        color=pad(segs(vol.color, capN)),
        overflow=jnp.asarray(bool(np.asarray(vol.overflow).any())),
    )


def gather_volume(vol: TSDFVolume, cfg: TSDFConfig, shard: int, n_blk: int) -> TSDFVolume:
    """Host-side: extract one shard's sub-volume as an ordinary TSDFVolume
    (extraction then runs per shard; the union of meshes is the scene)."""
    C = cfg.hash_capacity
    N = cfg.block_capacity
    sl = lambda a, n: jnp.asarray(np.asarray(a)[shard * n : (shard + 1) * n])
    return TSDFVolume(
        table_keys=sl(vol.table_keys, C),
        table_vals=sl(vol.table_vals, C),
        n_blocks=jnp.asarray(np.asarray(vol.n_blocks)[shard]),
        block_coords=sl(vol.block_coords, N),
        tsdf=sl(vol.tsdf, N),
        weight=sl(vol.weight, N),
        color=sl(vol.color, N),
        overflow=jnp.asarray(np.asarray(vol.overflow)[shard]),
    )
