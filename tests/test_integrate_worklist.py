"""Parity: the worklist integrate (frustum-visible rows gathered, fused and
scattered back) must reproduce the whole-pool reference ``tsdf.integrate``
exactly on the CPU, and must flag, not hide, a worklist that is too small."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from azurekinect3dreconstruction_tpu.config import TSDFConfig
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf

CFGS = {
    8: TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                  block_capacity=2048, hash_capacity=8192),
    16: TSDFConfig(voxel_size=0.01, sdf_trunc=0.04, block_resolution=16,
                   block_capacity=1024, hash_capacity=4096),
}


def _snapshot(vol):
    return tsdf.TSDFVolume(*jax.tree.map(lambda x: jnp.asarray(np.array(x)), vol))


def _assert_same(va, vb):
    for name in ("tsdf", "weight", "color", "n_blocks", "block_coords"):
        np.testing.assert_array_equal(np.asarray(getattr(va, name)),
                                      np.asarray(getattr(vb, name)), name)


@pytest.mark.parametrize("res", sorted(CFGS))
def test_worklist_integrate_matches_reference_single_frame(synthetic_camera, res):
    cfg = CFGS[res]
    intr = synthetic_camera.intrinsics
    rays = pixel_rays(intr)
    T = jnp.eye(4, dtype=jnp.float32)
    z, c = synthetic_camera.render(np.eye(4, dtype=np.float32))
    vol0 = tsdf.allocate(tsdf.create(cfg), z, rays, T, cfg)
    ref = tsdf.integrate(_snapshot(vol0), z, c, T, intr, cfg)
    got = tsdf.integrate_worklist(vol0, z, c, T, intr, cfg,
                                  worklist_size=cfg.block_capacity)
    _assert_same(ref, got)
    assert not bool(got.overflow)
    assert float(jnp.sum(got.weight)) > 0


@pytest.mark.parametrize("res", sorted(CFGS))
def test_worklist_integrate_matches_reference_moving_camera(synthetic_camera, res):
    """A wide orbit: later frames see only part of what earlier ones
    allocated, so culling decides which rows change."""
    cfg = CFGS[res]
    intr = synthetic_camera.intrinsics
    rays = pixel_rays(intr)
    vol_w = tsdf.create(cfg)
    vol_r = tsdf.create(cfg)
    culled = 0
    for T in orbit_trajectory(4, radius=0.35, angle_span=2.0):
        T = jnp.asarray(T, jnp.float32)
        z, c = synthetic_camera.render(np.asarray(T, np.float32))
        vol_w = tsdf.allocate(vol_w, z, rays, T, cfg)
        vol_r = tsdf.allocate(vol_r, z, rays, T, cfg)
        _, n_active = tsdf.build_worklist(vol_w.block_coords, vol_w.n_blocks,
                                          T, intr, cfg)
        culled = max(culled, int(vol_w.n_blocks) - int(n_active))
        vol_r = tsdf.integrate(vol_r, z, c, T, intr, cfg)
        vol_w = tsdf.integrate_worklist(vol_w, z, c, T, intr, cfg,
                                        worklist_size=1024)
    _assert_same(vol_r, vol_w)
    assert not bool(vol_w.overflow)
    assert culled > 0, "the orbit must leave some blocks out of view"


def test_worklist_culls_out_of_view_blocks(synthetic_camera):
    cfg = CFGS[8]
    intr = synthetic_camera.intrinsics
    rays = pixel_rays(intr)
    T = jnp.eye(4, dtype=jnp.float32)
    z, _ = synthetic_camera.render(np.eye(4, dtype=np.float32))
    vol = tsdf.allocate(tsdf.create(cfg), z, rays, T, cfg)
    n = int(vol.n_blocks)

    # looking straight at the scene: every allocated block is visible
    slots, n_active = tsdf.build_worklist(vol.block_coords, vol.n_blocks, T,
                                          intr, cfg)
    assert int(n_active) == n
    assert sorted(np.asarray(slots[:n]).tolist()) == list(range(n))
    # the worklist is a permutation: any prefix holds distinct slots
    assert sorted(np.asarray(slots).tolist()) == list(range(cfg.block_capacity))

    # camera turned 180 degrees: nothing visible
    T_back = se3.se3_exp(jnp.asarray([0, 0, 0, 0.0, np.pi, 0.0], jnp.float32))
    _, n_active = tsdf.build_worklist(vol.block_coords, vol.n_blocks, T_back,
                                      intr, cfg)
    assert int(n_active) == 0


def test_worklist_overflow_is_sticky_and_skips_excess(synthetic_camera):
    """More visible blocks than the worklist holds: the first M visible
    rows fuse, the rest keep their state, and the flag stays set."""
    cfg = CFGS[8]
    intr = synthetic_camera.intrinsics
    rays = pixel_rays(intr)
    T = jnp.eye(4, dtype=jnp.float32)
    z, c = synthetic_camera.render(np.eye(4, dtype=np.float32))
    vol = tsdf.allocate(tsdf.create(cfg), z, rays, T, cfg)
    n = int(vol.n_blocks)
    M = 256
    assert n > M
    slots, _ = tsdf.build_worklist(vol.block_coords, vol.n_blocks, T, intr, cfg)
    ref = tsdf.integrate(_snapshot(vol), z, c, T, intr, cfg)
    got = tsdf.integrate_worklist(vol, z, c, T, intr, cfg, worklist_size=M)
    assert bool(got.overflow)
    fused = np.asarray(slots[:M])
    skipped = np.asarray(slots[M:n])
    w_got, w_ref = np.asarray(got.weight), np.asarray(ref.weight)
    np.testing.assert_array_equal(w_got[fused], w_ref[fused])
    assert not w_got[skipped].any()
    # sticky: a later frame that fits does not clear it
    again = tsdf.integrate_worklist(got, z, c, T, intr, cfg,
                                    worklist_size=cfg.block_capacity)
    assert bool(again.overflow)


def test_integrate_frame_eager_picks_a_rung_that_holds_the_view(synthetic_camera):
    """Eager callers pass no worklist size: the smallest WORKLIST_SIZES rung
    holding every visible block is used, so nothing overflows."""
    cfg = CFGS[8]
    intr = synthetic_camera.intrinsics
    rays = pixel_rays(intr)
    T = jnp.eye(4, dtype=jnp.float32)
    z, c = synthetic_camera.render(np.eye(4, dtype=np.float32))
    eager = tsdf.integrate_frame(tsdf.create(cfg), z, c, rays, T, intr, cfg)
    assert int(eager.n_blocks) > 256  # more than the smallest rung
    assert not bool(eager.overflow)
    ref = tsdf.allocate(tsdf.create(cfg), z, rays, T, cfg)
    ref = tsdf.integrate(ref, z, c, T, intr, cfg)
    _assert_same(ref, eager)
