"""Incremental extraction: per-update work scales with touched blocks while
the assembled mesh stays identical to a full extraction (the live-loop
answer to the reference's extract-every-frame,
1camera-detectsSceneChanges.py:277-291)."""

import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.config import TSDFConfig
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu.tsdf.incremental import IncrementalExtractor

CFG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                 block_capacity=2048, hash_capacity=8192)


def _tri_set(verts, n_tris):
    v = np.asarray(verts)[: 3 * n_tris].reshape(-1, 3, 3)
    return {tuple(x) for x in np.round(v.mean(1), 5).tolist()}


def test_incremental_matches_full_extraction(synthetic_camera):
    intr = synthetic_camera.intrinsics
    rays = pixel_rays(intr)
    poses = orbit_trajectory(4, radius=0.3, angle_span=1.2)
    inc = IncrementalExtractor(CFG, max_cells=262144, max_tris=131072)
    vol = tsdf.create(CFG)
    total = 0
    for i, T in enumerate(poses):
        z, c = synthetic_camera.render(np.asarray(T, np.float32))
        vol = tsdf.integrate_frame(vol, jnp.asarray(z), jnp.asarray(c), rays,
                                   jnp.asarray(T, jnp.float32), intr, CFG)
        mesh_inc = inc.update(vol)
        full = mc.extract_mesh(vol, CFG, max_cells=262144, max_tris=131072)
        nt_full = int(full.num_triangles)
        assert mesh_inc.triangles.shape[0] == nt_full, (
            i, mesh_inc.triangles.shape[0], nt_full)
        si = {tuple(x) for x in
              np.round(mesh_inc.vertices.reshape(-1, 3, 3).mean(1), 5).tolist()}
        sf = _tri_set(full.vertices, nt_full)
        assert si == sf, f"frame {i}: {len(si ^ sf)} differing triangles"
        total = int(vol.n_blocks)

    # later updates touch only part of the scene — and must route through
    # the COMPACT extraction (host-computed selection + neighbor map) while
    # still assembling the bit-identical full scene
    z, c = synthetic_camera.render(np.asarray(poses[-1], np.float32))
    zc = np.zeros_like(np.asarray(z))  # small central crop -> few blocks
    h, w = zc.shape
    zc[h // 2 - 20: h // 2 + 20, w // 2 - 20: w // 2 + 20] = \
        np.asarray(z)[h // 2 - 20: h // 2 + 20, w // 2 - 20: w // 2 + 20]
    vol = tsdf.integrate_frame(vol, jnp.asarray(zc), jnp.asarray(c), rays,
                               jnp.asarray(poses[-1], jnp.float32), intr, CFG)
    mesh_inc = inc.update(vol)
    assert 0 < inc.last_touched < total, (inc.last_touched, total)
    assert inc.last_mode == "compact", inc.last_mode
    full = mc.extract_mesh(vol, CFG, max_cells=262144, max_tris=131072)
    nt_full = int(full.num_triangles)
    assert mesh_inc.triangles.shape[0] == nt_full
    si = {tuple(x) for x in
          np.round(mesh_inc.vertices.reshape(-1, 3, 3).mean(1), 5).tolist()}
    assert si == _tri_set(full.vertices, nt_full)

    # an update that changes NOTHING must do no extraction at all
    prev = inc._assembled
    assert inc.update(vol) is prev and inc.last_mode == "none"


def test_incremental_preview_wire_tolerance(synthetic_camera):
    """The quantized preview wire (wire="preview", 3 i32 rows/triangle vs
    the exact wire's 9) must reproduce the exact extraction within its
    STATED tolerance: every vertex coordinate within voxel_size/500 (u8
    edge fracs), every triangle's flat color within 1/126 + the triangle's
    own vertex-color spread (RGB666 of the vertex mean), triangle count
    identical, pull bytes >= 2x smaller."""
    intr = synthetic_camera.intrinsics
    rays = pixel_rays(intr)
    poses = orbit_trajectory(3, radius=0.3, angle_span=1.0)
    exact = IncrementalExtractor(CFG, max_cells=262144, max_tris=131072)
    prev = IncrementalExtractor(CFG, max_cells=262144, max_tris=131072,
                                wire="preview")
    vol = tsdf.create(CFG)
    for T in poses:
        z, c = synthetic_camera.render(np.asarray(T, np.float32))
        vol = tsdf.integrate_frame(vol, jnp.asarray(z), jnp.asarray(c), rays,
                                   jnp.asarray(T, jnp.float32), intr, CFG)
        me = exact.update(vol)
        mp = prev.update(vol)
        nt = me.triangles.shape[0]
        assert mp.triangles.shape[0] == nt
        ve = me.vertices.reshape(nt, 3, 3)
        vp = mp.vertices.reshape(nt, 3, 3)
        # both wires emit/patch in the same order (same update sequence,
        # same device worklist): compare triangle-for-triangle
        np.testing.assert_allclose(vp, ve,
                                   atol=CFG.voxel_size / 500.0, rtol=0)
        ce = me.vertex_colors.reshape(nt, 3, 3)
        cp = mp.vertex_colors.reshape(nt, 3, 3)
        spread = np.abs(ce - ce.mean(1, keepdims=True)).max()
        assert np.abs(cp - ce).max() <= spread + 1.0 / 126.0 + 1e-6
        assert prev.last_pull_bytes * 2 <= exact.last_pull_bytes, (
            prev.last_pull_bytes, exact.last_pull_bytes)


def test_incremental_handles_reset(synthetic_camera):
    intr = synthetic_camera.intrinsics
    rays = pixel_rays(intr)
    T = np.eye(4, dtype=np.float32)
    z, c = synthetic_camera.render(T)
    inc = IncrementalExtractor(CFG, max_cells=262144, max_tris=131072)
    vol = tsdf.create(CFG)
    vol = tsdf.integrate_frame(vol, jnp.asarray(z), jnp.asarray(c), rays,
                               jnp.asarray(T), intr, CFG)
    m1 = inc.update(vol)
    assert m1.triangles.shape[0] > 100
    # scene-change reset ('C' key): fresh volume must not resurrect the cache
    vol = tsdf.create(CFG)
    m2 = inc.update(vol)
    assert m2.triangles.shape[0] == 0


def test_incremental_sees_changes_after_weight_saturation(synthetic_camera):
    """Weight sums clamp at max_integration_weight; change detection must
    still notice tsdf drift in saturated blocks (review finding r2)."""
    intr = synthetic_camera.intrinsics
    rays = pixel_rays(intr)
    T = np.eye(4, dtype=np.float32)
    z, c = synthetic_camera.render(T)
    inc = IncrementalExtractor(CFG, max_cells=262144, max_tris=131072)
    vol = tsdf.create(CFG)
    # dwell long enough that every observed voxel's weight clamps
    reps = int(CFG.max_integration_weight) + 5
    for _ in range(reps):
        vol = tsdf.integrate_frame(vol, jnp.asarray(z), jnp.asarray(c), rays,
                                   jnp.asarray(T), intr, CFG)
    inc.update(vol)
    inc.update(vol)
    assert inc.last_touched == 0  # fully saturated and unchanged

    # the scene "changes": same blocks observed from a nudged viewpoint
    T2 = np.asarray(orbit_trajectory(3, radius=0.03, angle_span=0.2)[2],
                    np.float32)
    z2, c2 = synthetic_camera.render(T2)
    vol = tsdf.integrate_frame(vol, jnp.asarray(z2), jnp.asarray(c2), rays,
                               jnp.asarray(T2), intr, CFG)
    inc.update(vol)
    assert inc.last_touched > 0, "saturated blocks went blind to change"
