"""The scan-batched SLAM builder (odometry + fusion, one dispatch per batch)
must track and reconstruct, and must equal stepping the single-step
builder frame by frame."""

import jax.numpy as jnp
import numpy as np
import pytest

from azurekinect3dreconstruction_tpu.config import (
    OdometryConfig,
    PipelineConfig,
    TSDFConfig,
)
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera, orbit_trajectory
from azurekinect3dreconstruction_tpu.ops.image import rgb_to_intensity
from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
    make_slam_batch,
    make_slam_step,
)
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf

CFG = PipelineConfig(
    tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=16,
                    block_capacity=1024, hash_capacity=4096),
    odometry=OdometryConfig(pyramid_iters=(8, 8, 8)),
)


def _frames(intr, poses):
    cam = SyntheticCamera(intrinsics=intr)
    depths, intens, colors = [], [], []
    for T in poses:
        z, c = cam.render(np.asarray(T, np.float32))
        depths.append(jnp.asarray(z))
        colors.append(jnp.asarray(c))
        intens.append(rgb_to_intensity(c))
    return depths, intens, colors


def _seed(intr, rays, depth, color):
    """World frame = first camera: frame 0 integrates at identity."""
    return tsdf.integrate_frame(tsdf.create(CFG.tsdf), depth, color, rays,
                                jnp.eye(4, dtype=jnp.float32), intr, CFG.tsdf,
                                worklist_size=512)


def test_slam_batch_equals_stepping_the_single_step():
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.125)
    rays = pixel_rays(intr)
    poses = orbit_trajectory(3, radius=0.25, angle_span=0.3)
    depths, intens, colors = _frames(intr, poses)

    batch = make_slam_batch(intr, CFG, worklist_size=512, stride=2)
    vol_b, traj, fits = batch(_seed(intr, rays, depths[0], colors[0]),
                              jnp.eye(4, dtype=jnp.float32),
                              jnp.stack(intens), jnp.stack(depths),
                              jnp.stack(colors), rays)

    step = make_slam_step(intr, CFG, worklist_size=512, stride=2)
    vol_s = _seed(intr, rays, depths[0], colors[0])
    T = jnp.eye(4, dtype=jnp.float32)
    for i in range(1, len(poses)):
        vol_s, T, fit = step(vol_s, T, intens[i - 1], depths[i - 1],
                             intens[i], depths[i], colors[i], rays)
        np.testing.assert_allclose(np.asarray(traj[i - 1]), np.asarray(T),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(fits[i - 1]), float(fit),
                                   rtol=0, atol=1e-6)
    assert int(vol_b.n_blocks) == int(vol_s.n_blocks)
    np.testing.assert_array_equal(np.asarray(vol_b.weight),
                                  np.asarray(vol_s.weight))
    np.testing.assert_allclose(np.asarray(vol_b.tsdf), np.asarray(vol_s.tsdf),
                               rtol=0, atol=1e-6)


@pytest.mark.slow
def test_device_slam_batch_tracks_and_fuses():
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    rays = pixel_rays(intr)
    poses = orbit_trajectory(6, radius=0.25, angle_span=0.5)
    depths, intens, colors = _frames(intr, poses)
    batch = make_slam_batch(intr, CFG, worklist_size=512, stride=2)
    vol = _seed(intr, rays, depths[0], colors[0])
    vol, traj, fits = batch(vol, jnp.eye(4, dtype=jnp.float32),
                            jnp.stack(intens), jnp.stack(depths),
                            jnp.stack(colors), rays)
    traj = np.asarray(traj)
    fits = np.asarray(fits)
    assert (fits > 0.5).all(), f"odometry fitness dropped: {fits}"
    # final pose vs ground-truth relative motion
    T_true = np.linalg.inv(poses[0]) @ poses[-1]
    err = np.asarray(se3.se3_log(jnp.asarray(
        np.linalg.inv(T_true) @ traj[-1], jnp.float32)))
    assert np.linalg.norm(err[:3]) < 0.03
    assert np.linalg.norm(err[3:]) < 0.05
    assert int(vol.n_blocks) > 50
    assert not bool(vol.overflow)
