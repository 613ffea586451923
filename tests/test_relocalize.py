"""Tracking-loss recovery: frame-to-model relocalization.

The reference can only RESET the scene when tracking is lost
(1camera-detectsSceneChanges.py:202-212) or drift on identity motion
(:258-260); tracking.relocalize recovers the world pose from the fused model
instead, and the pipeline's device-side fusion latch keeps corrupt-pose
frames out of the volume while the pose is untrusted.
"""

import numpy as np
import pytest

from azurekinect3dreconstruction_tpu.config import (
    OdometryConfig,
    PipelineConfig,
    RegistrationConfig,
    TSDFConfig,
)
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import (
    SyntheticCamera,
    orbit_trajectory,
)
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf

CFG = PipelineConfig(
    tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                    block_capacity=2048, hash_capacity=8192),
    odometry=OdometryConfig(pyramid_iters=(8, 8, 8)),
    registration=RegistrationConfig(ransac_hypotheses=2048, ransac_rounds=4,
                                    icp_max_iters=20),
)


@pytest.fixture(scope="module")
def cam():
    return SyntheticCamera(
        intrinsics=Intrinsics.azure_kinect_depth_nfov().scaled(0.25))


def _pose_err(T_est, T_true):
    """(trans_m, rot_norm) of the relative error."""
    xi = np.asarray(se3.se3_log(np.linalg.inv(T_true) @ np.asarray(T_est)))
    return float(np.linalg.norm(xi[:3])), float(np.linalg.norm(xi[3:]))


def test_relocalizer_recovers_heldout_pose(cam):
    """Direct Relocalizer.attempt: fuse a scan at known poses, then hand it a
    frame from a pose it has never tracked — the recovered T_world_cam must
    land within a couple of voxels / a few degrees of ground truth."""
    from azurekinect3dreconstruction_tpu.tracking.relocalize import Relocalizer

    poses = orbit_trajectory(8, radius=0.3, angle_span=0.9)
    world = [np.linalg.inv(poses[0]) @ T for T in poses]  # world = cam0
    rays = pixel_rays(cam.intrinsics)
    vol = tsdf.create(CFG.tsdf)
    for i in (0, 1, 2, 3, 5, 6, 7):  # hold out pose 4
        d, c = cam.capture(poses[i])
        dm = d.astype(np.float32) / 1000.0
        cf = c.astype(np.float32) / 255.0
        vol = tsdf.integrate_frame(vol, dm, cf, rays, world[i],
                                   cam.intrinsics, CFG.tsdf)

    reloc = Relocalizer(cam.intrinsics, CFG, rays=rays, min_inliers=500,
                        model_points=16384)
    d, _ = cam.capture(poses[4])
    # hint is DELIBERATELY a neighbor pose, not the answer (it only orients
    # model normals)
    T = reloc.attempt(vol, d.astype(np.float32) / 1000.0, T_hint=world[2])
    assert T is not None, f"relocalization rejected: {reloc.last_reject}"
    t_err, r_err = _pose_err(T, world[4])
    assert t_err < 0.05, f"translation error {t_err}"
    assert r_err < 0.1, f"rotation error {r_err}"
    assert reloc.n_success == 1


def test_relocalizer_rejects_empty_frame(cam):
    from azurekinect3dreconstruction_tpu.tracking.relocalize import Relocalizer

    vol = tsdf.create(CFG.tsdf)
    reloc = Relocalizer(cam.intrinsics, CFG)
    h, w = cam.intrinsics.height, cam.intrinsics.width
    assert reloc.attempt(vol, np.zeros((h, w), np.float32)) is None
    assert reloc.last_reject == "empty_frame"


def _fused_orbit(cam, n=8, radius=0.3, span=0.9, hold_out=4):
    poses = orbit_trajectory(n, radius=radius, angle_span=span)
    world = [np.linalg.inv(poses[0]) @ T for T in poses]
    rays = pixel_rays(cam.intrinsics)
    vol = tsdf.create(CFG.tsdf)
    for i in range(n):
        if i == hold_out:
            continue
        d, c = cam.capture(poses[i])
        vol = tsdf.integrate_frame(
            vol, d.astype(np.float32) / 1000.0, c.astype(np.float32) / 255.0,
            rays, world[i], cam.intrinsics, CFG.tsdf)
    return poses, world, rays, vol


def test_relocalizer_hint_rung_recovers_without_descriptors(cam):
    """Rung 0 (hint-seeded model ICP): a near-miss hint must recover WITHOUT
    the FPFH/RANSAC ladder — this is the path that works on the
    feature-degenerate default scene at full resolution, where descriptor
    matching starves (measured: global overlap ~0.06 on the 64-pose bench
    volume; the hint rung recovers in a handful of dispatches)."""
    from azurekinect3dreconstruction_tpu.tracking.relocalize import Relocalizer

    poses, world, rays, vol = _fused_orbit(cam)
    reloc = Relocalizer(cam.intrinsics, CFG, rays=rays, min_inliers=500,
                        model_points=16384)
    d, _ = cam.capture(poses[4])
    # the hint is a NEIGHBOR pose several cm / degrees off the answer —
    # exactly the "camera reappears near the loss site" episode
    T = reloc.attempt(vol, d.astype(np.float32) / 1000.0, T_hint=world[3])
    assert T is not None, f"relocalization rejected: {reloc.last_reject}"
    t_err, r_err = _pose_err(T, world[4])
    assert t_err < 0.05 and r_err < 0.1, (t_err, r_err)
    assert reloc.n_hint_success == 1, "recovery should come from rung 0"


def test_relocalizer_wrong_hint_never_returns_wrong_pose(cam):
    """A garbage hint must not poison recovery: rung 0's strict overlap gate
    rejects its wrong-basin ICP result and the ladder falls through to the
    global rung — the attempt either returns a CORRECT pose or None, never
    a confidently-wrong one."""
    from azurekinect3dreconstruction_tpu.tracking.relocalize import Relocalizer

    poses, world, rays, vol = _fused_orbit(cam)
    reloc = Relocalizer(cam.intrinsics, CFG, rays=rays, min_inliers=500,
                        model_points=16384)
    d, _ = cam.capture(poses[4])
    bad_hint = np.asarray(world[4], np.float64).copy()
    bad_hint[:3, 3] += [0.9, -0.6, 0.8]  # far outside any ICP basin
    T = reloc.attempt(vol, d.astype(np.float32) / 1000.0, T_hint=bad_hint)
    assert reloc.n_hint_success == 0, "rung 0 must not accept a wrong basin"
    if T is not None:  # global rung may still legitimately recover
        t_err, r_err = _pose_err(T, world[4])
        assert t_err < 0.05 and r_err < 0.1, (t_err, r_err)


@pytest.mark.slow
def test_pipeline_relocalizes_after_occlusion_and_jump(cam):
    """End-to-end: track, lose the view for a while (occlusion), resume at a
    pose far ahead of where tracking froze. The pipeline must declare the
    loss, keep the corrupt-pose frames OUT of the volume (device fusion
    latch), relocalize from the fused model, and end with the true pose."""
    from azurekinect3dreconstruction_tpu.pipelines import MonoOdometryTSDF

    poses = orbit_trajectory(16, radius=0.3, angle_span=1.1)
    world = [np.linalg.inv(poses[0]) @ T for T in poses]
    pipe = MonoOdometryTSDF(cam.intrinsics, CFG,
                            relocalize=True, reloc_window=2,
                            reloc_interval=4, reloc_min_inliers=500)
    h, w = cam.intrinsics.height, cam.intrinsics.width
    dark = (np.zeros((h, w), np.uint16), np.zeros((h, w, 3), np.uint8))

    for i in range(6):  # healthy tracking
        pipe.process_frame(*cam.capture(poses[i]))
    nb_before = int(pipe.volume.n_blocks)
    for _ in range(6):  # occlusion: odometry must reject these
        pipe.process_frame(*dark)
    assert pipe.lost, "6 straight rejections at window=2 must declare loss"
    # nothing fused while rejected/lost: not the dark frames (latch), not
    # any frame after loss was declared (step bypassed)
    assert int(pipe.volume.n_blocks) == nb_before
    for i in range(10, 16):  # resume far from where the pose chain froze
        pipe.process_frame(*cam.capture(poses[i]))
    assert not pipe.lost, (
        f"relocalization did not recover: "
        f"{pipe._relocalizer and pipe._relocalizer.last_reject}")
    assert pipe.telemetry._counters["tracking_lost"] == 1
    assert pipe.telemetry._counters["relocalized"] == 1
    # fused volume grew again after recovery
    assert int(pipe.volume.n_blocks) > nb_before
    t_err, r_err = _pose_err(pipe.T_world_cam, world[15])
    assert t_err < 0.06, f"post-recovery translation error {t_err}"
    assert r_err < 0.12, f"post-recovery rotation error {r_err}"


def test_lost_latch_blocks_gate_passing_frames(cam):
    """The latch's load-bearing case: after an occlusion, frame-to-frame
    odometry re-locks (gate PASSES) while the pose is still corrupt — until
    the host check runs, those frames must not fuse. Drive the raw step
    directly: with lost_in=1 a perfectly tracked frame allocates NOTHING
    and the latch stays up; with lost_in=0 the same frame fuses."""
    from azurekinect3dreconstruction_tpu.core.types import RGBDFrame
    from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
        make_raw_slam_step,
    )

    step = make_raw_slam_step(cam.intrinsics, CFG,
                              integrate_rejected=False)
    rays = pixel_rays(cam.intrinsics)
    d, c = cam.capture()
    prev = RGBDFrame.from_raw(d, c, 1000.0, 3.0, 0.1)
    T0 = np.eye(4, dtype=np.float32)

    vol = tsdf.create(CFG.tsdf)
    vol, _T, fit, _i, _d, lost = step(vol, T0, prev.intensity, prev.depth,
                                      d, c, rays, 1e-3, 0.1, 3.0,
                                      np.float32(1.0))
    assert float(fit) > 0.3, "identical frames must track"
    assert float(lost) == 1.0, "only the host clears the latch"
    assert int(vol.n_blocks) == 0, "latched frame must not allocate"

    vol, _T, fit, _i, _d, lost = step(vol, T0, prev.intensity, prev.depth,
                                      d, c, rays, 1e-3, 0.1, 3.0,
                                      np.float32(0.0))
    assert float(lost) == 0.0
    assert int(vol.n_blocks) > 0, "unlatched frame fuses normally"


def test_pipeline_transient_rejection_resumes_fusion(cam):
    """A rejection burst SHORTER than the window must not declare loss: the
    check clears the device latch, fusion resumes, and the paused frames are
    counted instead of silently dropped."""
    from azurekinect3dreconstruction_tpu.pipelines import MonoOdometryTSDF

    poses = orbit_trajectory(12, radius=0.25, angle_span=0.7)
    pipe = MonoOdometryTSDF(cam.intrinsics, CFG,
                            relocalize=True, reloc_window=3,
                            reloc_interval=4, reloc_min_inliers=500)
    h, w = cam.intrinsics.height, cam.intrinsics.width
    dark = (np.zeros((h, w), np.uint16), np.zeros((h, w, 3), np.uint8))

    for i in range(6):
        pipe.process_frame(*cam.capture(poses[i]))
    pipe.process_frame(*dark)  # one blur frame
    for i in range(6, 12):
        pipe.process_frame(*cam.capture(poses[i]))
    assert not pipe.lost
    assert pipe.telemetry._counters["tracking_lost"] == 0
    assert pipe.telemetry._counters["fusion_paused_frames"] >= 1
    # tracking survived the transient: the dark frame fell back to identity
    # and the next real frame re-locked against the last real frame... via
    # the PREVIOUS frame being dark its odometry also rejects; the second
    # real frame re-locks. Pose must still be near truth at the end.
    world = [np.linalg.inv(poses[0]) @ T for T in poses]
    t_err, r_err = _pose_err(pipe.T_world_cam, world[11])
    assert t_err < 0.06, f"translation error {t_err}"
    assert r_err < 0.12, f"rotation error {r_err}"


def test_warmup_is_invisible_to_episode_state(cam):
    """warmup() must compile/dispatch the full attempt path without leaking
    anything observable: counters, last_reject, the RNG stream (determinism
    of later episodes), and the per-episode model cache all restored."""
    from azurekinect3dreconstruction_tpu.tracking.relocalize import Relocalizer

    reloc = Relocalizer(cam.intrinsics, CFG, min_inliers=500,
                        model_points=16384, restarts=1)
    reloc.last_reject = "sentinel"
    key_before = np.asarray(reloc._key).copy()
    dt = reloc.warmup()
    assert dt > 0.0
    assert reloc.n_attempts == 0 and reloc.n_success == 0
    assert reloc.last_reject == "sentinel"
    assert reloc._model_cache is None
    assert np.array_equal(np.asarray(reloc._key), key_before)


def test_pipeline_reloc_warmup_flag(cam, monkeypatch):
    """reloc_warmup=True must build the relocalizer eagerly and warm it at
    construction (the real warmup cost is covered by the direct test)."""
    from azurekinect3dreconstruction_tpu.pipelines import MonoOdometryTSDF
    from azurekinect3dreconstruction_tpu.tracking.relocalize import Relocalizer

    called = []
    monkeypatch.setattr(Relocalizer, "warmup",
                        lambda self, vol=None: called.append(1) or 0.0)
    pipe = MonoOdometryTSDF(cam.intrinsics, CFG,
                            relocalize=True, reloc_warmup=True)
    assert called == [1]
    assert pipe._relocalizer is not None


def test_mid_window_rejection_streak_declares_loss(cam):
    """A >= reloc_window rejection streak that ENDS before the cadence
    check must still declare the pose lost: frame-to-frame odometry
    re-locks against the corrupt chain afterwards (the trailing frames
    PASS the gate), but the pose is wrong — the check must judge the worst
    streak in the window, not the trailing one."""
    from azurekinect3dreconstruction_tpu.pipelines import MonoOdometryTSDF

    poses = orbit_trajectory(16, radius=0.3, angle_span=1.1)
    pipe = MonoOdometryTSDF(cam.intrinsics, CFG,
                            relocalize=True, reloc_window=3,
                            reloc_interval=8, reloc_min_inliers=500)
    h, w = cam.intrinsics.height, cam.intrinsics.width
    dark = (np.zeros((h, w), np.uint16), np.zeros((h, w, 3), np.uint8))

    for i in range(8):  # healthy first window
        pipe.process_frame(*cam.capture(poses[i]))
    assert not pipe.lost
    nb = int(pipe.volume.n_blocks)
    # 4 dark frames (streak 4 + the post-dark re-lock frame rejects too),
    # then good frames so the window ENDS with gate-passing frames; the
    # cadence check runs at frame 16
    for _ in range(4):
        pipe.process_frame(*dark)
    for i in range(12, 16):
        pipe.process_frame(*cam.capture(poses[i]))
    assert pipe.lost, "mid-window streak of 4 >= window 3 must declare loss"
    assert pipe.telemetry._counters["tracking_lost"] == 1
    # none of the post-streak gate-passing frames fused (latch held)
    assert int(pipe.volume.n_blocks) == nb


def test_latch_survives_check_boundary_mid_streak(cam):
    """A short rejection streak that reaches the check boundary must NOT
    re-open fusion at the check: the streak may still be growing, and a
    gate-passing corrupt re-lock right after the check would fuse at a
    wrong pose. The latch stays up until a check sees the streak resolved;
    the extra paused frames are counted, and the pipeline never declares
    loss for a transient shorter than the window."""
    from azurekinect3dreconstruction_tpu.pipelines import MonoOdometryTSDF

    poses = orbit_trajectory(16, radius=0.25, angle_span=0.8)
    pipe = MonoOdometryTSDF(cam.intrinsics, CFG,
                            relocalize=True, reloc_window=4,
                            reloc_interval=4, reloc_min_inliers=500)
    h, w = cam.intrinsics.height, cam.intrinsics.width
    dark = (np.zeros((h, w), np.uint16), np.zeros((h, w, 3), np.uint8))

    for i in range(6):
        pipe.process_frame(*cam.capture(poses[i]))
    nb = int(pipe.volume.n_blocks)
    for _ in range(2):  # frames 6,7: streak of 2 touching the check at 8
        pipe.process_frame(*dark)
    assert not pipe.lost
    assert pipe._latch_up, "check at the streak edge must keep the latch up"
    # frames 8-10: frame 8 rejects (prev is dark) -> streak 3 < window 4;
    # 9,10 pass the gate but the latch is still up -> must not fuse
    for i in range(8, 11):
        pipe.process_frame(*cam.capture(poses[i]))
    assert int(pipe.volume.n_blocks) == nb, \
        "gate-passing frames must not fuse while the latch is up"
    # frame 11 completes the window; its check sees the streak resolved:
    # latch clears, and the 6 paused frames (6-11) are counted
    pipe.process_frame(*cam.capture(poses[11]))
    assert not pipe.lost
    assert not pipe._latch_up
    assert pipe.telemetry._counters["tracking_lost"] == 0
    assert pipe.telemetry._counters["fusion_paused_frames"] == 6
    # fusion resumes after the clear
    for i in range(12, 16):
        pipe.process_frame(*cam.capture(poses[i]))
    assert int(pipe.volume.n_blocks) > nb


def test_model_cache_keyed_on_volume_contents(cam):
    """Re-fusing into the SAME blocks (n_blocks unchanged) must invalidate
    the relocalizer's model cache: the cache key is the identity of the
    volume's immutable tsdf array, not the block count."""
    from azurekinect3dreconstruction_tpu.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu.tracking.relocalize import Relocalizer

    rays = pixel_rays(cam.intrinsics)
    poses = orbit_trajectory(4, radius=0.3, angle_span=0.4)
    vol = tsdf.create(CFG.tsdf)
    d, c = cam.capture(poses[0])
    dm = d.astype(np.float32) / 1000.0
    cf = c.astype(np.float32) / 255.0
    vol = tsdf.integrate_frame(vol, dm, cf, rays, np.eye(4, dtype=np.float32),
                               cam.intrinsics, CFG.tsdf)
    reloc = Relocalizer(cam.intrinsics, CFG, rays=rays, min_inliers=500,
                        model_points=16384, restarts=1)
    reloc.attempt(vol, dm, T_hint=np.eye(4))
    key1 = reloc._model_cache[0]
    # SAME frame again: weights change, block set does not
    nb = int(vol.n_blocks)
    vol2 = tsdf.integrate_frame(vol, dm, cf, rays,
                                np.eye(4, dtype=np.float32),
                                cam.intrinsics, CFG.tsdf)
    assert int(vol2.n_blocks) == nb
    reloc.attempt(vol2, dm, T_hint=np.eye(4))
    assert reloc._model_cache[0] != key1, \
        "updated volume contents must miss the model cache"
    # same volume object again: hit (key stable)
    key2 = reloc._model_cache[0]
    reloc.attempt(vol2, dm, T_hint=np.eye(4))
    assert reloc._model_cache[0] == key2


def test_auto_stride_respects_point_budget():
    """The documented contract: the strided frame cloud stays <= ~32k
    points at any image scale (full res must pick 4, not 3)."""
    from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu.tracking.relocalize import Relocalizer

    full = Intrinsics.azure_kinect_depth_nfov()
    r = Relocalizer(full, CFG)
    assert r.stride == 4
    n_pts = -(-full.height // r.stride) * -(-full.width // r.stride)
    assert n_pts <= 36000  # ~32k with ragged-edge slack


def test_streaming_ticks_and_recovery_while_lost(cam):
    """streaming + relocalize: while the pose is lost, the streaming
    manager must keep ticking with the stale pose (otherwise geometry
    evicted near the loss site can never stream back for the relocalizer's
    model, and the pipeline stays lost forever), and recovery must still
    work through the streaming-adopted volume."""
    from azurekinect3dreconstruction_tpu.pipelines import MonoOdometryTSDF
    from azurekinect3dreconstruction_tpu.tsdf.streaming import StreamingTSDF

    streaming = StreamingTSDF(CFG.tsdf, evict_dist=3.0, reload_dist=2.5,
                              check_interval=2)
    pipe = MonoOdometryTSDF(cam.intrinsics, CFG,
                            streaming=streaming, relocalize=True,
                            reloc_window=2, reloc_interval=4,
                            reloc_min_inliers=500)
    poses = orbit_trajectory(12, radius=0.3, angle_span=1.0)
    world = [np.linalg.inv(poses[0]) @ T for T in poses]
    h, w = cam.intrinsics.height, cam.intrinsics.width
    dark = (np.zeros((h, w), np.uint16), np.zeros((h, w, 3), np.uint8))

    for i in range(6):
        pipe.process_frame(*cam.capture(poses[i]))
    for _ in range(6):
        pipe.process_frame(*dark)
    assert pipe.lost
    # the tick cadence keeps running through lost frames (manager counter
    # advances and wraps at check_interval=2 as ticks execute)
    before = streaming._since_check
    pipe.process_frame(*dark)
    assert streaming._since_check != before or streaming._since_check == 0
    # recovery through the streaming volume
    for i in range(8, 12):
        pipe.process_frame(*cam.capture(poses[i]))
    assert not pipe.lost, (pipe._relocalizer and pipe._relocalizer.last_reject)
    t_err, r_err = _pose_err(pipe.T_world_cam, world[11])
    assert t_err < 0.06 and r_err < 0.12, (t_err, r_err)
