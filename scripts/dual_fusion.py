#!/usr/bin/env python
"""Two-camera fusion with auto-calibration.

Entry-point parity: reference BetterVisualizer2CamWorksROTATEsave2.py
(== CreateMesh.py) and family — capture threads per camera, FPFH+RANSAC
one-shot extrinsic calibration, merged downsampled cloud, keys: S save,
R recalibrate, C cycle color mode. For --source synthetic, camera 1 is a
rendered second viewpoint with a fixed ground-truth baseline (the reference
author's own simulated-second-camera idea, CreateMesh.py:548-551).
"""

import argparse

import numpy as np

from common import add_common_args, apply_backend_overrides, make_viewer

from azurekinect3dreconstruction_tpu.config import (
    PipelineConfig,
    RegistrationConfig,
    TSDFConfig,
)
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu.io.streams import MultiCameraRig
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera, orbit_trajectory
from azurekinect3dreconstruction_tpu.pipelines import DualCameraFusion
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info


def synthetic_rig():
    """(T0, T1): a STATIC two-camera rig looking at the scene (the
    pipeline's world frame is camera 0; rigs do not move in the reference's
    2-cam scripts)."""
    import jax.numpy as jnp

    T1 = np.asarray(se3.se3_exp(jnp.asarray([0.12, 0.02, -0.02, 0.03, -0.1, 0.02],
                                            jnp.float32)), np.float64)
    return np.eye(4), T1


def synthetic_pair_frames(args, intr):
    cam = SyntheticCamera(intrinsics=intr)
    T0, T1 = synthetic_rig()
    for _ in range(args.frames):
        yield (cam.capture(T0), cam.capture(T1))


def build_pipeline(intr, voxel: float, output_dir: str, sharded: bool = False,
                   colored_calib: bool = False) -> DualCameraFusion:
    """The pipeline this script runs, from its command-line choices."""
    cfg = PipelineConfig(
        tsdf=TSDFConfig(voxel_size=voxel, sdf_trunc=4 * voxel),
        # 2048 parallel hypotheses + ICP refinement match the reference's
        # acceptance quality at a fraction of the compile/compute cost
        registration=RegistrationConfig(ransac_hypotheses=2048),
    )
    return DualCameraFusion((intr, intr), cfg, output_dir=output_dir,
                            sharded=sharded, colored_calibration=colored_calib)


def k4a_pair_frames(args):
    from azurekinect3dreconstruction_tpu.io.k4a_live import K4ALiveSource, detect_cameras

    ids = detect_cameras()
    if len(ids) < 2:
        raise SystemExit("need two Azure Kinect devices for --source k4a")
    sources = [K4ALiveSource(device_id=i) for i in ids[:2]]
    rig = MultiCameraRig([s.capture for s in sources])
    rig.start()
    rig.install_sigint_handler()
    try:
        n = 0
        while args.frames == 0 or n < args.frames:
            frames = rig.get_synchronized_frames()
            if frames is None:
                continue
            yield tuple(frames)
            n += 1
    finally:
        rig.stop()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--sharded", action="store_true",
                    help="camera-per-device + block-sharded volume over a "
                         "jax.sharding.Mesh (needs >= 2 devices; on one "
                         "GPU, pass --cpu with XLA_FLAGS=--xla_force_host_"
                         "platform_device_count=N to exercise it)")
    ap.add_argument("--colored-calib", action="store_true",
                    help="refine the auto-calibration extrinsic with "
                         "COLORED ICP (photometric + point-to-plane; locks "
                         "the in-plane DoF a textured flat wall leaves "
                         "unconstrained — reference "
                         "Works2CamerasCOLORVisualizer.py:189-279)")
    ap.add_argument("--rig-calib", default=None, metavar="DIR",
                    help="load the newest checkerboard rig calibration from "
                         "DIR (scripts/calibrate_rig.py output; serials are "
                         "validated against the attached rig — reference "
                         "InitialReconstruction-CUDA-2cam:542-623) instead "
                         "of FPFH auto-calibration")
    args = ap.parse_args()
    apply_backend_overrides(args)

    intr = Intrinsics.azure_kinect_depth_nfov().scaled(args.scale)
    pipe = build_pipeline(intr, args.voxel, args.output, sharded=args.sharded,
                          colored_calib=args.colored_calib)
    cfg = pipe.cfg
    if args.rig_calib:
        from azurekinect3dreconstruction_tpu.calib.extrinsics import RigCalibration

        serials = None
        if args.source.startswith("k4a"):
            from azurekinect3dreconstruction_tpu.io.k4a_live import rig_serials

            serials = rig_serials()
        cal = RigCalibration.load_newest(args.rig_calib,
                                         expected_serials=serials)
        if cal is None:
            raise SystemExit(f"no matching rig calibration in {args.rig_calib}")
        pipe.extrinsics = [np.asarray(e) for e in cal.extrinsics]
        pipe.calibrated = True
        log_info(f"rig calibration loaded: baseline "
                 f"{np.linalg.norm(cal.extrinsics[1][:3, 3]):.4f} m "
                 f"(serials {cal.serials})")
    viewer = make_viewer(args, "dual-camera fusion")
    viewer.register_key("S", pipe.save_current_state, "save cloud + mesh")
    viewer.register_key("R", pipe.recalibrate, "recalibrate extrinsics (ICP)")
    viewer.register_key("C", pipe.cycle_color_mode, "cycle color mode")

    if args.source.startswith("k4a"):
        frames = k4a_pair_frames(args)
    else:
        frames = synthetic_pair_frames(args, intr)

    # double-buffered host->device streaming (io/streams.DeviceFeeder):
    # the next pair uploads while the fusion step computes on this one
    from azurekinect3dreconstruction_tpu.io.streams import prefetch_to_device

    for i, pair in enumerate(prefetch_to_device(frames)):
        pipe.process_frames(pair)
        if i % cfg.vis_update_interval == 0 and not viewer.headless:
            viewer.update_cloud("merged", pipe.merged_cloud())
        if not viewer.tick():
            break
    pipe.save_current_state()
    viewer.close()
    if pipe.calibrated:
        r, p, y = se3.rpy_from_matrix(pipe.extrinsics[1][:3, :3])
        log_info(f"final extrinsic rpy deg: {np.degrees([r, p, y])}")


if __name__ == "__main__":
    main()
