#!/usr/bin/env python
"""Offline-optimized SLAM: record -> pose graph + loop closure -> reintegrate.

Entry-point parity: reference
CodeThatWorks/bundlefusionattemps/bundlefusion_reconstruction.py (and the
simpler ...Works.py / capture_frames.py variants): frames logged to npz,
odometry edges + positional loop closures with online re-optimization, final
LM optimization + full reintegration on exit. ``--resume`` restarts from an
existing frame log (the log IS the checkpoint).
"""

import argparse

from common import add_common_args, make_source

from azurekinect3dreconstruction_tpu.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu.pipelines import OfflineBundle
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--voxel", type=float, default=0.004,
                    help="TSDF voxel (reference uses 4 mm)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the frame log in --output")
    args = ap.parse_args()

    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=args.voxel,
                                         sdf_trunc=4 * args.voxel))
    if args.resume:
        frames, intr = make_source(args)
        pipe = OfflineBundle.resume(intr, args.output, cfg)
        log_info(f"resumed with {pipe.n_frames} frames")
    else:
        frames, intr = make_source(args)
        pipe = OfflineBundle(intr, cfg, output_dir=args.output)
        try:
            for depth, color in frames:
                pipe.process_frame(depth, color)
        except KeyboardInterrupt:
            log_info("interrupted; finalizing with what we have")
    mesh = pipe.finalize()
    if mesh is not None:
        log_info(f"final mesh: {mesh.triangles.shape[0]} triangles")


if __name__ == "__main__":
    main()
