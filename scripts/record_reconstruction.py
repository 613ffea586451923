#!/usr/bin/env python
"""Colored-ICP recording reconstructor.

Entry-point parity: reference CodeThatWorks/GoodColorReconstruction.py —
'R' toggles recording, keyframe-interval colored-ICP tracking with global
registration fallback, every frame integrated, 'S' saves mesh + volume cloud
+ trajectory, 1 Hz FPS/success telemetry.
"""

import argparse

from common import add_common_args, make_source, make_viewer

from azurekinect3dreconstruction_tpu.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu.core.types import PointCloudHost
from azurekinect3dreconstruction_tpu.pipelines import Recorder
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--autostart", action="store_true",
                    help="start recording immediately (headless runs)")
    args = ap.parse_args()

    frames, intr = make_source(args)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=args.voxel,
                                         sdf_trunc=4 * args.voxel))
    pipe = Recorder(intr, cfg, output_dir=args.output)
    viewer = make_viewer(args, "recorder")
    viewer.register_key("R", pipe.toggle_recording, "toggle recording")
    viewer.register_key("S", pipe.save_model, "save model")
    if args.autostart or viewer.headless:
        pipe.toggle_recording()

    for i, (depth, color) in enumerate(frames):
        pipe.process_frame(depth, color)
        if i % pipe.cfg.vis_update_interval == 0 and not viewer.headless:
            pts, cols = tsdf.extract_point_cloud(pipe.volume, pipe.cfg.tsdf,
                                                 max_points=200000)
            if len(pts):
                viewer.update_cloud("model", PointCloudHost(points=pts, colors=cols))
        if not viewer.tick():
            break
    pipe.save_model()
    viewer.close()


if __name__ == "__main__":
    main()
