#!/usr/bin/env python
"""Staged fragment reconstruction: capture -> fragments -> register -> refine
-> integrate.

Entry-point parity: reference azure-kinect-DK/Reconstruction/3Dreconstruction.py
(the 4-stage layout documented at :1-7). Headless mode captures every
``--capture-every`` frames instead of the interactive 'c' key.
"""

import argparse

from common import add_common_args, make_source

from azurekinect3dreconstruction_tpu.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu.pipelines import FragmentPipeline
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info
from azurekinect3dreconstruction_tpu.viz.savers import ResultSaver


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--capture-every", type=int, default=10)
    args = ap.parse_args()

    frames, intr = make_source(args)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=args.voxel,
                                         sdf_trunc=3 * args.voxel))
    pipe = FragmentPipeline(intr, cfg)
    for i, (depth, color) in enumerate(frames):
        if i % args.capture_every == 0:
            pipe.capture(depth, color)
    mesh = pipe.run()
    saver = ResultSaver(args.output)
    saver.save_mesh(mesh, kind="fragments_mesh")
    log_info(f"fragment mesh: {mesh.triangles.shape[0]} triangles")


if __name__ == "__main__":
    main()
