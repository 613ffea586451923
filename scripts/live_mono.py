#!/usr/bin/env python
"""Live single-camera odometry + TSDF streamer.

Entry-point parity: reference CodeThatWorks/1camera-detectsSceneChanges.py —
per-frame odometry tracks camera motion, the TSDF fuses every frame, the
surface re-renders periodically; keys: C reset volume, S save, M toggle
mesh/point-cloud display.
"""

import argparse

from common import add_common_args, make_source, make_viewer

from azurekinect3dreconstruction_tpu.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu.core.types import PointCloudHost
from azurekinect3dreconstruction_tpu.pipelines import MonoOdometryTSDF
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu.tsdf.marching_cubes import weld_vertices
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info
from azurekinect3dreconstruction_tpu.viz.savers import ResultSaver


def build_pipeline(intr, tsdf_cfg: TSDFConfig, tracking: str = "frame_to_frame",
                   streaming: bool = False, relocalize: bool = False,
                   reloc_warmup: bool = False) -> MonoOdometryTSDF:
    """The pipeline this script runs, from its command-line choices."""
    cfg = PipelineConfig(tsdf=tsdf_cfg)
    manager = None
    if streaming:
        from azurekinect3dreconstruction_tpu.tsdf.streaming import (
            StreamingTSDF,
        )

        manager = StreamingTSDF.for_pipeline(cfg)
        log_info(f"streaming: reload<{manager.reload_dist:.2f} m, "
                 f"evict>{manager.evict_dist:.2f} m, "
                 f"high water {manager.high_water} blocks")
    return MonoOdometryTSDF(intr, cfg, tracking=tracking, streaming=manager,
                            relocalize=relocalize,
                            reloc_warmup=relocalize and reloc_warmup)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--voxel", type=float, default=0.01, help="TSDF voxel (m)")
    ap.add_argument("--tracking", default="frame_to_frame",
                    choices=["frame_to_frame", "frame_to_model"],
                    help="frame_to_model refines odometry against the fused "
                         "model surface (bounds drift)")
    ap.add_argument("--streaming", action="store_true",
                    help="stream far-from-camera TSDF blocks to host memory "
                         "(unbounded scene extent on the fixed device pool; "
                         "saves assemble live + streamed geometry)")
    ap.add_argument("--relocalize", action="store_true",
                    help="recover from tracking loss by re-registering the "
                         "live frame against the fused model (fusion pauses "
                         "while the pose is untrusted; the reference can "
                         "only reset the scene here)")
    ap.add_argument("--reloc-warmup", action="store_true",
                    help="with --relocalize: pre-compile the recovery path "
                         "at startup so the FIRST loss episode recovers in "
                         "~1s instead of pausing ~1min on fresh-shape "
                         "compiles (subsequent runs hit the persistent "
                         "compilation cache either way)")
    args = ap.parse_args()

    frames, intr = make_source(args)
    pipe = build_pipeline(
        intr, TSDFConfig(voxel_size=args.voxel, sdf_trunc=4 * args.voxel),
        tracking=args.tracking, streaming=args.streaming,
        relocalize=args.relocalize, reloc_warmup=args.reloc_warmup)
    cfg = pipe.cfg
    streaming = pipe.streaming
    viewer = make_viewer(args, "mono odometry+TSDF")
    saver = ResultSaver(args.output)
    state = {"mesh_mode": False}

    def save():
        mesh = weld_vertices(pipe.extract_mesh().compact())
        mesh.compute_vertex_normals()
        saver.save_mesh(mesh, kind="mesh")
        pts, cols = pipe.extract_point_cloud()
        saver.save_point_cloud(PointCloudHost(points=pts, colors=cols),
                               kind="volume_pcd")
        saver.save_trajectory(pipe.trajectory)
        gt = getattr(args, "gt_poses", None)
        if gt:
            # synthetic source: save index-aligned ground truth in the
            # pipeline's frame (world = camera-0) so
            # scripts/eval_trajectory.py can score the run directly
            import numpy as np

            n = pipe.frame_index
            P0i = np.linalg.inv(gt[0])
            saver.save_trajectory(
                [np.eye(4)] + [P0i @ P for P in gt[:n]],
                kind="gt_trajectory")
        saver.save_preview(mesh)
        log_info("saved mesh + cloud + trajectory + preview")

    viewer.register_key("C", pipe.reset, "reset volume (scene change)")
    viewer.register_key("S", save, "save mesh/cloud/trajectory")
    viewer.register_key(
        "M", lambda: state.update(mesh_mode=not state["mesh_mode"]),
        "toggle mesh / point-cloud display")

    # live depth-decoding tuning (reference CreateMesh.py:470-501): depth
    # scale +-100 units/m, truncation +-0.5 m; takes effect next frame (the
    # parameters enter the jitted path as traced scalars, no recompile)
    def tune(scale_d=0.0, trunc_d=0.0):
        cam_cfg = pipe.cfg.camera
        pipe.cfg = pipe.cfg.__class__(
            **{**pipe.cfg.__dict__,
               "camera": cam_cfg.replace(
                   depth_scale=max(cam_cfg.depth_scale + scale_d, 100.0),
                   depth_trunc=max(cam_cfg.depth_trunc + trunc_d, 0.5))})
        log_info(f"depth_scale {pipe.cfg.camera.depth_scale:.0f} "
                 f"depth_trunc {pipe.cfg.camera.depth_trunc:.2f}")
        if streaming is not None:
            # the streaming distances were derived from the STARTUP
            # depth_trunc; raising it extends integration reach past the
            # reload ring, which degrades frozen caches to merge-and-refresh
            # churn (tsdf/streaming.py policy contract)
            reach = type(streaming).integration_reach(pipe.cfg)
            if reach > streaming.reload_dist:
                log_info(f"WARNING: depth_trunc raises integration reach to "
                         f"{reach:.2f} m > streaming reload ring "
                         f"{streaming.reload_dist:.2f} m — restart with the "
                         f"larger truncation to re-derive safe distances")

    viewer.register_key("=", lambda: tune(scale_d=+100), "depth scale +100")
    viewer.register_key("-", lambda: tune(scale_d=-100), "depth scale -100")
    viewer.register_key("]", lambda: tune(trunc_d=+0.5), "depth trunc +0.5m")
    viewer.register_key("[", lambda: tune(trunc_d=-0.5), "depth trunc -0.5m")

    # live surface redraws re-extract only blocks the recent frames touched
    # (the reference re-extracts the whole volume every frame,
    # 1camera-detectsSceneChanges.py:277-291)
    from azurekinect3dreconstruction_tpu.tsdf.incremental import (
        IncrementalExtractor,
    )

    # preview wire: 3x fewer pull bytes at a stated (sub-voxel/500)
    # tolerance for the live view; the SAVE path below extracts exactly
    inc = IncrementalExtractor(cfg.tsdf, wire="preview")

    # double-buffered host->device streaming: frame k+1 uploads while the
    # SLAM step computes on frame k (io/streams.DeviceFeeder)
    from azurekinect3dreconstruction_tpu.io.streams import prefetch_to_device

    for i, (depth, color) in enumerate(prefetch_to_device(frames)):
        pipe.process_frame(depth, color)
        if i % pipe.cfg.vis_update_interval == 0 and not viewer.headless:
            if state["mesh_mode"]:
                # with --streaming, this live view shows the RESIDENT region
                # (evicted far geometry drops out of the preview and each
                # eviction re-bases the incremental cache); 'S' saves the
                # full assembled scene via pipe.extract_mesh()
                viewer.update_mesh("surface", inc.update(pipe.volume))
            else:
                pts, cols = pipe.extract_point_cloud(max_points=200000)
                viewer.update_cloud("surface", PointCloudHost(points=pts, colors=cols))
            if hasattr(viewer, "set_status"):  # browser HUD telemetry line
                viewer.set_status(f"frame {i} | {pipe.telemetry.fps:.1f} fps")
        if not viewer.tick():
            break
    save()
    viewer.close()


if __name__ == "__main__":
    main()
