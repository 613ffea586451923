"""Offline-optimized SLAM ("BundleFusion-style").

Pipeline parity: reference
CodeThatWorks/bundlefusionattemps/bundlefusion_reconstruction.py: per-frame
odometry builds pose-graph nodes/edges (:224-244), every raw frame is dumped
to frames/frame_%06d.npz as the checkpoint log (:219-220), positional loop
closures (< 0.5 m, >= 20-frame gap) trigger ONLINE re-optimization every 10
frames (:131-150, :259-273), and at shutdown the graph is globally optimized
(LM, prune 0.25, pref 2.0) and ALL frames are re-integrated into a reset
volume with optimized poses (:285-344). capture_frames.py adds periodic
pose-graph JSON checkpoints (:181-183) — ``checkpoint_interval`` here.

The frame log IS the checkpoint/resume mechanism: ``OfflineBundle.resume``
rebuilds from the npz directory + pose-graph JSON.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.config import PipelineConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu.core.types import RGBDFrame
from azurekinect3dreconstruction_tpu.io.replay import FrameRecorder, NpzReplaySource
from azurekinect3dreconstruction_tpu.tracking.odometry import compute_odometry
from azurekinect3dreconstruction_tpu.tracking import posegraph as pg
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu.utils.telemetry import Telemetry, log_info, log_warning
from azurekinect3dreconstruction_tpu.viz.savers import ResultSaver


class OfflineBundle:
    def __init__(self, intrinsics: Intrinsics, config: Optional[PipelineConfig] = None,
                 output_dir: str = "reconstruction_output",
                 loop_radius: float = 0.5, loop_min_gap: int = 20,
                 loop_check_interval: int = 10, checkpoint_interval: int = 100):
        self.intr = intrinsics
        self.cfg = config or PipelineConfig()
        self.rays = pixel_rays(intrinsics)
        self.output_dir = output_dir
        self.frames_dir = os.path.join(output_dir, "frames")
        self.recorder = FrameRecorder(self.frames_dir)
        self.graph = pg.PoseGraph()
        self.prev: Optional[RGBDFrame] = None
        self.loop_radius = loop_radius
        self.loop_min_gap = loop_min_gap
        self.loop_check_interval = loop_check_interval
        self.checkpoint_interval = checkpoint_interval
        self._known_loops = set()
        self.last_finalize_stats: dict = {}
        self.telemetry = Telemetry()
        self.saver = ResultSaver(output_dir)

    @property
    def n_frames(self) -> int:
        return len(self.graph.nodes)

    def process_frame(self, depth_raw, color_raw) -> np.ndarray:
        """Track + log one frame (no integration until finalize)."""
        cam = self.cfg.camera
        frame = RGBDFrame.from_raw(depth_raw, color_raw, cam.depth_scale,
                                   cam.depth_trunc, cam.depth_min)
        self.recorder.write(depth_raw, color_raw)

        if self.prev is None:
            self.graph.add_node(np.eye(4))
        else:
            res = compute_odometry(self.prev.intensity, self.prev.depth,
                                   frame.intensity, frame.depth,
                                   self.intr, self.cfg.odometry)
            ok = float(res.fitness) > 0.3
            T_rel = (np.linalg.inv(np.asarray(res.T_target_source, np.float64))
                     if ok else np.eye(4))
            if not ok:
                self.telemetry.count("odo_fail")
                log_warning("odometry failed; identity edge")
            i = len(self.graph.nodes)
            self.graph.add_node(self.graph.nodes[-1] @ T_rel)
            # edge (i-1, i): transform mapping node-i coords into node-(i-1)
            self.graph.add_edge(i - 1, i, T_rel)

            if i % self.loop_check_interval == 0:
                self._detect_loops()
            if self.checkpoint_interval and i % self.checkpoint_interval == 0:
                self.graph.save(os.path.join(self.output_dir, "pose_graph.json"))

        self.prev = frame
        self.telemetry.tick_frame()
        self.telemetry.maybe_report()
        return self.graph.nodes[-1]

    def _detect_loops(self) -> int:
        """Positional loop closures + online re-optimization (reference
        :246-273). The loop edge itself is measured by odometry between the
        two logged frames."""
        positions = [n[:3, 3] for n in self.graph.nodes]
        cands = pg.find_loop_closures(positions, self.loop_radius,
                                      self.loop_min_gap, exclude=self._known_loops)
        added = 0
        src = NpzReplaySource(self.frames_dir)
        files = src._files
        cam = self.cfg.camera
        for i, j in cands[:3]:  # bound per check (keeps the live loop real-time)
            self._known_loops.add((i, j))
            fi = self._load_frame(files[i])
            fj = self._load_frame(files[j])
            res = compute_odometry(fi.intensity, fi.depth, fj.intensity, fj.depth,
                                   self.intr, self.cfg.odometry)
            if float(res.fitness) < 0.5:
                continue
            T_rel = np.linalg.inv(np.asarray(res.T_target_source, np.float64))
            self.graph.add_edge(i, j, T_rel, uncertain=True)
            added += 1
        if added:
            log_info(f"added {added} loop closure(s); re-optimizing online")
            self.graph = pg.optimize(self.graph, max_iterations=15)
            self.telemetry.count("loop_closures", added)
        return added

    def _load_frame(self, path) -> RGBDFrame:
        cam = self.cfg.camera
        with np.load(path) as data:
            d, c = np.asarray(data["depth"]), np.asarray(data["color"])
        if c.ndim == 3 and c.shape[2] == 4:
            c = c[..., 2::-1]
        return RGBDFrame.from_raw(d, c, cam.depth_scale, cam.depth_trunc,
                                  cam.depth_min)

    # -- finalize: optimize + reintegrate (reference :285-344) ---------------
    def finalize(self, extract: bool = True):
        """Optimize the pose graph, reset the volume and reintegrate every
        logged frame at its optimized pose (the reference's finalize,
        bundlefusion_reconstruction.py:285-344). Wall time of each stage is
        recorded in ``self.last_finalize_stats`` (loops_s / optimize_s /
        reintegrate_s / extract_s, plus n_frames) — finalize is the
        longest user-visible wait in the offline flow, so its cost is a
        tracked bench metric (offline_reintegrate_fps)."""
        import time as _time

        stats = {"n_frames": len(self.graph.nodes)}
        _t0 = _time.perf_counter()
        log_info("finalizing: global optimization + reintegration")
        # one last loop sweep before the global solve: the cadence check
        # never sees the final frames, and a scan usually ENDS where it
        # started — the strongest loop edge is the one that closes the
        # whole trajectory (the reference misses it: its shutdown path only
        # re-optimizes edges found mid-run, bundlefusion_reconstruction.py:285-305)
        if len(self.graph.nodes) > self.loop_min_gap:
            self._detect_loops()
        stats["loops_s"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        self.graph.save(os.path.join(self.output_dir, "pose_graph.json"))
        self.graph = pg.optimize(self.graph, max_iterations=50,
                                 edge_prune_threshold=0.25,
                                 preference_loop_closure=2.0)
        stats["optimize_s"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        volume = tsdf.create(self.cfg.tsdf)  # volume.reset() analog
        volume = self._reintegrate(volume)
        jax.block_until_ready(volume.tsdf)
        stats["reintegrate_s"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        self.volume = volume
        self.last_finalize_stats = stats
        if not extract:
            return None
        mesh = mc.extract_mesh(volume, self.cfg.tsdf).compact()
        mesh = mc.weld_vertices(mesh)
        mesh.compute_vertex_normals()
        self.saver.save_mesh(mesh, kind="optimized_mesh")
        self.saver.save_trajectory(self.graph.nodes, kind="optimized_trajectory")
        stats["extract_s"] = _time.perf_counter() - _t0
        return mesh

    def _reintegrate(self, volume, chunk: int = 16):
        """Replay every logged frame into ``volume`` at its optimized pose
        via the batched raw scan (:func:`make_raw_batch_fn`): decode +
        allocate + integrate for a whole chunk is ONE dispatch, and the
        next chunk's raw frames upload while the current one computes.
        The reference pays a per-frame Open3D integrate here
        (bundlefusion_reconstruction.py:329-344)."""
        from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
            make_raw_batch_fn,
        )

        src = NpzReplaySource(self.frames_dir)
        cam = self.cfg.camera
        n = min(len(src), len(self.graph.nodes))
        if n == 0:
            return volume
        batch_fn = make_raw_batch_fn(self.intr, self.cfg.tsdf)
        scalars = (np.float32(1.0 / cam.depth_scale),
                   np.float32(cam.depth_min), np.float32(cam.depth_trunc))

        frames = src.frames()

        def host_chunk(a):
            b = min(a + chunk, n)
            ds, cs = zip(*(next(frames) for _ in range(b - a)))
            Ts = [np.asarray(self.graph.nodes[i], np.float32)
                  for i in range(a, b)]
            pad = chunk - (b - a)
            if pad:  # zero depth integrates nothing (fails the min mask)
                ds += tuple(np.zeros_like(ds[0]) for _ in range(pad))
                cs += tuple(np.zeros_like(cs[0]) for _ in range(pad))
                Ts += [np.eye(4, dtype=np.float32)] * pad
            return (np.stack(ds), np.stack(cs),
                    np.stack(Ts).astype(np.float32))

        staged = jax.device_put(host_chunk(0))
        for a in range(0, n, chunk):
            nxt = (jax.device_put(host_chunk(a + chunk))
                   if a + chunk < n else None)
            volume = batch_fn(volume, *staged, self.rays, *scalars)
            staged = nxt
        return volume

    # -- resume from the frame log (checkpoint/resume) ------------------------
    @staticmethod
    def resume(intrinsics: Intrinsics, output_dir: str,
               config: Optional[PipelineConfig] = None, **kw) -> "OfflineBundle":
        self = OfflineBundle(intrinsics, config, output_dir=output_dir, **kw)
        pgp = os.path.join(output_dir, "pose_graph.json")
        if os.path.exists(pgp):
            self.graph = pg.PoseGraph.load(pgp)
        src = NpzReplaySource(self.frames_dir)
        self.recorder.count = len(src)
        if len(src) and len(self.graph.nodes) < len(src):
            # re-track any frames logged after the last checkpoint
            for i, (d, c) in enumerate(src):
                if i < len(self.graph.nodes):
                    cam = self.cfg.camera
                    self.prev = RGBDFrame.from_raw(d, c, cam.depth_scale,
                                                   cam.depth_trunc, cam.depth_min)
                    continue
                self.recorder.count -= 1  # process_frame rewrites the log entry
                self.process_frame(d, c)
        return self
