"""Two-camera fusion with one-shot extrinsic auto-calibration.

Pipeline parity: reference BetterVisualizer2CamWorksROTATEsave2.py
(== CreateMesh.py) and the whole BetterVisualizer2Cam* family: per-camera
capture threads feed latest-wins frames (io.streams here), the first good
frame pair auto-calibrates camera-1's extrinsic by FPFH+RANSAC with an ICP
refinement on recalibration ('R' key) (:221-284, :609-665, overlap gate
>= 0.2 at :640), clouds merge + voxel-downsample for display (:766-829),
depth-gradient color modes (:685-721), and 'S' saves PLY + meshes (:414-462).

Device-first differences: the calibrated hot loop is ONE jitted dispatch per
frame pair — decode of BOTH raw sensor frames + allocate + integrate for
both cameras fuse into a single executable (:func:`make_raw_dual_step`;
the reference eagerly converts each frame on the host every loop,
CreateMesh.py:723-833), with extrinsics as traced inputs so recalibration
('R') never recompiles; the merged cloud is produced by fixed-capacity
voxel downsampling at display cadence; meshing on save uses the
TSDF+marching-cubes path (what the reference's "works" pipelines actually
render) with host Poisson as an optional export (meshing.poisson, gated on
Open3D).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.config import PipelineConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu.core.types import PointCloudHost, RGBDFrame
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu.ops.image import depth_gradient_colors
from azurekinect3dreconstruction_tpu.ops.neighbors import (
    estimate_normals_knn,
    remove_statistical_outliers,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu.tracking.features import compute_fpfh
from azurekinect3dreconstruction_tpu.tracking.icp import (
    TargetMaps,
    colored_icp,
    evaluate_registration,
    icp_point_to_plane,
)
from azurekinect3dreconstruction_tpu.tracking.ransac import global_registration
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu.utils.telemetry import Telemetry, log_info, log_warning
from azurekinect3dreconstruction_tpu.viz.savers import ResultSaver


class DualCameraFusion:
    """Feed synchronized (depth_u16, color_u8) pairs from two cameras."""

    COLOR_MODES = ("rgb", "depth_gradient", "uniform")

    def __init__(self, intrinsics: Tuple[Intrinsics, Intrinsics],
                 config: Optional[PipelineConfig] = None,
                 output_dir: str = "results",
                 sharded: bool = False, colored_calibration: bool = False):
        """``colored_calibration``: route the auto-calibration and 'R'-key
        recalibration through the colored-ICP refinement (see
        :meth:`calibrate`)."""
        self.intr = list(intrinsics)
        self.cfg = config or PipelineConfig()
        self.colored_calibration = colored_calibration
        self.rays = [pixel_rays(i) for i in self.intr]
        # camera 0 defines the world frame; extrinsics[i] = T_world_cam_i
        self.extrinsics = [np.eye(4), None]
        self.calibrated = False
        self.color_mode = "rgb"
        self.telemetry = Telemetry()
        self.saver = ResultSaver(output_dir)
        self._key = jax.random.PRNGKey(7)
        self.frame_index = 0
        self._last_frames: List[Optional[RGBDFrame]] = [None, None]
        self._last_raw = [None, None]  # device (depth_u16, color_u8) pairs
        self._frames_stale = False  # _last_frames behind _last_raw
        self._dual_step = None  # lazily-built fused raw pair step

        # sharded execution mode (SURVEY.md §2.3's prescribed design):
        # camera-per-mesh-row, volume block-sharded over the remaining
        # devices; collectives run inside one jitted step
        self.sharded = False
        if sharded:
            from azurekinect3dreconstruction_tpu.parallel import sharded_volume as sv

            n_dev = len(jax.devices())
            if n_dev < 2:
                raise ValueError(f"sharded dual fusion needs >= 2 devices, "
                                 f"have {n_dev}")
            if self.intr[0] != self.intr[1]:
                raise ValueError("sharded dual fusion requires identical "
                                 "camera intrinsics")
            self._sv = sv
            self.mesh = sv.make_mesh(2, n_dev // 2)
            self.volume = sv.create_sharded(self.cfg.tsdf, self.mesh)
            self._sharded_step = sv.make_sharded_raw_step(
                self.mesh, self.intr[0], self.cfg.tsdf, stride=2)
            self.sharded = True
            log_info(f"sharded dual fusion: mesh cam=2 x blk={n_dev // 2}")
        if not self.sharded:
            self.volume = tsdf.create(self.cfg.tsdf)

    # -- calibration (reference calibrate_cameras :609-665) -------------------
    def calibrate(self, frames: Tuple[RGBDFrame, RGBDFrame],
                  refine_only: bool = False, colored: bool = False) -> bool:
        """``colored``: refine the extrinsic with COLORED ICP instead of
        point-to-plane — the BASELINE config-4 combination (reference
        Works2CamerasCOLORVisualizer.py:189-279 family registers the color
        clouds). Two-camera rigs are typically calibrated against exactly
        the geometry point-to-plane cannot lock: a flat textured wall has
        three unconstrained DoF (two in-plane translations + in-plane
        rotation), so the p2p refinement can slide along it while every
        residual stays zero; the photometric term of
        :func:`tracking.icp.colored_icp` pins those DoF to the texture
        (Park et al.'s (1-λ) photometric + λ point-to-plane objective).
        Same overlap gate as the geometric path."""
        reg = self.cfg.registration
        clouds = []
        for i, f in enumerate(frames):
            pts = backproject_depth(f.depth, self.rays[i])[::4, ::4].reshape(-1, 3)
            mask = pts[:, 2] > 0
            ds, dm, _, _ = voxel_downsample_arrays(pts, mask, 0.02, 8192)
            dm = remove_statistical_outliers(ds, dm, k=12, radius=0.06)
            clouds.append((ds, dm))
        (p0, m0), (p1, m1) = clouds
        tgt = TargetMaps.from_depth(
            frames[0].depth, self.intr[0], rays=self.rays[0],
            intensity=frames[0].intensity if colored else None)

        def refine(init):
            if colored:
                # full-density organized source with per-pixel intensity
                # (the downsampled cloud has no color channel; stride 2
                # keeps the photometric term dense enough to grade texture)
                sp = backproject_depth(frames[1].depth,
                                       self.rays[1])[::2, ::2].reshape(-1, 3)
                si = frames[1].intensity[::2, ::2].reshape(-1)
                return colored_icp(sp, si, sp[:, 2] > 0, tgt, self.intr[0],
                                   init=init, cfg=reg)
            return icp_point_to_plane(p1, m1, tgt, self.intr[0], init=init,
                                      cfg=reg)

        if refine_only and self.extrinsics[1] is not None:
            # 'R'-key recalibration: ICP seeded by the current extrinsic
            # (reference :258-262)
            init = np.linalg.inv(self.extrinsics[0]) @ self.extrinsics[1]
            res = refine(jnp.asarray(init, jnp.float32))
            T01 = np.asarray(res.T, np.float64)
            fit = float(res.fitness)
        else:
            n0 = estimate_normals_knn(p0, m0, radius=0.04, k=12, orient_to=np.zeros(3))
            n1 = estimate_normals_knn(p1, m1, radius=0.04, k=12, orient_to=np.zeros(3))
            f0 = compute_fpfh(p0, n0, m0, radius=0.06, k=16)
            f1 = compute_fpfh(p1, n1, m1, radius=0.06, k=16)
            self._key, sub = jax.random.split(self._key)
            g = global_registration(p1, f1, m1, p0, f0, m0, sub, reg)
            # refine with projective ICP against camera 0's maps
            res = refine(g.T)
            T01 = np.asarray(res.T, np.float64)
            fit, _ = evaluate_registration(p1, m1, p0, m0,
                                           jnp.asarray(T01, jnp.float32),
                                           dist_thr=0.03)
            fit = float(fit)

        if fit < reg.min_overlap_extrinsic or not se3.is_valid_transform(T01):
            log_warning(f"calibration rejected (overlap {fit:.2f})")
            self.telemetry.count("calib_reject")
            return False
        # reject the reference's trace==4 identity degenerate case
        if abs(np.trace(T01) - 4.0) < 1e-6:
            log_warning("calibration returned identity; rejected")
            return False
        self.extrinsics[1] = self.extrinsics[0] @ T01
        self.calibrated = True
        r, p_, y = se3.rpy_from_matrix(T01[:3, :3])
        log_info(
            f"calibrated: overlap {fit:.2f}, t = {T01[:3, 3]}, "
            f"rpy = ({np.degrees(r):.1f}, {np.degrees(p_):.1f}, {np.degrees(y):.1f}) deg"
        )
        self.telemetry.count("calib_ok")
        return True

    def recalibrate(self) -> bool:
        """'R' key: ICP refinement from the current extrinsic."""
        frames = self._decoded_frames()
        if None in frames:
            return False
        return self.calibrate(tuple(frames), refine_only=True,
                              colored=self.colored_calibration)

    def _decoded_frames(self) -> List[Optional[RGBDFrame]]:
        """Decoded views of the most recent pair, produced ON DEMAND: the hot
        loop keeps only the raw device arrays (decode happens inside the
        fused step), so display/recalibration decode here at their own
        cadence instead of taxing every frame."""
        if self._frames_stale:
            cam = self.cfg.camera
            self._last_frames = [
                None if r is None else RGBDFrame.from_raw(
                    r[0], r[1], cam.depth_scale, cam.depth_trunc,
                    cam.depth_min)
                for r in self._last_raw
            ]
            self._frames_stale = False
        return self._last_frames

    def _get_dual_step(self):
        if self._dual_step is None:
            self._dual_step = make_raw_dual_step(
                self.intr[0], self.intr[1], self.cfg.tsdf)
        return self._dual_step

    # -- streaming -------------------------------------------------------------
    def process_frames(self, pair) -> None:
        """pair: ((depth0, color0), (depth1, color1)) raw u16/u8 arrays.

        Calibrated hot path: ONE jitted dispatch decodes + fuses both
        cameras (sharded mode: one collective dispatch, camera row each).
        Until calibration succeeds, the pair is also decoded eagerly so the
        FPFH+RANSAC calibration ladder can run (host work by design — it
        runs once per session, reference CreateMesh.py:609-665); camera 1's
        depth is zeroed inside the step (``cam1_on=0``) so it contributes
        nothing to the volume."""
        cam = self.cfg.camera
        self._last_raw = [(jnp.asarray(d), jnp.asarray(c)) for d, c in pair]
        self._frames_stale = True
        if not self.calibrated:
            self.calibrate(tuple(self._decoded_frames()),
                           colored=self.colored_calibration)
        on1 = jnp.float32(1.0 if self.calibrated else 0.0)
        T0 = jnp.asarray(self.extrinsics[0], jnp.float32)
        T1 = jnp.asarray(self.extrinsics[1] if self.calibrated else np.eye(4),
                         jnp.float32)
        (d0r, c0r), (d1r, c1r) = self._last_raw
        with self.telemetry.time_block("step"):
            if self.sharded:
                self.volume = self._sharded_step(
                    self.volume,
                    jnp.stack([d0r, d1r]), jnp.stack([c0r, c1r]),
                    jnp.stack([T0, T1]), self.rays[0],
                    jnp.stack([jnp.float32(1.0), on1]),
                    1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc)
            else:
                self.volume = self._get_dual_step()(
                    self.volume, d0r, c0r, d1r, c1r,
                    self.rays[0], self.rays[1], T0, T1,
                    1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc,
                    on1)
        self.frame_index += 1
        self.telemetry.tick_frame()
        self.telemetry.maybe_report(
            extra=f"calibrated {self.calibrated} mode {self.color_mode}")

    def merged_cloud(self, max_points: int = 200000) -> PointCloudHost:
        """Merged + downsampled display cloud with the active color mode
        (reference update_visualization :723-833 + apply_depth_colors)."""
        pts_all, col_all, msk_all = [], [], []
        for i, f in enumerate(self._decoded_frames()):
            pose = self.extrinsics[i]
            if f is None or pose is None:
                continue
            pts = backproject_depth(f.depth, self.rays[i])
            if self.color_mode == "depth_gradient":
                cols = depth_gradient_colors(f.depth, far=self.cfg.camera.depth_trunc)
            elif self.color_mode == "uniform":
                base = np.array([[0.9, 0.4, 0.2], [0.2, 0.5, 0.9]][i % 2], np.float32)
                cols = jnp.broadcast_to(base, pts.shape)
            else:
                cols = f.color
            flat = pts.reshape(-1, 3)
            w = se3.transform_points(jnp.asarray(pose, jnp.float32), flat)
            pts_all.append(w)
            col_all.append(cols.reshape(-1, 3))
            # validity from CAMERA-frame depth, before the transform —
            # invalid pixels backproject to the camera center in world
            # coordinates, which is far from the origin for camera 1
            msk_all.append(flat[:, 2] > 0)
        if not pts_all:
            return PointCloudHost(points=np.zeros((0, 3), np.float32))
        allp = jnp.concatenate(pts_all)
        allc = jnp.concatenate(col_all)
        mask = jnp.concatenate(msk_all)
        dp, dm, dc, _ = voxel_downsample_arrays(
            allp, mask, self.cfg.voxel_downsample, max_points, colors=allc)
        m = np.asarray(dm)
        return PointCloudHost(points=np.asarray(dp)[m], colors=np.asarray(dc)[m])

    def cycle_color_mode(self) -> str:
        i = self.COLOR_MODES.index(self.color_mode)
        self.color_mode = self.COLOR_MODES[(i + 1) % len(self.COLOR_MODES)]
        return self.color_mode

    def extraction_volume(self):
        """The volume extraction should run on: in sharded mode, the shard
        pools combined so boundary cells see their cross-shard neighbors
        (seam-free — parallel.sharded_volume.combine_shards)."""
        if self.sharded:
            return self._sv.combine_shards(self.volume, self.cfg.tsdf,
                                           self.mesh.shape["blk"])
        return self.volume

    # -- save ('S' key; reference save_current_state :414-462) -----------------
    def save_current_state(self, poisson: bool = False) -> dict:
        paths = {}
        cloud = self.merged_cloud()
        if len(cloud):
            paths["pointcloud"] = self.saver.save_point_cloud(cloud, kind="merged")
        mesh = mc.extract_mesh(self.extraction_volume(), self.cfg.tsdf).compact()
        mesh = mc.weld_vertices(mesh)
        mesh.compute_vertex_normals()
        paths["mesh"] = self.saver.save_mesh(mesh, kind="mesh", obj=True)
        paths["preview"] = self.saver.save_preview(mesh)
        if poisson:
            from azurekinect3dreconstruction_tpu.meshing.poisson import (
                poisson_mesh_from_cloud,
            )

            pmesh = poisson_mesh_from_cloud(cloud)
            if pmesh is not None:
                paths["poisson"] = self.saver.save_mesh(pmesh, kind="poisson_mesh",
                                                        obj=True)
        log_info(f"saved: {paths}")
        return paths


# ---------------------------------------------------------------------------
# fused raw pair step: decode + allocate + integrate BOTH cameras, one dispatch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def make_raw_dual_step(intr0: Intrinsics, intr1: Intrinsics, tcfg,
                       worklist_size: int = 2048, stride: int = 2):
    """The two-camera live hot path (the repo's namesake pipeline): ONE
    jitted dispatch per frame PAIR, fed raw sensor arrays. Decode for both
    cameras, allocation and integration of both frames all fuse into a
    single executable — per pair the host does two raw transfers and one
    dispatch (the reference decodes each frame eagerly on the host and
    issues separate Open3D calls per camera, CreateMesh.py:723-833).

    step(vol, depth_raw0, color_raw0, depth_raw1, color_raw1, rays0, rays1,
         T0 (4,4), T1 (4,4), inv_scale, depth_min, depth_trunc, cam1_on)
        -> vol

    Extrinsics ride along as TRACED inputs: 'R'-key recalibration just
    changes the arrays, no recompile. ``cam1_on=0`` zeroes camera 1's
    decoded depth (invalid to allocate AND integrate — the
    :func:`apply_lost_latch` trick), so the same executable serves the
    uncalibrated warm-up frames. Decode scalars are traced for the live
    '=/-/[/]' depth retuning (reference CreateMesh.py:470-501).
    """
    from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
        decode_raw_frame,
    )

    def fuse(vol, d, c, T, rays, intr):
        return tsdf.integrate_frame(vol, d, c, rays, T, intr, tcfg,
                                    stride=stride, worklist_size=worklist_size)

    def step(vol, depth_raw0, color_raw0, depth_raw1, color_raw1, rays0,
             rays1, T0, T1, inv_scale, depth_min, depth_trunc, cam1_on):
        d0, c0, _ = decode_raw_frame(depth_raw0, color_raw0, inv_scale,
                                     depth_min, depth_trunc)
        d1, c1, _ = decode_raw_frame(depth_raw1, color_raw1, inv_scale,
                                     depth_min, depth_trunc)
        d1 = d1 * jnp.asarray(cam1_on, jnp.float32)
        vol = fuse(vol, d0, c0, jnp.asarray(T0, jnp.float32), rays0, intr0)
        vol = fuse(vol, d1, c1, jnp.asarray(T1, jnp.float32), rays1, intr1)
        return vol

    return jax.jit(step, donate_argnums=(0,))
