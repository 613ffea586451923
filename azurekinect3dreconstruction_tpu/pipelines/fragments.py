"""Staged fragment pipeline: capture -> make fragments -> register -> refine
-> integrate.

Pipeline parity: reference azure-kinect-DK/Reconstruction/3Dreconstruction.py
(the documented 4-stage "Open3D reconstruction system" layout :1-7):
``make_fragments`` builds a processed cloud + surface mesh per captured
frame (:81-110 — reference meshes each fragment with Poisson; here a
single-frame TSDF + marching cubes plays that role, device-native),
``register_fragments`` coarsely aligns each fragment to fragment 0 with
POINT-TO-POINT ICP on 100k uniformly sampled mesh points (:112-135 uses
``TransformationEstimationPointToPoint`` on ``sample_points_uniformly``
clouds, :118-122), ``refine_registration`` runs tighter point-to-plane ICP
(:137-160), and ``integrate_scene`` fuses all frames into a TSDF with the
estimated poses and extracts the mesh (:162-176).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.config import PipelineConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu.core.types import PointCloudHost, RGBDFrame
from azurekinect3dreconstruction_tpu.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu.ops.neighbors import (
    estimate_normals_knn,
    remove_statistical_outliers,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu.tracking.icp import icp_grid, icp_point_to_point
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info, log_warning


class Fragment:
    def __init__(self, frame: RGBDFrame, points, mask, normals):
        self.frame = frame
        self.points = points  # (N, 3) downsampled, device
        self.mask = mask
        self.normals = normals
        self.pose = np.eye(4)  # T_world_fragment
        self.samples = None  # (S, 3) uniform mesh-surface samples (device)
        self.sample_normals = None


class FragmentPipeline:
    def __init__(self, intrinsics: Intrinsics,
                 config: Optional[PipelineConfig] = None,
                 downsample: float = 0.02, capacity: int = 16384,
                 mesh_fragments: bool = True, sample_points: int = 100_000):
        self.intr = intrinsics
        self.cfg = config or PipelineConfig()
        self.rays = pixel_rays(intrinsics)
        self.downsample = downsample
        self.capacity = capacity
        self.mesh_fragments = mesh_fragments
        self.sample_points = sample_points
        self.captured: List[RGBDFrame] = []
        self.fragments: List[Fragment] = []

    # stage 0: manual capture (reference 'c' key :242-257)
    def capture(self, depth_raw, color_raw) -> int:
        cam = self.cfg.camera
        self.captured.append(
            RGBDFrame.from_raw(depth_raw, color_raw, cam.depth_scale,
                               cam.depth_trunc, cam.depth_min))
        log_info(f"captured frame {len(self.captured)}")
        return len(self.captured)

    # stage 1: make fragments (:81-110)
    def make_fragments(self) -> int:
        self.fragments = []
        for f in self.captured:
            pts = backproject_depth(f.depth, self.rays)[::2, ::2].reshape(-1, 3)
            mask = pts[:, 2] > 0
            dp, dm, _, _ = voxel_downsample_arrays(pts, mask, self.downsample,
                                                   self.capacity)
            dm = remove_statistical_outliers(dp, dm, k=12, radius=3 * self.downsample)
            nrm = estimate_normals_knn(dp, dm, radius=3 * self.downsample, k=12,
                                       orient_to=np.zeros(3))
            frag = Fragment(f, dp, dm, nrm)
            if self.mesh_fragments:
                self._mesh_fragment(frag)
            self.fragments.append(frag)
        log_info(f"made {len(self.fragments)} fragments")
        return len(self.fragments)

    def _mesh_fragment(self, frag: Fragment):
        """Per-fragment surface mesh + uniform samples: the reference meshes
        each fragment (Poisson, :97-108) and registers sampled points
        (:118-122); here the surface comes from a single-frame TSDF +
        marching cubes (the device-native mesher)."""
        import dataclasses as _dc

        from azurekinect3dreconstruction_tpu.meshing.sampling import (
            sample_points_uniformly,
        )

        fcfg = _dc.replace(self.cfg.tsdf, voxel_size=max(
            self.cfg.tsdf.voxel_size, self.downsample / 2), sdf_trunc=max(
            self.cfg.tsdf.sdf_trunc, self.downsample))
        vol = tsdf.create(fcfg)
        vol = tsdf.integrate_frame(
            vol, frag.frame.depth, frag.frame.color, self.rays,
            jnp.eye(4, dtype=jnp.float32), self.intr, fcfg)
        mesh = mc.extract_mesh(vol, fcfg).compact()
        mesh = mc.weld_vertices(mesh).compute_vertex_normals()
        cloud = sample_points_uniformly(mesh, self.sample_points, seed=0)
        frag.samples = jnp.asarray(cloud.points)
        frag.sample_normals = jnp.asarray(cloud.normals)

    # stage 2+3: register + refine against fragment 0 (:112-160)
    def register_fragments(self, coarse_dist: float = 0.08,
                           fine_dist: float = 0.02) -> List[np.ndarray]:
        if not self.fragments:
            self.make_fragments()
        base = self.fragments[0]
        ones = None
        for i, frag in enumerate(self.fragments[1:], start=1):
            if self.mesh_fragments and frag.samples is not None:
                # reference register stage: POINT-TO-POINT on sampled mesh
                # points (3Dreconstruction.py:112-135)
                if ones is None:
                    ones = jnp.ones((base.samples.shape[0],), jnp.bool_)
                s_ones = jnp.ones((frag.samples.shape[0],), jnp.bool_)
                # finer cells + more slots keep the dense 100k-sample target
                # intact (default dist_thr-sized cells would decimate it to
                # max_per_cell points per 8 cm cell)
                coarse = icp_point_to_point(
                    frag.samples, s_ones, base.samples, ones,
                    max_iters=30, dist_thr=coarse_dist,
                    cell_size=coarse_dist / 2, max_per_cell=16,
                    capacity=65536)
                # refine stage: point-to-plane, tighter threshold (:137-160)
                fine = icp_grid(frag.samples, s_ones, base.samples,
                                base.sample_normals, ones, init=coarse.T,
                                max_iters=30, dist_thr=fine_dist)
            else:
                coarse = icp_grid(frag.points, frag.mask, base.points,
                                  base.normals, base.mask, max_iters=30,
                                  dist_thr=coarse_dist)
                fine = icp_grid(frag.points, frag.mask, base.points,
                                base.normals, base.mask, init=coarse.T,
                                max_iters=30, dist_thr=fine_dist)
            if float(fine.fitness) < 0.3:
                log_warning(f"fragment {i}: low fitness {float(fine.fitness):.2f}")
            frag.pose = np.asarray(fine.T, np.float64)
            log_info(f"fragment {i}: fitness {float(fine.fitness):.2f} "
                     f"rmse {float(fine.inlier_rmse) * 1000:.1f}mm")
        return [f.pose for f in self.fragments]

    # stage 4: integrate the scene (:162-176)
    def integrate_scene(self):
        vol = tsdf.create(self.cfg.tsdf)
        for frag in self.fragments:
            vol = tsdf.integrate_frame(
                vol, frag.frame.depth, frag.frame.color, self.rays,
                jnp.asarray(frag.pose, jnp.float32), self.intr, self.cfg.tsdf,
            )
        self.volume = vol
        mesh = mc.extract_mesh(vol, self.cfg.tsdf).compact()
        mesh = mc.weld_vertices(mesh)
        mesh.compute_vertex_normals()
        return mesh

    def run(self):
        """All stages on whatever was captured."""
        self.make_fragments()
        self.register_fragments()
        return self.integrate_scene()
