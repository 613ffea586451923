"""Tracking-loss recovery: global frame-to-MODEL re-registration.

The reference's only answers to lost tracking are a full scene reset (the
'C' key / scene-change path, CodeThatWorks/1camera-detectsSceneChanges.py:202-212)
and silently continuing with identity motion (:258-260) — after an occlusion
or a camera jump, everything integrated afterwards lands at a stale pose and
the map is ruined. Its keyframe recorder has a frame-to-PREVIOUS-frame
FPFH+RANSAC fallback (GoodColorReconstruction.py:161-204), but that only
helps when the previous frame is itself well-posed; once the pose chain is
corrupt, no frame-to-frame machinery can recover.

Production voxel-hashing systems relocalize against the MAP instead
(KinectFusion-style): when tracking is declared lost, globally register the
incoming frame against surface samples of the fused TSDF model, refine with
ICP, and resume from the recovered world pose. This module composes the
framework's existing registration stack into exactly that:

0. hint rung — when the caller has a pose hint (the loss site: the camera
   usually reappears near where it was lost), coarse-to-fine projective
   model-ICP seeded by the hint, BEFORE any feature machinery. This is the
   KinectFusion-style recovery: it needs no FPFH (so it works on the
   feature-degenerate geometry — spheres, bare walls — that starves
   descriptor matching) and costs a few dispatches instead of a RANSAC
   ladder. Because no feature consensus backs the seed, its acceptance
   gate is STRICTER than the global rung's: inlier count AND a high
   VISIBLE-normalized projective overlap of the model against the dense
   frame maps (``icp.projective_overlap``; ``hint_gate_fitness``, default
   0.8 — at the true pose the in-view model lies almost entirely ON the
   frame surface, while a wrong-basin ICP slide leaves the misaligned
   relief/props uncovered; cloud-to-cloud overlap is NOT used here
   because it saturates at the budgeted model's sampling density);
1. model cloud — budget-bounded, pool-order-unbiased marching-cubes vertex
   samples (``mc.extract_surface_samples``, shared with the frame-to-model
   tracking mode), in WORLD coordinates;
2. FPFH features on both clouds (voxel-downsampled, PCA normals; the model
   cloud's normals orient toward the last-known camera position — the best
   available viewpoint proxy, and FPFH's angle histograms are sign-aware);
3. multi-restart parallel-hypothesis RANSAC
   (``tracking.ransac.global_registration``), candidates ranked and gated by
   ``evaluate_registration`` cloud-overlap fitness — the reference's fitness
   SEMANTICS (GoodColorReconstruction.py:183) — because the RANSAC
   correspondence-inlier share is pessimistic on smooth geometry (same
   reasoning as pipelines/cloud_accumulator._coarse_seed);
4. projective point-to-plane ICP of the FULL model sample set onto the
   frame's organized maps (same shape as the frame-to-model refinement,
   pipelines/mono_odometry_tsdf._refine_against_model), gated on inlier
   COUNT — most of a grown map legitimately projects outside one frame, so
   a fitness ratio would reject every correct recovery.

The pipeline side (``MonoOdometryTSDF(relocalize=True)``) decides WHEN this
runs; apart from its RNG, counters and a model-feature cache keyed on the
volume's (immutable) array identity — so handing it a different or updated
volume can never reuse stale geometry — the class carries no state across
attempts and can be driven standalone against any volume + frame.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.config import PipelineConfig
from azurekinect3dreconstruction_tpu.core import se3
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu.ops.neighbors import (
    count_occupied_cells,
    estimate_normals_knn,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu.tracking.features import compute_fpfh
from azurekinect3dreconstruction_tpu.tracking.icp import (
    TargetMaps,
    evaluate_registration,
    icp_projective,
    projective_overlap,
)
from azurekinect3dreconstruction_tpu.tracking.ransac import global_registration
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as mc


class Relocalizer:
    """Recover a world pose for one RGB-D frame from the fused model.

    Feature-stage constants default to the recorder ladder's proven values
    (pipelines/recorder.py: 2 cm downsample voxel, 4 cm/k=12 normals,
    6 cm/k=16 FPFH).
    """

    def __init__(self, intr: Intrinsics, cfg: Optional[PipelineConfig] = None,
                 rays=None, model_points: int = 32768,
                 feature_points: int = 8192, downsample_voxel: float = 0.015,
                 min_inliers: int = 2000, min_depth_pixels: int = 2000,
                 restarts: int = 4, stride: Optional[int] = None,
                 hint_gate_fitness: float = 0.8, seed: int = 0):
        self.intr = intr
        self.cfg = cfg or PipelineConfig()
        self.rays = pixel_rays(intr) if rays is None else rays
        self.model_points = model_points
        self.feature_points = feature_points
        self.downsample_voxel = downsample_voxel
        self.min_inliers = min_inliers
        self.min_depth_pixels = min_depth_pixels
        self.restarts = restarts
        self.hint_gate_fitness = hint_gate_fitness
        # pixel stride bounds the frame cloud fed to the voxel grid at
        # <= ~32k points whatever the image scale (full 640x576 -> 4, the
        # quarter-scale test frames -> 1); ceil because the bound is the
        # contract (round() gave 3 -> 41k points at full res)
        self.stride = stride or max(
            1, int(np.ceil(np.sqrt(intr.height * intr.width / 32768.0))))
        self._key = jax.random.PRNGKey(seed)
        self.n_attempts = 0
        self.n_success = 0
        self.n_hint_success = 0  # recoveries by rung 0 (hint ICP) alone
        self.last_reject = ""  # observability: why the last attempt failed
        # model-side work cache: while the pose is lost the pipeline PAUSES
        # fusion, so across an episode's retries the volume (and the stale
        # pose hint that orients the model normals) is frozen — the model
        # extraction + features recompute for nothing. Keyed by the IDENTITY
        # of the volume's tsdf array (jax arrays are immutable, so any
        # fusion/eviction/reload produces a new array object) + the hint
        # position; the array itself is pinned in the entry so its id cannot
        # be recycled while cached. One entry (episodes don't interleave).
        # Layout: (key, pinned_tsdf, mpts, mmask, fitted_vox,
        #          {vox_rung: (m_ds, m_dm, m_f)}).
        self._model_cache = None

    def warmup(self, vol=None) -> float:
        """Pre-compile the full attempt path; returns elapsed seconds.

        The first attempt of a process's first loss episode otherwise pays
        every trace+compile in the ladder (~55 s measured on the real chip
        at 640x576 — the live scanner freezes for a minute exactly when the
        user is waving the camera trying to recover). All shape-bearing
        inputs are known at construction (frame shape from the intrinsics,
        cloud budgets from the constructor), and every scale parameter
        (ladder voxel, radii, thresholds) rides as a traced scalar, so ONE
        dummy attempt compiles everything a real episode will dispatch.
        Runs against ``vol`` when given (shares the extraction-prefix bucket
        with the live scene) or a scratch single-frame volume otherwise;
        counters/RNG/model-cache are restored so warmup is invisible to the
        episode logic and to determinism.
        """
        import time

        from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf

        t0 = time.perf_counter()
        h, w = self.rays.shape[:2]
        # gently curved tilted plane: full-valid, non-degenerate normals and
        # spread FPFH histograms (a flat plane would still compile, but NaN
        # guards in the PCA/RANSAC path get exercised on realistic values)
        u = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
        v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
        depth = (1.0 + 0.25 * u + 0.15 * v
                 + 0.05 * np.sin(6.0 * np.pi * u) * np.cos(4.0 * np.pi * v))
        depth = jnp.asarray(depth, jnp.float32)
        if vol is None:
            vol = tsdf.create(self.cfg.tsdf)
            vol = tsdf.integrate_frame(
                vol, depth, jnp.zeros((h, w, 3), jnp.float32), self.rays,
                jnp.eye(4, dtype=jnp.float32), self.intr, self.cfg.tsdf)
        state = (self._key, self.n_attempts, self.n_success,
                 self.n_hint_success, self.last_reject, self._model_cache)
        try:
            # two dummy attempts: WITH a hint (compiles the rung-0 ICP pair
            # + overlap gate — and succeeds, short-circuiting) and WITHOUT
            # (skips rung 0, compiles the descriptor/RANSAC/refine ladder)
            self.attempt(vol, depth, T_hint=np.eye(4))
            self.attempt(vol, depth, T_hint=None)
        finally:
            (self._key, self.n_attempts, self.n_success,
             self.n_hint_success, self.last_reject, self._model_cache) = state
        return time.perf_counter() - t0

    def _fit_voxel(self, pts, mask) -> float:
        """Smallest ladder voxel at which the cloud fits the feature budget
        with headroom. A saturated voxel_downsample_arrays silently drops
        overflow cells, and the dropped sets differ between clouds —
        measured (full 640x576 frames, 1.5 cm start voxel) to cap both
        clouds at the budget with divergent survivors and kill FPFH
        matching entirely (RANSAC overlap 0.11 vs 0.48 at the true pose).
        The ladder is x1.5 from ``downsample_voxel`` (one compile of the
        counter per cloud shape; cell_size rides as a traced scalar), so
        rungs are discrete and cache-keyable."""
        vox = self.downsample_voxel
        budget = int(0.75 * self.feature_points)
        for _ in range(6):
            if int(count_occupied_cells(pts, mask, vox)) <= budget:
                break
            vox *= 1.5
        return vox

    def _enrich(self, ds, dm, orient_to, vox):
        """PCA normals -> FPFH on an already-downsampled cloud (the
        coarse-stage ladder with its proven radii — 2x/4x the grid voxel,
        cloud_accumulator), shared verbatim between the frame and model
        clouds so both feature sets see identical binning. Split from the
        downsample so the hint rung (which needs only the clouds for its
        overlap gate) never pays for descriptors."""
        n = estimate_normals_knn(ds, dm, radius=2 * vox, k=12,
                                 orient_to=orient_to)
        return compute_fpfh(ds, n, dm, radius=4 * vox, k=16)

    def attempt(self, vol, depth, T_hint=None) -> Optional[np.ndarray]:
        """Try to relocalize one frame against the fused volume.

        ``depth``: decoded (H, W) meters (0 = invalid), device or host.
        ``T_hint``: last-known/predicted T_world_cam — ONLY used to orient
        the model cloud's normals (a wrong hint degrades FPFH matching but
        cannot bias the recovered pose). Returns the recovered 4x4
        T_world_cam (float64) or None; ``last_reject`` says why on None.
        """
        reg = self.cfg.registration
        self.n_attempts += 1
        depth = jnp.asarray(depth, jnp.float32)
        # cheap pre-gate: an occluded/empty frame (the usual cause of the
        # loss) cannot be registered — skip the FPFH machinery entirely
        if int(jnp.sum(depth > 0)) < self.min_depth_pixels:
            self.last_reject = "empty_frame"
            return None

        # model cloud (world frame), unbiased budget subsample — cached
        # across an episode's retries (fusion is paused while lost, so the
        # volume and the stale hint are frozen; see _model_cache)
        cam_pos = (np.zeros(3) if T_hint is None
                   else np.asarray(T_hint, np.float64)[:3, 3])
        ck = (id(vol.tsdf), cam_pos.tobytes())
        if self._model_cache is None or self._model_cache[0] != ck:
            mpts, mmask, _ovf = mc.extract_surface_samples(
                vol, self.cfg.tsdf, self.model_points)
            self._model_cache = (ck, vol.tsdf, mpts, mmask,
                                 self._fit_voxel(mpts, mmask), {})
        _, _, mpts, mmask, m_vox, m_feats = self._model_cache

        # frame cloud (camera frame); normals orient to the camera origin
        src = backproject_depth(depth, self.rays)
        src = src[::self.stride, ::self.stride].reshape(-1, 3)
        s_mask = src[:, 2] > 0
        # ONE voxel for both clouds (identical feature binning), fitted so
        # neither saturates its grid; model downsample + features memoized
        # per rung ({vox: [m_ds, m_dm, m_f-or-None]} — descriptors lazy)
        vox = max(m_vox, self._fit_voxel(src, s_mask))
        if vox not in m_feats:
            ds_, dm_, _, _ = voxel_downsample_arrays(mpts, mmask, vox,
                                                     self.feature_points)
            m_feats[vox] = [ds_, dm_, None]
        m_ds, m_dm, _ = m_feats[vox]
        s_ds, s_dm, _, _ = voxel_downsample_arrays(src, s_mask, vox,
                                                   self.feature_points)
        maps = TargetMaps.from_depth(depth, self.intr, rays=self.rays)
        eval_thr = max(0.05, 3.0 * vox)

        # rung 0: hint-seeded coarse-to-fine model ICP (module docstring).
        # No feature consensus backs the seed, so acceptance is the STRICT
        # overlap gate — on rejection the ladder falls through to RANSAC.
        if T_hint is not None and se3.is_valid_transform(
                np.asarray(T_hint, np.float64)):
            init = jnp.asarray(np.linalg.inv(np.asarray(T_hint, np.float64)),
                               jnp.float32)
            r0 = icp_projective(mpts, mmask, maps, self.intr, init=init,
                                max_iters=25,
                                dist_thr=3 * reg.icp_distance_threshold)
            r1 = icp_projective(mpts, mmask, maps, self.intr, init=r0.T,
                                max_iters=15,
                                dist_thr=reg.icp_distance_threshold)
            T_mc = np.asarray(r1.T, np.float64)
            if (int(r1.inliers) >= self.min_inliers
                    and se3.is_valid_transform(T_mc)):
                # STRICT overlap gate, in the model->frame direction:
                # matched / VISIBLE model points against the dense frame
                # maps. The frame->model cloud direction saturates at the
                # budgeted model's sampling density (0.56 measured at a
                # 0.6 mm-true recovery), while normalizing by all model
                # points collapses on grown maps — visible-normalized
                # projective overlap has neither failure mode, and a
                # wrong-basin slide still scores low because the frame's
                # misaligned relief/props stay uncovered
                # (icp.projective_overlap docstring).
                n_m, n_vis, _ = projective_overlap(
                    mpts, mmask, maps, self.intr,
                    jnp.asarray(T_mc, jnp.float32),
                    dist_thr=reg.icp_distance_threshold)
                n_vis = int(n_vis)
                if (n_vis >= self.min_inliers
                        and int(n_m) / n_vis >= self.hint_gate_fitness):
                    self.n_success += 1
                    self.n_hint_success += 1
                    self.last_reject = ""
                    return np.linalg.inv(T_mc)

        # global ladder — descriptors computed (model: memoized) only here
        if m_feats[vox][2] is None:
            m_feats[vox][2] = self._enrich(m_ds, m_dm, cam_pos, vox)
        m_f = m_feats[vox][2]
        s_f = self._enrich(s_ds, s_dm, np.zeros(3), vox)

        # coarse: multi-restart RANSAC over mutual FPFH matches; the winning
        # hypothesis maps frame(camera) coords -> world == a T_world_cam
        # candidate. Candidates are ranked/gated by evaluate_registration
        # overlap of the aligned FRAME cloud against the model — the
        # reference's fitness semantics; a relocalization frame should lie
        # almost entirely ON the model, so the gate is meaningful here in a
        # way the RANSAC inlier share is not (see module docstring).
        import dataclasses

        reg_full = dataclasses.replace(
            reg, ransac_hypotheses=max(8192, reg.ransac_hypotheses))
        best, best_fit = None, -1.0
        for _ in range(self.restarts):
            self._key, sub = jax.random.split(self._key)
            g = global_registration(s_ds, s_f, s_dm, m_ds, m_f, m_dm, sub,
                                    reg_full,
                                    distance_threshold=max(0.04, 2.5 * vox))
            T = np.asarray(g.T, np.float64)
            if not (se3.is_valid_transform(T) and np.isfinite(T).all()):
                continue
            fit, _ = evaluate_registration(s_ds, s_dm, m_ds, m_dm, g.T,
                                           dist_thr=eval_thr)
            if float(fit) > best_fit:
                best, best_fit = T, float(fit)
        if best is None or best_fit < reg.min_fitness_global:
            self.last_reject = f"global overlap {best_fit:.3f}"
            return None
        T_g = best

        # refine: FULL model sample set onto the frame's organized maps,
        # seeded by the coarse pose (init maps world -> camera)
        res = icp_projective(mpts, mmask, maps, self.intr,
                             init=jnp.asarray(np.linalg.inv(T_g), jnp.float32),
                             max_iters=15,
                             dist_thr=reg.icp_distance_threshold)
        T_mc = np.asarray(res.T, np.float64)  # world -> camera
        if int(res.inliers) < self.min_inliers:
            self.last_reject = f"icp inliers {int(res.inliers)}"
            return None
        if not se3.is_valid_transform(T_mc):
            self.last_reject = "icp transform invalid"
            return None
        self.n_success += 1
        self.last_reject = ""
        return np.linalg.inv(T_mc)
