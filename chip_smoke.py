#!/usr/bin/env python
"""On-card smoke test of the RGB-D SLAM path, in one process.

    python chip_smoke.py           # phases 1-4 on one GPU
    python chip_smoke.py --multi   # phase 5 only: sharded fusion on 4 GPUs

Phases (one GPU):
  1. main path: the live_mono pipeline (scripts/live_mono.build_pipeline) at
     640x576, 5 mm voxels and a 16384-block pool tracks and fuses a
     synthetic orbit with ground truth; every pair must track, ATE < 10 mm,
     no pool overflow, a non-empty mesh;
  2. the worklist integrate against the whole-pool reference
     ``tsdf.integrate`` on the first frames, under highest matmul precision;
  3. dense odometry on the GPU against the same call on the CPU;
  4. a handful of blocks evicted to and reloaded from the device's pinned
     host memory, bit-exact.
With ``--multi``: DualCameraFusion(sharded=True) on a cam=2 x blk=2 mesh, as
``scripts/dual_fusion.py --sharded`` builds it, against the same frames
fused unsharded on one GPU.

Exits non-zero and prints no result line when JAX finds no GPU or any phase
fails. The line before the last names the card and its power limit; the
last line is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]

# the deployment phase 1 runs: bench.py's pool at the sensor's NFOV mode
VOXEL = 0.005
POOL = dict(block_capacity=16384, hash_capacity=65536)
N_FRAMES = 32
WORKLIST = 2048


def require_gpu() -> None:
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (backend "
                         f"{jax.default_backend()!r})")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip()


def smoke_tsdf_config(voxel=VOXEL, **pool):
    from azurekinect3dreconstruction_tpu.config import TSDFConfig

    return TSDFConfig(voxel_size=voxel, sdf_trunc=4 * voxel,
                      block_resolution=16, **(pool or POOL))


def orbit_frames(intr, n):
    """Raw (u16 mm, u8 RGB) frames of a synthetic orbit and their ground
    truth in the pipeline's frame (world = camera 0)."""
    from azurekinect3dreconstruction_tpu.io.synthetic import (
        SyntheticCamera,
        orbit_trajectory,
    )

    cam = SyntheticCamera(intrinsics=intr)
    poses = orbit_trajectory(n, radius=0.35, angle_span=1.0)
    P0i = np.linalg.inv(poses[0])
    return [cam.capture(T) for T in poses], [P0i @ T for T in poses]


def _decoded(frames):
    from azurekinect3dreconstruction_tpu.config import CameraConfig
    from azurekinect3dreconstruction_tpu.core.types import RGBDFrame

    cam = CameraConfig()
    return [RGBDFrame.from_raw(d, c, cam.depth_scale, cam.depth_trunc,
                               cam.depth_min) for d, c in frames]


def phase_main_path(intr, tsdf_cfg, frames, gt):
    import jax

    from azurekinect3dreconstruction_tpu.io.streams import prefetch_to_device
    from azurekinect3dreconstruction_tpu.utils.evaluation import ate
    from live_mono import build_pipeline

    pipe = build_pipeline(intr, tsdf_cfg)
    pipe.telemetry.sink = lambda s: None
    t0 = time.perf_counter()
    for d, c in frames[:2]:  # first frame + first tracked step compile
        pipe.process_frame(d, c)
    jax.block_until_ready((pipe.volume.tsdf, pipe._T_dev))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for d, c in prefetch_to_device(iter(frames[2:])):
        pipe.process_frame(d, c)
    jax.block_until_ready((pipe.volume.tsdf, pipe._T_dev))
    steady_fps = (len(frames) - 2) / (time.perf_counter() - t0)

    n_tracked = len(pipe._fits_dev)
    odo_ok = n_tracked - pipe.odometry_failures
    ate_mm = ate(pipe.trajectory[1:], gt)["rmse"] * 1000.0
    overflow = bool(pipe.volume.overflow)
    n_blocks = int(pipe.volume.n_blocks)
    n_tris = int(pipe.extract_mesh().num_triangles)
    ok = (n_tracked == len(frames) - 1 and odo_ok == n_tracked
          and ate_mm < 10.0 and not overflow and n_tris > 0)
    return ok, dict(frames=len(frames), odo_ok=odo_ok, ate_rmse_mm=ate_mm,
                    overflow=overflow, n_blocks=n_blocks, triangles=n_tris,
                    compile_s=compile_s, steady_fps=steady_fps)


def compare_by_key(a, b):
    """Voxel agreement of volume ``a`` with reference ``b``, block by block.

    Blocks are matched by key, not by pool row: the hash insert's scatter
    claims race on the GPU, so two allocations of the same frames may place
    a block in different rows. Returns (every live block of b found in a,
    updated voxels, fraction of them with bit-equal weights, max |dtsdf|
    and max |dcolour| where the weights are equal)."""
    import jax
    import jax.numpy as jnp

    from azurekinect3dreconstruction_tpu.tsdf import hash as vhash

    @jax.jit
    def stats(a, b):
        slot = vhash.lookup(a.table, vhash.pack_key(b.block_coords))
        alive = jnp.arange(b.tsdf.shape[0]) < b.n_blocks
        found = (slot >= 0) | ~alive
        s = jnp.maximum(slot, 0)
        live = alive[:, None, None]
        wa = jnp.where(live, a.weight[s], 0.0)
        wb = jnp.where(live, b.weight, 0.0)
        updated = (wa > 0) | (wb > 0)
        keep = updated & (wa == wb)
        d_t = jnp.max(jnp.where(keep, jnp.abs(a.tsdf[s] - b.tsdf), 0.0))
        d_c = jnp.max(jnp.where(keep[:, None], jnp.abs(a.color[s] - b.color),
                                0.0))
        return jnp.all(found), jnp.sum(updated), jnp.sum(keep), d_t, d_c

    found, n_upd, n_same, d_t, d_c = stats(a, b)
    n_upd = int(n_upd)
    return (bool(found), n_upd, int(n_same) / max(n_upd, 1), float(d_t),
            float(d_c))


def phase_integrate_parity(intr, tsdf_cfg, frames, gt, n=8,
                           worklist_size=WORKLIST):
    """Weights bit-equal on >= 99.99% of updated voxels; tsdf and colour
    within 1e-5 where they are. Not exact by construction: the two forms
    are separate fusions, and the GPU may contract the projection's
    multiply-adds differently in each, moving a rounded pixel index."""
    import jax
    import jax.numpy as jnp

    from azurekinect3dreconstruction_tpu.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf

    rays = pixel_rays(intr)
    vol_w = tsdf.create(tsdf_cfg)
    vol_r = tsdf.create(tsdf_cfg)
    with jax.default_matmul_precision("highest"):
        for f, T in zip(_decoded(frames[:n]), gt[:n]):
            T = jnp.asarray(T, jnp.float32)
            vol_w = tsdf.integrate_frame(vol_w, f.depth, f.color, rays, T,
                                         intr, tsdf_cfg,
                                         worklist_size=worklist_size)
            vol_r = tsdf.allocate(vol_r, f.depth, rays, T, tsdf_cfg)
            vol_r = tsdf.integrate(vol_r, f.depth, f.color, T, intr, tsdf_cfg)

    all_found, n_upd, frac, d_t, d_c = compare_by_key(vol_w, vol_r)
    same_blocks = int(vol_w.n_blocks) == int(vol_r.n_blocks) and all_found
    overflow = bool(vol_w.overflow)
    ok = (same_blocks and not overflow and n_upd > 0 and frac >= 0.9999
          and d_t <= 1e-5 and d_c <= 1e-5)
    return ok, dict(frames=n, updated_voxels=n_upd,
                    weight_equal_frac=frac, max_abs_dtsdf=d_t,
                    max_abs_dcolor=d_c, same_blocks=same_blocks,
                    overflow=overflow)


def _rotation_deg(R) -> float:
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.degrees(np.arctan2(np.linalg.norm(vee) / 2.0,
                                       (np.trace(R) - 1.0) / 2.0)))


def phase_odometry(intr, ocfg, frames, reps=10):
    """One frame pair on the default device against jax.devices('cpu'):
    within 0.1 mm and 0.01 degrees."""
    import jax

    from azurekinect3dreconstruction_tpu.tracking.odometry import (
        compute_odometry,
    )

    f0, f1 = _decoded(frames[:2])
    args = (f0.intensity, f0.depth, f1.intensity, f1.depth)
    res = compute_odometry(*args, intr, ocfg)
    T_dev = np.asarray(res.T_target_source, np.float64)
    t0 = time.perf_counter()
    for _ in range(reps):
        res = compute_odometry(*args, intr, ocfg)
    jax.block_until_ready(res)
    ms = (time.perf_counter() - t0) / reps * 1000.0
    cpu_args = jax.device_put(args, jax.devices("cpu")[0])
    T_cpu = np.asarray(compute_odometry(*cpu_args, intr, ocfg).T_target_source,
                       np.float64)
    dT = np.linalg.inv(T_cpu) @ T_dev
    trans_mm = float(np.linalg.norm(dT[:3, 3]) * 1000.0)
    rot_deg = _rotation_deg(dT[:3, :3])
    ok = trans_mm <= 0.1 and rot_deg <= 0.01 and np.isfinite(T_dev).all()
    return ok, dict(pyramid_iters=list(ocfg.pyramid_iters),
                    odometry_ms_per_frame=ms, fitness=float(res.fitness),
                    d_trans_mm=trans_mm, d_rot_deg=rot_deg)


def phase_streaming(intr, tsdf_cfg, frames, gt, n=8, n_evict=64):
    """Evict the newest ``n_evict`` blocks to pinned host memory, compact
    them out of the pool, reload them, and require every block's voxels to
    come back bit-exact (looked up by key: slots move)."""
    import jax
    import jax.numpy as jnp

    from azurekinect3dreconstruction_tpu.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu.tsdf import hash as vhash
    from azurekinect3dreconstruction_tpu.tsdf import streaming as st
    from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf

    rays = pixel_rays(intr)
    vol = tsdf.create(tsdf_cfg)
    for f, T in zip(_decoded(frames[:n]), gt[:n]):
        vol = tsdf.integrate_frame(vol, f.depth, f.color, rays,
                                   jnp.asarray(T, jnp.float32), intr, tsdf_cfg,
                                   worklist_size=WORKLIST)
    nb = int(vol.n_blocks)
    k = min(n_evict, nb)
    victims = np.arange(nb - k, nb, dtype=np.int32)
    coords = np.asarray(vol.block_coords)[victims]
    host = st._put_mem("pinned_host", *st._gather_rows(vol, victims))
    kinds = sorted({a.sharding.memory_kind for a in host})
    perm = np.zeros(tsdf_cfg.block_capacity, np.int32)
    perm[: nb - k] = np.arange(nb - k)
    evicted = st._compact(vol, perm, np.int32(nb - k))
    back = st._put_mem("device", *host)
    keys = np.asarray(vhash.pack_key(jnp.asarray(coords)))
    reloaded, vals = st._scatter_reload(evicted, keys, coords, *back,
                                        np.arange(k, dtype=np.int32),
                                        cfg=tsdf_cfg)

    @jax.jit
    def by_key(v, block_coords):
        slot = vhash.lookup(v.table, vhash.pack_key(block_coords))
        s = jnp.maximum(slot, 0)
        return slot, v.tsdf[s], v.weight[s], v.color[s]

    live = vol.block_coords[:nb]
    slot_a, *want = by_key(vol, live)
    slot_b, *got = by_key(reloaded, live)
    bits = lambda x: np.asarray(x).view(np.uint32)
    exact = all(np.array_equal(bits(a), bits(b)) for a, b in zip(want, got))
    all_found = bool((np.asarray(slot_b) >= 0).all())
    ok = (kinds == ["pinned_host"] and exact and all_found
          and int(reloaded.n_blocks) == nb and bool((np.asarray(vals) >= 0).all()))
    return ok, dict(blocks=nb, evicted=k, host_memory_kinds=kinds,
                    bit_exact=exact, all_found=all_found)


def phase_multi(intr, n_pairs=4, voxel=0.01):
    """Sharded (cam=2 x blk=2) dual-camera fusion against the same synthetic
    rig frames fused unsharded on one GPU with the sharded step's semantics
    (each pair: allocate both cameras, then integrate them in camera order
    with the worklist form). Passes on an equal block count, summed weights
    within rtol 1e-5 and, after combine_shards, a triangle-centroid overlap
    on a 0.1 mm grid above 0.999. Voxels matched by key must agree as in
    phase 2 (both sides run the same arithmetic, compiled separately)."""
    import jax
    import jax.numpy as jnp

    from azurekinect3dreconstruction_tpu.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera
    from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as mc
    from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf
    from dual_fusion import build_pipeline, synthetic_rig

    cam = SyntheticCamera(intrinsics=intr)
    rig = synthetic_rig()
    pair = tuple(cam.capture(T) for T in rig)
    pipe = build_pipeline(intr, voxel, tempfile.mkdtemp(prefix="chip_smoke_"),
                          sharded=True)
    pipe.telemetry.sink = lambda s: None
    # a fixed extrinsic, so both sides fuse identical data (calibration is
    # randomized and not what this phase compares)
    pipe.extrinsics[1] = rig[1]
    pipe.calibrated = True
    t0 = time.perf_counter()
    pipe.process_frames(pair)  # compiles the sharded step
    jax.block_until_ready(pipe.volume.tsdf)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_pairs - 1):
        pipe.process_frames(pair)
    jax.block_until_ready(pipe.volume.tsdf)
    pair_ms = (time.perf_counter() - t0) / max(n_pairs - 1, 1) * 1000.0

    cfg = pipe.cfg.tsdf
    rays = pixel_rays(intr)
    poses = [jnp.asarray(T, jnp.float32) for T in rig]
    ref = tsdf.create(cfg)
    for _ in range(n_pairs):
        frames = _decoded(pair)
        for f, T in zip(frames, poses):
            ref = tsdf.allocate(ref, f.depth, rays, T, cfg, stride=2)
        for f, T in zip(frames, poses):
            ref = tsdf.integrate_worklist(ref, f.depth, f.color, T, intr, cfg,
                                          worklist_size=WORKLIST)

    def weight_sum(vol):
        rows = jax.jit(lambda w: jnp.sum(w.reshape(w.shape[0], -1), axis=1))
        return float(np.asarray(rows(vol.weight), np.float64).sum())

    def centroids(vol):
        m = mc.extract_mesh(vol, cfg)
        v = np.asarray(m.vertices)[: 3 * int(m.num_triangles)]
        return {tuple(x) for x in
                np.round(v.reshape(-1, 3, 3).mean(1), 4).tolist()}

    blocks = [int(ref.n_blocks), int(np.asarray(pipe.volume.n_blocks).sum())]
    wsum = [weight_sum(ref), weight_sum(pipe.volume)]
    combined = pipe.extraction_volume()
    found, _, w_equal, d_t, d_c = compare_by_key(combined, ref)
    c_ref, c_sharded = centroids(ref), centroids(combined)
    overlap = len(c_ref & c_sharded) / max(len(c_ref), 1)
    rel = abs(wsum[0] - wsum[1]) / max(abs(wsum[0]), 1e-12)
    overflow = bool(ref.overflow) or bool(np.asarray(pipe.volume.overflow).any())
    ok = (pipe.sharded and blocks[0] == blocks[1] and blocks[0] > 0 and found
          and rel <= 1e-5 and overlap > 0.999 and w_equal >= 0.9999
          and d_t <= 1e-5 and d_c <= 1e-5 and not overflow)
    return ok, dict(mesh=dict(pipe.mesh.shape), pairs=n_pairs,
                    blocks_single_sharded=blocks, weight_sums=wsum,
                    weight_rel_diff=rel, weight_equal_frac=w_equal,
                    max_abs_dtsdf=d_t, max_abs_dcolor=d_c,
                    triangles=[len(c_ref), len(c_sharded)],
                    centroid_overlap_on_0p1mm_grid=overlap,
                    overflow=overflow, compile_s=compile_s,
                    sharded_pair_ms=pair_ms)


def run_phase(name, fn, *args, **kw) -> bool:
    t0 = time.perf_counter()
    try:
        ok, info = fn(*args, **kw)
    except Exception:  # noqa: BLE001 — report it, fail the run at the end
        traceback.print_exc()
        ok, info = False, {"error": "exception (traceback on stderr)"}
    info["seconds"] = time.perf_counter() - t0
    print(f"phase {name}: {'PASS' if ok else 'FAIL'} "
          f"{json.dumps(info, default=float)}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU sharded-fusion phase")
    args = ap.parse_args(argv)

    require_gpu()
    card = card_line()
    import jax

    from azurekinect3dreconstruction_tpu.config import OdometryConfig
    from azurekinect3dreconstruction_tpu.core.camera import Intrinsics

    print(f"jax {jax.__version__} devices: {jax.devices()}", flush=True)
    intr = Intrinsics.azure_kinect_depth_nfov()  # 640x576 NFOV unbinned
    if args.multi:
        if len(jax.devices()) < 4:
            raise SystemExit(f"--multi needs 4 GPUs, JAX found "
                             f"{len(jax.devices())}")
        results = [run_phase("5 sharded dual fusion (4 GPUs)", phase_multi,
                             intr)]
    else:
        tsdf_cfg = smoke_tsdf_config()
        t0 = time.perf_counter()
        frames, gt = orbit_frames(intr, N_FRAMES)
        print(f"setup: rendered {len(frames)} frames "
              f"{intr.width}x{intr.height} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        results = [
            run_phase("1 main path", phase_main_path, intr, tsdf_cfg,
                      frames, gt),
            run_phase("2 integrate parity", phase_integrate_parity, intr,
                      tsdf_cfg, frames, gt),
            run_phase("3 odometry gpu vs cpu", phase_odometry, intr,
                      OdometryConfig(), frames),
            run_phase("4 streaming round trip", phase_streaming, intr,
                      tsdf_cfg, frames, gt),
        ]
    print(f"card: {card}", flush=True)
    if not all(results):
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
