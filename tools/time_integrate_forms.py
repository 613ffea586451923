"""Time the two plain integrate forms inside the fused SLAM step, on a GPU.

    python tools/time_integrate_forms.py [--out times.json]

At chip_smoke.py's deployment (640x576 NFOV, 5 mm voxels, 16^3 blocks, a
16384-block pool, 65536-slot hash) over a 17-frame synthetic orbit:

- the scan-batched SLAM step (odometry + gate + allocate + integrate) with
  (a) the whole-pool ``tsdf.integrate`` and (b) the frustum worklist
  ``tsdf.integrate_worklist`` (M = 2048), alternated a, b, b, a three times;
- allocate + integrate alone on a warm pool, per frame, for both forms;
- ``compute_odometry`` alone, per frame;
- the visible-block count of every frame (what M must hold).

Prints one JSON object (and writes it to ``--out`` when given). Times are
host clock around work that ends in ``block_until_ready``, compilation
excluded; name the card and its power limit (printed first) beside them.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

N_FRAMES = 17
WORKLIST = 2048


def make_batch(form, intr, pcfg, rays):
    import jax

    from azurekinect3dreconstruction_tpu.pipelines import mono_odometry_tsdf as mo
    from azurekinect3dreconstruction_tpu.tracking.odometry import compute_odometry
    from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf

    cfg, ocfg = pcfg.tsdf, pcfg.odometry

    def fuse(vol, d, c, T):
        if form == "worklist":
            return tsdf.integrate_frame(vol, d, c, rays, T, intr, cfg,
                                        stride=2, worklist_size=WORKLIST)
        vol = tsdf.allocate(vol, d, rays, T, cfg, stride=2)
        return tsdf.integrate(vol, d, c, T, intr, cfg)

    def batch(vol, T0, ints, deps, cols):
        def body(carry, fr):
            vol, T_prev, prev_i, prev_d = carry
            i, d, c = fr
            res = compute_odometry(prev_i, prev_d, i, d, intr, ocfg)
            T, fit = mo.apply_odometry_gate(T_prev, res, 0.3)
            return (fuse(vol, d, c, T), T, i, d), (T, fit)

        (vol, _, _, _), out = jax.lax.scan(
            body, (vol, T0, ints[0], deps[0]), (ints[1:], deps[1:], cols[1:]))
        return vol, out

    return jax.jit(batch, donate_argnums=(0,)), jax.jit(fuse,
                                                        donate_argnums=(0,))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)

    chip_smoke.require_gpu()
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)

    import jax
    import jax.numpy as jnp

    from azurekinect3dreconstruction_tpu.config import PipelineConfig
    from azurekinect3dreconstruction_tpu.core.camera import Intrinsics, pixel_rays
    from azurekinect3dreconstruction_tpu.tracking.odometry import compute_odometry
    from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf

    intr = Intrinsics.azure_kinect_depth_nfov()
    cfg = chip_smoke.smoke_tsdf_config()
    pcfg = PipelineConfig(tsdf=cfg)
    rays = pixel_rays(intr)
    frames, gt = chip_smoke.orbit_frames(intr, N_FRAMES)
    dec = chip_smoke._decoded(frames)
    D = jnp.stack([f.depth for f in dec])
    C = jnp.stack([f.color for f in dec])
    I = jnp.stack([f.intensity for f in dec])
    G = [jnp.asarray(T, jnp.float32) for T in gt]

    def seed():
        return tsdf.integrate_frame(tsdf.create(cfg), D[0], C[0], rays, G[0],
                                    intr, cfg, worklist_size=WORKLIST)

    forms = ("whole_pool", "worklist")
    fns = {f: make_batch(f, intr, pcfg, rays) for f in forms}
    res = {"card": card, "device_kind": jax.devices()[0].device_kind}
    for f in forms:
        t0 = time.perf_counter()
        v, _ = fns[f][0](seed(), G[0], I, D, C)
        jax.block_until_ready(v)
        res[f"{f}_compile_s"] = time.perf_counter() - t0
        res[f"{f}_overflow"] = bool(v.overflow)
        res[f"{f}_n_blocks"] = int(v.n_blocks)
        res[f"{f}_weight_sum"] = float(jnp.sum(v.weight))
        del v

    times = {f: [] for f in forms}
    for f in ["whole_pool", "worklist", "worklist", "whole_pool"] * 3:
        v = seed()
        jax.block_until_ready(v)
        t0 = time.perf_counter()
        v, out = fns[f][0](v, G[0], I, D, C)
        jax.block_until_ready((v, out))
        times[f].append((time.perf_counter() - t0) / (N_FRAMES - 1) * 1000.0)
        del v
    for f, t in times.items():
        res[f"slam_step_ms_{f}"] = t
        res[f"slam_step_ms_{f}_median"] = float(np.median(t))

    vol, _ = fns["worklist"][0](seed(), G[0], I, D, C)
    res["visible_blocks"] = [
        int(tsdf.build_worklist(vol.block_coords, vol.n_blocks, G[k], intr,
                                cfg)[1]) for k in range(N_FRAMES)]
    for f in forms:  # allocate + integrate on the warm pool
        fuse = fns[f][1]
        vol = fuse(vol, D[1], C[1], G[1])
        jax.block_until_ready(vol)
        t0 = time.perf_counter()
        for k in range(1, N_FRAMES):
            vol = fuse(vol, D[k], C[k], G[k])
        jax.block_until_ready(vol)
        res[f"fuse_ms_{f}"] = ((time.perf_counter() - t0) / (N_FRAMES - 1)
                               * 1000.0)
    del vol

    odo = (I[0], D[0], I[1], D[1])
    jax.block_until_ready(compute_odometry(*odo, intr, pcfg.odometry))
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(compute_odometry(*odo, intr, pcfg.odometry))
        ts.append((time.perf_counter() - t0) * 1000.0)
    res["odometry_ms"] = ts
    res["odometry_ms_median"] = float(np.median(ts))
    res["peak_bytes_in_use"] = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use")

    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
