"""Stage-by-stage device timing of marching-cubes extraction (dev tool).

Duplicates extract_mesh_arrays' stage structure with a `stop` knob so the
delta between successive stops isolates each stage's cost. Keep in sync with
tsdf/marching_cubes.py when profiling regressions.

Timing is slope-based (K dispatches, one value-pull) so the fixed cost of a
host sync does not pollute the per-stage numbers.

    python tools/profile_extract.py
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.config import TSDFConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera, orbit_trajectory
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu.tsdf import mc_tables as mt
from azurekinect3dreconstruction_tpu.tsdf import volume as tsdf

_TRI_TABLE = np.asarray(mt.TRI_TABLE)
_TRI_COUNT = np.asarray(mt.TRI_COUNT)
_EDGE_A = np.asarray(mt.EDGE_ENDPOINTS[:, 0])
_EDGE_B = np.asarray(mt.EDGE_ENDPOINTS[:, 1])
_CORNERS = np.asarray(mt.CORNER_OFFSETS)


@partial(jax.jit, static_argnames=("cfg", "max_cells", "max_tris", "E", "stop"))
def staged(vol, cfg, max_cells, max_tris, E, stop):
    R = cfg.block_resolution
    C3 = R * R * R
    bs = 4
    B3 = 64
    nb3 = C3 // B3
    max_bricks = max(max_cells // B3, 1)
    Mc = max_bricks * B3

    t2 = vol.tsdf[:E].reshape(E, C3)
    w2 = vol.weight[:E].reshape(E, C3)
    coords = vol.block_coords[:E]
    alive = jax.lax.broadcasted_iota(jnp.int32, (E, 1), 0)[:, 0] < vol.n_blocks
    nbr = mc._neighbor_slots(vol.table, coords)
    nbr = jnp.where(nbr < E, nbr, -1)

    inside0 = (t2 < 0.0) & (w2 > 0.0) & alive[:, None]
    valid0 = (w2 > 0.0) & alive[:, None]
    cE = vol.color[:E]
    pcol0 = (jnp.round(cE[:, 0] * 255.0) * 65536.0
             + jnp.round(cE[:, 1] * 255.0) * 256.0
             + jnp.round(cE[:, 2] * 255.0)).reshape(E, C3)

    def nbr_field(base, code, fill):
        s = nbr[:, code]
        ok = (s >= 0) & alive
        return jnp.where(ok[:, None], base[jnp.where(ok, s, 0)], fill)

    ins_f = {0: inside0}
    val_f = {0: valid0}
    tv_f = {0: t2}
    pc_f = {0: pcol0}
    for c in range(1, 8):
        ins_f[c] = nbr_field(inside0, c, False)
        val_f[c] = nbr_field(valid0, c, False)
        tv_f[c] = nbr_field(t2, c, jnp.float32(0.0))
        pc_f[c] = nbr_field(pcol0, c, jnp.float32(0.0))
    ins_v = mc._corner_views(ins_f, R)
    val_v = mc._corner_views(val_f, R)
    tv_v = mc._corner_views(tv_f, R)
    pc_v = mc._corner_views(pc_f, R)

    case = jnp.zeros((E, C3), jnp.int32)
    all_valid = jnp.ones((E, C3), jnp.bool_)
    for k in range(8):
        key = tuple(mt.CORNER_OFFSETS[k])
        case = case | (ins_v[key].astype(jnp.int32) << k)
        all_valid = all_valid & val_v[key]
    casem = jnp.where(all_valid & (case != 255), case, 0)
    if stop == "A":
        return casem.sum()

    case_b = casem.reshape(E * nb3, B3)
    brick_active = jnp.any(case_b != 0, axis=1)
    border = jnp.cumsum(brick_active.astype(jnp.int32)) - 1
    n_bricks = border[-1] + 1
    bdst = jnp.where(brick_active & (border < max_bricks), border, max_bricks)
    wl = jnp.full((max_bricks,), -1, jnp.int32)
    bids = jax.lax.broadcasted_iota(jnp.int32, (E * nb3, 1), 0)[:, 0]
    wl = wl.at[bdst].set(bids, mode="drop")
    if stop == "B":
        return wl.sum()

    live_b = wl >= 0
    wlc = jnp.where(live_b, wl, 0)
    caseg = jnp.where(live_b[:, None], case_b[wlc], 0).reshape(Mc)
    cv = [tv_v[tuple(mt.CORNER_OFFSETS[k])].reshape(E * nb3, B3)[wlc]
          .reshape(Mc) for k in range(8)]
    pc = [pc_v[tuple(mt.CORNER_OFFSETS[k])].reshape(E * nb3, B3)[wlc]
          .reshape(Mc) for k in range(8)]
    if stop == "C_gather":
        return caseg.sum() + sum(a.sum() for a in cv) + sum(a.sum() for a in pc)

    blk = wlc // nb3
    cg = coords[blk]
    rem = ((wlc % nb3) * B3)[:, None] + jnp.asarray(
        np.arange(B3, dtype=np.int32))[None, :]
    cellx = (cg[:, 0] * R)[:, None] + rem // (R * R)
    celly = (cg[:, 1] * R)[:, None] + (rem // R) % R
    cellz = (cg[:, 2] * R)[:, None] + rem % R
    cellx, celly, cellz = (a.reshape(Mc) for a in (cellx, celly, cellz))

    onehot = (caseg[None, :] ==
              jax.lax.broadcasted_iota(jnp.int32, (256, 1), 0)).astype(jnp.bfloat16)
    tab16 = np.concatenate([(_TRI_TABLE.T + 1), _TRI_COUNT[None]], 0).astype(np.float32)
    tout = jnp.dot(jnp.asarray(tab16, jnp.bfloat16), onehot,
                   preferred_element_type=jnp.float32).astype(jnp.int32)
    ntri = tout[15]
    pe0 = jnp.zeros((Mc,), jnp.int32)
    pe1 = jnp.zeros((Mc,), jnp.int32)
    for s in range(8):
        pe0 = pe0 | (tout[s] << (4 * s))
    for s in range(8, 15):
        pe1 = pe1 | (tout[s] << (4 * (s - 8)))
    if stop == "C_table":
        return ntri.sum() + pe0.sum() + pe1.sum()

    offs_inc = jnp.cumsum(ntri)
    offs = offs_inc - ntri
    total_tris = offs_inc[-1]
    has = ntri > 0
    dstc = jnp.where(has & (offs < max_tris), offs, max_tris)
    cstart = jnp.zeros((max_tris,), jnp.int32)
    cidx = jax.lax.broadcasted_iota(jnp.int32, (Mc, 1), 0)[:, 0]
    cstart = cstart.at[dstc].set(cidx, mode="drop")
    c_t = jax.lax.cummax(cstart)
    if stop == "D_map":
        return c_t.sum() + total_tris

    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
    payload = jnp.stack(
        cv + pc + [
            bc((cellx + 8192) | ((celly + 8192) << 14)),
            bc(cellz + 8192), bc(pe0), bc(pe1), bc(offs),
        ], axis=1)
    payload = jnp.pad(payload, ((0, 0), (0, 43)))
    if stop == "D_pad":
        return payload.sum()
    return None


def main():
    cfg = TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=16,
                     block_capacity=16384, hash_capacity=65536)
    intr = Intrinsics.azure_kinect_depth_nfov()
    cam = SyntheticCamera(intrinsics=intr)
    rays = pixel_rays(intr)
    poses = orbit_trajectory(8, radius=0.35, angle_span=1.0)
    vol = tsdf.create(cfg)
    for T in poses:
        z, c = cam.render(np.asarray(T, np.float32))
        vol = tsdf.integrate_frame(vol, z, c, rays, jnp.asarray(T, jnp.float32),
                                   intr, cfg, worklist_size=2048)
    float(vol.weight.sum())
    print("blocks:", int(vol.n_blocks))

    MCELLS, MTRIS, E = 4194304, 1048576, 2048

    def slope(fn, K=10):
        fn()
        def run(k):
            t0 = time.perf_counter()
            o = None
            for _ in range(k):
                o = fn()
            float(o.ravel()[0] if hasattr(o, "ravel") else o)
            return time.perf_counter() - t0
        run(1)
        t1 = min(run(1) for _ in range(3))
        tk = min(run(K + 1) for _ in range(2))
        return (tk - t1) / K * 1000

    prev = 0.0
    for stop in ["A", "B", "C_gather", "C_table", "D_map", "D_pad"]:
        ms = slope(lambda: staged(vol, cfg, MCELLS, MTRIS, E, stop))
        print(f"{stop:12s} cum {ms:8.2f} ms   delta {ms - prev:8.2f} ms")
        prev = ms

    pay, ct, tt, ov, ts_ = mc._extract_stage1(vol, cfg, MCELLS, MTRIS, E)
    jax.block_until_ready((pay, ct))
    ms = slope(lambda: mc._extract_gather(pay, ct))
    print(f"{'gather':12s} own-jit {ms:8.2f} ms")
    pt = mc._extract_gather(pay, ct)
    jax.block_until_ready(pt)
    ms = slope(lambda: mc._extract_stage2(pt, tt, ov, cfg=cfg, max_tris=MTRIS)[0])
    print(f"{'stage2':12s} own-jit {ms:8.2f} ms")

    def full():
        v, c, n, o = mc.extract_mesh_arrays(vol, cfg, max_cells=MCELLS,
                                            max_tris=MTRIS, extract_blocks=E)
        return v
    ms = slope(full)
    print(f"{'full':12s} end-to-end {ms:8.2f} ms")


if __name__ == "__main__":
    main()
