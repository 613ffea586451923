"""Marching cubes over the block-hashed TSDF volume (pure XLA, static shapes).

Replaces ``ScalableTSDFVolume.extract_triangle_mesh`` (the dominant per-frame
cost of the reference's live loops — reference
CodeThatWorks/1camera-detectsSceneChanges.py:277-291 re-extracts EVERY frame).

XLA cannot produce dynamic-size meshes, so extraction is staged with fixed
budgets (SURVEY.md §7.3 "marching cubes dynamic output"). The staging is
built around cost asymmetries measured on the accelerator this was first
written for: element gathers/scatters were slow per element, row gathers
were faster on 64/128-wide rows than on partial ones (21/25/32), and a
gather fused with either its producers or its consumers degraded ~2x vs one
whose operand and results are materialized (hence the deliberate jit
splits — see _extract_gather). None of these is re-measured on the GPU yet.
Every bulk data movement below is a row gather, a cumsum, or an elementwise
pass:

A. **survey (dense, elementwise)** — corner-shifted views of tsdf/validity/
   packed-color over the alive pool prefix (flat (E, R^3) layout; one-voxel
   shifts = lane rolls + a boundary-plane injection from the 7 hash-neighbor
   blocks, fetched as whole-row gathers). Produces per-cell case codes and
   8 corner value/color planes — no (R+1)^3 padding, no per-cell gathers.
B. **group compaction** — cells group into 64-cell runs CONTIGUOUS in the
   pool layout (4 z-columns of a block), so group data moves by whole-row
   gathers with zero transposes (4x4x4 bricks compact ~3x tighter but the
   17 brick transposes cost ~65 ms — measured, not worth it). One small
   scatter (E*R^3/64 inputs) builds the active-group worklist.
C. **per-cell math (group-dense, elementwise)** — triangle counts + the 15
   packed table edge ids via one bf16 one-hot matmul against the
   (16, 256) MC table (edge ids <= 13 and counts <= 5 are exact in bf16);
   corner values/colors packed into a 21-word-per-cell payload, padded to
   64 lanes for the fast row-gather path.
D. **expansion (sorted, gather-free mapping)** — per-cell tri counts prefix-
   sum to exclusive offsets; scattering each active cell's index at its
   first-triangle position (<= one update per ACTIVE CELL) and cummax-
   filling yields triangle->cell in one pass because cell indices increase
   with output position. Per-triangle data then moves as ONE (max_tris, 64)
   payload row gather (its own jit — see _extract_gather); edge fracs and
   vertex positions/colors are reconstructed elementwise per triangle
   vertex on flat (T,) arrays.

The output is a triangle soup (vertex sharing is done host-side by
``weld_vertices`` when an indexed mesh is needed, e.g. for OBJ export).
Budgets that overflow set a flag so callers can retry with a larger static
budget (new compile, cached thereafter).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.config import TSDFConfig
from azurekinect3dreconstruction_tpu.core.types import TriangleMesh, TriangleMeshHost
from azurekinect3dreconstruction_tpu.tsdf import mc_tables as mt
from azurekinect3dreconstruction_tpu.tsdf import hash as vhash
from azurekinect3dreconstruction_tpu.tsdf.volume import TSDFVolume

# numpy constants (jnp.asarray at import would pin the default backend);
# they are closed over by jitted functions and constant-folded there
_TRI_TABLE = np.asarray(mt.TRI_TABLE)  # (256, 15)
_TRI_COUNT = np.asarray(mt.TRI_COUNT)  # (256,)
_EDGE_A = np.asarray(mt.EDGE_ENDPOINTS[:, 0])  # (12,)
_EDGE_B = np.asarray(mt.EDGE_ENDPOINTS[:, 1])
_CORNERS = np.asarray(mt.CORNER_OFFSETS)  # (8, 3)

EXTRACT_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def pow2_bucket(n: int, cap: int = 0, lo: int = 64) -> int:
    """Round ``n`` up a power-of-two ladder starting at ``lo``, clamped to
    ``cap`` when given. One definition for every bucketed device-call shape
    in the extraction stack (streaming + incremental): the ladder IS the
    bounded-compile-count guarantee (each fresh shape is a fresh
    compile)."""
    b = lo
    while b < n:
        b *= 2
    return min(b, cap) if cap else b


def snap_extract_blocks(n_alive: int, pool_size: int) -> int:
    """Alive-prefix length snapped to the EXTRACT_SIZES ladder (one compile
    per rung instead of per block count), clamped to the pool."""
    E = next((e for e in EXTRACT_SIZES if e >= n_alive), pool_size)
    return min(E, pool_size)


def _neighbor_slots(table, block_coords):
    """(E, 8) pool slots of the 8 (0/1)^3 neighbor blocks (self = code 0)."""
    keys = vhash.pack_key(block_coords[:, None, :] + _CORNERS[None])  # (E, 8)
    return vhash.lookup(table, keys)


def _corner_views(fields, R: int):
    """All 8 corner-shifted views of a per-block boolean field, computed in
    the pool-native merged layout (E, R^3) — no (R+1)^3 padded cube.

    A padded cube has minor dims R+1 (=17), which a 128-wide tiled layout
    pads 17->128 (10x memory). Instead each (dx, dy, dz) corner view is a composition of
    three one-voxel axis shifts on the FLAT (E, R^3) layout: a lane roll for
    the in-block part plus a boundary-lane injection rolled out of the
    matching neighbor block's field. 12 shift ops total, all vector
    slice/concat/select — no gathers, no padding.

    ``fields``: dict code -> (E, R^3) for the 8 (0/1)^3 neighbor blocks
    (code 0 = self; missing neighbors already masked False).
    Returns dict (dx, dy, dz) -> (E, R^3).
    """
    R2, R3 = R * R, R * R * R
    idx = np.arange(R3)
    mz = (idx % R) == R - 1
    my = (idx // R) % R == R - 1
    mx = (idx // R2) == R - 1

    def shift(off, mask, a_own, a_nbr):
        # value at voxel i becomes field[i + off]; voxels whose +axis step
        # leaves the block instead read the neighbor's axis==0 plane, which
        # sits at i - (R-1)*stride in the neighbor's flat layout
        return jnp.where(mask, jnp.roll(a_nbr, (R - 1) * off, axis=1),
                         jnp.roll(a_own, -off, axis=1))

    sz = lambda a, b: shift(1, mz, a, b)
    sy = lambda a, b: shift(R, my, a, b)
    sx = lambda a, b: shift(R2, mx, a, b)

    z0 = (fields[0], fields[1], fields[2], fields[3])  # own, +x, +y, +xy
    z1 = (sz(fields[0], fields[4]), sz(fields[1], fields[5]),
          sz(fields[2], fields[6]), sz(fields[3], fields[7]))
    views = {}
    for dz, (f0, f1, f2, f3) in ((0, z0), (1, z1)):
        y_rows = ((0, f0, f1), (1, sy(f0, f2), sy(f1, f3)))
        for dy, v_own, v_x in y_rows:
            views[(0, dy, dz)] = v_own
            views[(1, dy, dz)] = sx(v_own, v_x)
    return views


def _case_mask(t2, w2, alive, nbr, R: int):
    """Stage-A case/validity math: per-cell 8-bit MC case with invalid or
    empty/full cells folded to 0 (inert). ONE definition shared by
    _extract_stage1 and count_active_bricks — the budget fit must count
    exactly the groups stage B compacts, so the emission rule cannot be
    allowed to drift between the two."""
    C3 = t2.shape[1]
    inside0 = (t2 < 0.0) & (w2 > 0.0) & alive[:, None]
    valid0 = (w2 > 0.0) & alive[:, None]

    def nbr_field(base, code):
        s = nbr[:, code]
        ok = (s >= 0) & alive
        return jnp.where(ok[:, None], base[jnp.where(ok, s, 0)], False)

    ins_f = {0: inside0}
    val_f = {0: valid0}
    for c in range(1, 8):
        ins_f[c] = nbr_field(inside0, c)
        val_f[c] = nbr_field(valid0, c)
    ins_v = _corner_views(ins_f, R)
    val_v = _corner_views(val_f, R)
    case = jnp.zeros(t2.shape, jnp.int32)
    all_valid = jnp.ones(t2.shape, jnp.bool_)
    for k in range(8):
        key = tuple(mt.CORNER_OFFSETS[k])
        case = case | (ins_v[key].astype(jnp.int32) << k)
        all_valid = all_valid & val_v[key]
    # a cell has triangles iff its corners' signs are mixed: every case
    # except 0 and 255 produces geometry — two compares, no table lookup.
    # Folding validity into the case (0 = inert) saves one worklist array.
    return jnp.where(all_valid & (case != 255), case, 0)


@partial(jax.jit, static_argnames=("cfg", "max_cells", "max_tris",
                                   "extract_blocks", "subsample_bricks"))
def _extract_stage1(vol: TSDFVolume, cfg: TSDFConfig,
                    max_cells: int, max_tris: int,
                    extract_blocks: int = None, emit_mask=None,
                    sel=None, nbr_sel=None, subsample_bricks: bool = False):
    """Stages A-D_map + payload build; returns (payload (Mc, 64), c_t,
    total_tris, n_bricks). Split from stage 2 at a jit boundary ON PURPOSE:
    the (max_tris, 64) row gather of stage 2 runs 2x faster when its operand
    is a materialized buffer than when XLA fuses the payload producers into
    the gather (measured 19 ms vs 43 ms at 1M rows) — the pipeline is ~20%
    faster split than fused, pad copy included.

    ``emit_mask`` (optional bool): only cells of masked blocks EMIT
    triangles; unmasked alive blocks still contribute corner values, so
    boundary cells of emitted blocks triangulate exactly as in a full
    extraction (the incremental-extraction contract). Shape (N,) in the
    prefix form, (Es,) in the compact form below.

    ``sel``/``nbr_sel`` (optional, COMPACT form — tsdf.incremental): instead
    of scanning the alive prefix, process only the (Es,) pool slots in
    ``sel`` (-1 = padding). ``nbr_sel`` (Es, 8) gives each selected row's
    (0/1)^3-corner neighbors as COMPACT row indices (-1 = absent), computed
    on host from its coords copy — no device hash lookups, and stage cost
    scales with the touched-block count instead of the scene size. The
    caller must select every alive positive neighbor of each emitted block
    (they supply corner values); rows only read through ``nbr_sel``, so
    non-emitted rows may have absent neighbors."""
    R = cfg.block_resolution
    N = vol.tsdf.shape[0]
    C3 = R * R * R
    if sel is not None:
        E = sel.shape[0]
        alive = sel >= 0
        slot = jnp.where(alive, sel, 0)
        t2 = vol.tsdf[slot].reshape(E, C3)
        w2 = vol.weight[slot].reshape(E, C3)
        coords = vol.block_coords[slot]
        cE = vol.color[slot]
        nbr = jnp.where(alive[:, None], nbr_sel, -1)
    else:
        E = min(extract_blocks or N, N)
        t2 = vol.tsdf[:E].reshape(E, C3)
        w2 = vol.weight[:E].reshape(E, C3)
        coords = vol.block_coords[:E]
        cE = vol.color[:E]
        alive = jax.lax.broadcasted_iota(jnp.int32, (E, 1), 0)[:, 0] < vol.n_blocks
        nbr = _neighbor_slots(vol.table, coords)
        # neighbors beyond the extract prefix are treated as absent (they can
        # only exist if E < n_blocks, which the caller prevents)
        nbr = jnp.where(nbr < E, nbr, -1)
    B3 = min(64, C3)  # cells per group (contiguous in flat z-minor layout)
    nb3 = C3 // B3  # groups per block
    max_bricks = max(max_cells // B3, 1)
    Mc = max_bricks * B3  # worklist cells (group-dense)

    # ---- stage A: dense corner fields (elementwise + whole-row gathers) ----
    # case/validity math lives in _case_mask (shared with count_active_bricks)
    casem = _case_mask(t2, w2, alive, nbr, R)
    # pack RGB into one f32 plane (exact for 24-bit ints): corner colors then
    # ride the same shift machinery as values, one array per corner not three
    pcol0 = (jnp.round(cE[:, 0] * 255.0) * 65536.0
             + jnp.round(cE[:, 1] * 255.0) * 256.0
             + jnp.round(cE[:, 2] * 255.0)).reshape(E, C3)

    def nbr_field(base, code, fill):
        s = nbr[:, code]
        ok = (s >= 0) & alive
        return jnp.where(ok[:, None], base[jnp.where(ok, s, 0)], fill)

    tv_f = {0: t2}
    pc_f = {0: pcol0}
    for c in range(1, 8):
        tv_f[c] = nbr_field(t2, c, jnp.float32(0.0))
        pc_f[c] = nbr_field(pcol0, c, jnp.float32(0.0))
    tv_v = _corner_views(tv_f, R)
    pc_v = _corner_views(pc_f, R)

    if emit_mask is not None:
        # restrict OUTPUT to masked blocks; corner data above already came
        # from every alive block, so emitted geometry is unchanged
        casem = jnp.where(emit_mask[:E, None], casem, 0)

    # ---- stage B: compact active GROUPS -------------------------------------
    case_b = casem.reshape(E * nb3, B3)  # groups are contiguous: free reshape
    brick_active = jnp.any(case_b != 0, axis=1)
    border = jnp.cumsum(brick_active.astype(jnp.int32)) - 1
    n_bricks = border[-1] + 1
    if subsample_bricks:
        # sampler semantics (extract_sampled_surface_model): when the active
        # groups exceed the budget, keep every stride-th ACTIVE group instead
        # of the first max_bricks in pool order — a budget overflow then
        # thins the sample UNIFORMLY across the scene rather than truncating
        # everything after the oldest-scanned corner (the r4 refresh overran
        # its budget 7x on the bench scene, so its "model" was the ~300
        # oldest blocks). The stride is a traced scalar: no recompiles as
        # the scene grows, and <= max_bricks groups survive by construction,
        # so brick overflow cannot occur (overflow1 stays defined by the
        # triangle budget alone).
        bstride = jnp.maximum((n_bricks + max_bricks - 1) // max_bricks, 1)
        bpick = brick_active & (border % bstride == 0)
        bpos = jnp.cumsum(bpick.astype(jnp.int32)) - 1
        bdst = jnp.where(bpick & (bpos < max_bricks), bpos, max_bricks)
    else:
        bdst = jnp.where(brick_active & (border < max_bricks), border,
                         max_bricks)
    wl = jnp.full((max_bricks,), -1, jnp.int32)
    bids = jax.lax.broadcasted_iota(jnp.int32, (E * nb3, 1), 0)[:, 0]
    wl = wl.at[bdst].set(bids, mode="drop")

    # ---- stage C: group-dense per-cell math (row gathers + elementwise) -----
    live_b = wl >= 0
    wlc = jnp.where(live_b, wl, 0)
    caseg = jnp.where(live_b[:, None], case_b[wlc], 0).reshape(Mc)
    cv = [tv_v[tuple(mt.CORNER_OFFSETS[k])].reshape(E * nb3, B3)[wlc]
          .reshape(Mc) for k in range(8)]
    pc = [pc_v[tuple(mt.CORNER_OFFSETS[k])].reshape(E * nb3, B3)[wlc]
          .reshape(Mc) for k in range(8)]

    # cell voxel coordinates (block coords are tiny element gathers, Gb-sized)
    blk = wlc // nb3
    cg = coords[blk]  # (Gb, 3)
    # flat cell index within the block of group wlc, cell j: (wlc % nb3)*B3+j
    rem = ((wlc % nb3) * B3)[:, None] + jnp.asarray(
        np.arange(B3, dtype=np.int32))[None, :]  # (Gb, B3)
    cellx = (cg[:, 0] * R)[:, None] + rem // (R * R)
    celly = (cg[:, 1] * R)[:, None] + (rem // R) % R
    cellz = (cg[:, 2] * R)[:, None] + rem % R
    cellx = cellx.reshape(Mc)
    celly = celly.reshape(Mc)
    cellz = cellz.reshape(Mc)

    # tri counts + the 15 packed table edge ids: TRI_TABLE[case] without
    # gathers — one bf16 one-hot matmul against the (16, 256) table (edge
    # ids + 1 <= 13 and counts <= 5 are exact in bf16 and each output sums
    # one nonzero product, so with the f32 accumulator the result is exact
    # on any matrix unit).
    onehot = (caseg[None, :] ==
              jax.lax.broadcasted_iota(jnp.int32, (256, 1), 0)).astype(jnp.bfloat16)
    tab16 = np.concatenate([( _TRI_TABLE.T + 1), _TRI_COUNT[None]], 0).astype(np.float32)
    tout = jnp.dot(jnp.asarray(tab16, jnp.bfloat16), onehot,
                   preferred_element_type=jnp.float32).astype(jnp.int32)  # (16, Mc)
    ntri = tout[15]
    # pack the 15 edge ids (+1, 0 = none) as nibbles into two i32 words
    pe0 = jnp.zeros((Mc,), jnp.int32)
    pe1 = jnp.zeros((Mc,), jnp.int32)
    for s in range(8):
        pe0 = pe0 | (tout[s] << (4 * s))
    for s in range(8, 15):
        pe1 = pe1 | (tout[s] << (4 * (s - 8)))

    # ---- stage D_map: triangle -> cell without searchsorted ------------------
    offs_inc = jnp.cumsum(ntri)
    offs = offs_inc - ntri  # exclusive per-cell first-triangle position
    total_tris = offs_inc[-1]
    # triangle stride (sampler semantics only): emit every s-th triangle of
    # the global emission order, s = ceil(total / max_tris) — a traced
    # scalar, so budget pressure thins the sample UNIFORMLY instead of
    # truncating everything after the first max_tris triangles in pool
    # order. s == 1 reduces every formula below to the exact non-sampled
    # mapping (the mesh path always takes that branch).
    if subsample_bricks:
        tri_stride = jnp.maximum((total_tris + max_tris - 1) // max_tris, 1)
    else:
        tri_stride = jnp.int32(1)
    # triangle -> cell WITHOUT a searchsorted or per-slot scatter: write each
    # cell owning a selected triangle at its first SELECTED triangle's output
    # position (one update per active cell) and cummax-fill — cell indices
    # increase with output position. A cell has a selected triangle iff a
    # multiple of s falls in [offs, offs + ntri); its first one is at output
    # slot ceil(offs / s). Distinct cells own disjoint global ranges, so
    # their first-selected slots never collide.
    has = (ntri > 0) & ((offs + ntri - 1) // tri_stride
                        > (offs - 1) // tri_stride)
    dpos = (offs + tri_stride - 1) // tri_stride
    dstc = jnp.where(has & (dpos < max_tris), dpos, max_tris)
    cstart = jnp.zeros((max_tris,), jnp.int32)
    cidx = jax.lax.broadcasted_iota(jnp.int32, (Mc, 1), 0)[:, 0]
    cstart = cstart.at[dstc].set(cidx, mode="drop")
    c_t = jax.lax.cummax(cstart)  # (T,) source cell per OUTPUT triangle

    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
    # columns: 0-7 corner tsdf values, 8-15 packed corner colors, 16-17 cell
    # coords, 18-19 packed edge ids, 20 triangle offset. Edge fracs are NOT
    # precomputed here: the 12 divisions at Mc density cost more than 3 at
    # triangle density in stage 2 (which needs the corner values anyway).
    payload = jnp.stack(
        cv + pc + [
            bc((cellx + 8192) | ((celly + 8192) << 14)),
            bc(cellz + 8192),
            bc(pe0), bc(pe1),
            bc(offs),
        ], axis=1)  # (Mc, 21)
    # pad rows 21 -> 64: XLA's row-gather emitter is ~4x faster on 64-lane
    # rows than on 21/32 (measured 15.7 ms vs 56 ms for 1M rows from a
    # 4.2M-row source); the pad copy is one bandwidth pass
    payload = jnp.pad(payload, ((0, 0), (0, 43)))
    overflow1 = (jnp.bool_(False) if subsample_bricks
                 else n_bricks > max_bricks)
    return payload, c_t, total_tris, overflow1, tri_stride


# packed edge-endpoint tables: corner ids (3 bits each) of EDGE_A/EDGE_B for
# edges 0-7 in word 0, edges 8-11 in word 1 — lets stage 2 derive the vertex's
# corner ids from its edge id with shifts instead of 12-term mask-sums
_EA_PACK = (int(np.sum(_EDGE_A[:8] << (3 * np.arange(8)))),
            int(np.sum(_EDGE_A[8:] << (3 * np.arange(4)))))
_EB_PACK = (int(np.sum(_EDGE_B[:8] << (3 * np.arange(8)))),
            int(np.sum(_EDGE_B[8:] << (3 * np.arange(4)))))


@jax.jit
def _extract_gather(payload, c_t):
    """The (max_tris, 64) payload row gather, alone in its own jit: with the
    operand AND the consumers on the far side of jit boundaries, XLA emits
    the fast whole-row gather (~19 ms for 1M rows). Fused either way — with
    the payload producers or with the column consumers — it degrades ~2x,
    and optimization_barrier does NOT prevent that (measured)."""
    return payload[c_t]


@partial(jax.jit, static_argnames=("cfg", "max_tris", "return_cells",
                                   "return_encoding"))
def _extract_stage2(pt, total_tris, overflow1, cfg: TSDFConfig,
                    max_tris: int, return_cells: bool = False,
                    return_encoding: bool = False, tri_stride=1):
    """Per-triangle expansion: elementwise vertex reconstruction from the
    gathered (max_tris, 64) payload rows.

    All elementwise work runs on flat (T,) arrays, one pass per triangle
    vertex: a (3, T) layout would tile-pad 3 sublanes to 8 and waste 62% of
    every VPU op on padding.

    ``return_encoding`` additionally returns (fracs (3, T) f32, edges (T,)
    i32 with vertex v's edge id in bits 4v..4v+3) — the compressed vertex
    encoding tsdf.incremental pulls instead of 9 xyz rows: together with the
    cell coords the host reconstructs vertices BIT-EXACTLY (the same
    f32 expression this stage evaluates, IEEE add/mul in the same order)."""
    bci = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)

    s = jnp.asarray(tri_stride, jnp.int32)  # 1 everywhere but the sampler
    t_iota = jnp.arange(max_tris, dtype=jnp.int32)
    # output slot j holds global triangle j*s; its within-cell slot is that
    # global index minus the cell's first-triangle offset (s == 1: identity)
    k_t = t_iota * s - bci(pt[:, 20])
    pe0_t = bci(pt[:, 18])
    pe1_t = bci(pt[:, 19])
    cw0 = bci(pt[:, 16])
    cell0 = ((cw0 & 0x3FFF) - 8192).astype(jnp.float32)
    cell1 = (((cw0 >> 14) & 0x3FFF) - 8192).astype(jnp.float32)
    cell2 = (bci(pt[:, 17]) - 8192).astype(jnp.float32)

    num_tris = jnp.minimum((total_tris + s - 1) // s,
                           max_tris).astype(jnp.int32)
    # a stride > 1 cannot overflow by construction (ceil-division target)
    overflow = (total_tris > max_tris * s) | overflow1
    tmask = t_iota < num_tris

    verts_rows = []
    vcols_rows = []
    frac_rows = []
    edges_packed = jnp.zeros((max_tris,), jnp.int32)
    for v in range(3):
        # this vertex's edge id: nibble 3*k_t + v of the packed table row
        sidx = 3 * k_t + v  # (T,)
        nib = jnp.where(sidx < 8,
                        jax.lax.shift_right_logical(pe0_t, 4 * jnp.clip(sidx, 0, 7)),
                        jax.lax.shift_right_logical(pe1_t, 4 * jnp.clip(sidx - 8, 0, 6)))
        ev = jnp.clip((nib & 0xF) - 1, 0, 11)  # (T,)

        # endpoint corner ids from the packed tables (shifts, no mask-sums);
        # the corner's (x, y, z) offset is its id's bit pattern (mc_tables
        # corner k sits at ((k>>0)&1, (k>>1)&1, (k>>2)&1))
        def corner_of(pack):
            return jnp.where(
                ev < 8,
                jax.lax.shift_right_logical(pack[0], 3 * jnp.clip(ev, 0, 7)),
                jax.lax.shift_right_logical(pack[1], 3 * jnp.clip(ev - 8, 0, 3)),
            ) & 7
        ca = corner_of(_EA_PACK)  # (T,) corner ids 0..7
        cb = corner_of(_EB_PACK)

        # endpoint tsdf values + packed colors, selected by corner id with a
        # 7-op binary where-tree per value (an 8-term mask-sum costs ~2.5x
        # more VPU work and overflows the fusion's register budget)
        def sel8(c, base):
            b0 = (c & 1) != 0
            b1 = (c & 2) != 0
            b2 = (c & 4) != 0
            w = lambda m, hi, lo: jnp.where(m, hi, lo)
            lo = w(b1, w(b0, pt[:, base + 3], pt[:, base + 2]),
                   w(b0, pt[:, base + 1], pt[:, base + 0]))
            hi = w(b1, w(b0, pt[:, base + 7], pt[:, base + 6]),
                   w(b0, pt[:, base + 5], pt[:, base + 4]))
            return w(b2, hi, lo)
        va = sel8(ca, 0)
        vb = sel8(cb, 0)
        pca = sel8(ca, 8)
        pcb = sel8(cb, 8)

        # edge interpolation frac (same f32 expression as the parity ref)
        denom = va - vb
        frac = jnp.clip(va / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12),
                        0.0, 1.0)

        vert = jnp.stack([
            (cell0 + 0.5 + (ca & 1) + frac * ((cb & 1) - (ca & 1))),
            (cell1 + 0.5 + ((ca >> 1) & 1) + frac * (((cb >> 1) & 1) - ((ca >> 1) & 1))),
            (cell2 + 0.5 + ((ca >> 2) & 1) + frac * (((cb >> 2) & 1) - ((ca >> 2) & 1))),
        ]) * cfg.voxel_size  # (3, T)

        def unpack(p):
            r = jnp.floor(p * (1.0 / 65536.0))
            g = jnp.floor((p - r * 65536.0) * (1.0 / 256.0))
            b_ = p - r * 65536.0 - g * 256.0
            return r, g, b_
        ra, ga, ba = unpack(pca)
        rb, gb, bb = unpack(pcb)
        # note: / 255.0, not * (1/255): 255 is not a power of two, so the
        # reciprocal differs by an ulp from the parity reference's division
        vcol = jnp.stack([ra + frac * (rb - ra),
                          ga + frac * (gb - ga),
                          ba + frac * (bb - ba)]) / 255.0  # (3, T)

        # zero the tail (cummax propagated the last cell into tail slots)
        verts_rows.append(jnp.where(tmask[None], vert, 0.0))
        vcols_rows.append(jnp.where(tmask[None], vcol, 0.0))
        if return_encoding:
            frac_rows.append(jnp.where(tmask, frac, 0.0))
            edges_packed = edges_packed | (jnp.where(tmask, ev, 0) << (4 * v))

    # outputs stay T-minor: (vtx, xyz, tri). extract_mesh reorders on host.
    out = (jnp.stack(verts_rows), jnp.stack(vcols_rows), num_tris, overflow)
    if return_cells:
        # per-triangle source VOXEL CELL coords (3, T) — the incremental
        # extractor groups triangles by owning block with floor_div(cell, R)
        cells = jnp.stack([cell0, cell1, cell2]).astype(jnp.int32)
        out = out + (jnp.where(tmask[None], cells, -9999),)
    if return_encoding:
        out = out + (jnp.stack(frac_rows), edges_packed)
    return out


def extract_mesh_arrays(vol: TSDFVolume, cfg: TSDFConfig,
                        max_cells: int = 65536, max_tris: int = 131072,
                        extract_blocks: int = None, emit_mask=None,
                        return_cells: bool = False, sel=None, nbr_sel=None,
                        return_encoding: bool = False,
                        subsample_bricks: bool = False):
    """Device-side extraction. Returns (vertices (3, 3, max_tris), colors,
    num_tris, overflow_flag). ``extract_blocks`` bounds the alive prefix
    processed (blocks are allocated densely, so slots >= n_blocks are dead).
    ``max_cells`` budgets the worklist of 64-cell GROUPS (max_cells // 64
    groups; groups are contiguous runs in the pool layout so all group data
    moves as whole-row gathers with no transposes).

    Three jitted dispatches (see _extract_stage1/_extract_gather for why);
    no host syncs — all returned values stay on device. ``emit_mask`` /
    ``return_cells``: see _extract_stage1 / _extract_stage2 (used by
    tsdf.incremental)."""
    payload, c_t, total_tris, overflow1, tri_stride = _extract_stage1(
        vol, cfg, max_cells, max_tris, extract_blocks, emit_mask=emit_mask,
        sel=sel, nbr_sel=nbr_sel, subsample_bricks=subsample_bricks)
    pt = _extract_gather(payload, c_t)
    return _extract_stage2(pt, total_tris, overflow1, cfg=cfg,
                           max_tris=max_tris, return_cells=return_cells,
                           return_encoding=return_encoding,
                           tri_stride=tri_stride)


def extract_surface_samples(vol: TSDFVolume, cfg: TSDFConfig,
                            n_points: int, max_cells: int = 64 * 8192):
    """Budget-bounded, pool-order-UNBIASED device surface point samples:
    marching-cubes vertices extracted at 4x the requested budget and
    stride-subsampled by the actual emission size. A plain budget overflow
    truncates in pool-slot (= first-seen block) order, which would bias the
    sample toward the oldest-scanned region; striding a larger emission
    covers all blocks uniformly, and small scenes keep full density.

    Used as the tracking model by the frame-to-model pipeline mode
    (pipelines.mono_odometry_tsdf) and by tracking.relocalize — both need
    surface points that represent the WHOLE map, not its oldest corner.

    Returns (points (3 * (n_points//3), 3), mask, overflow) — points/mask on
    device, overflow a device bool that is True when the surface exceeded
    even the 4x emission (the sample is then still biased toward old blocks;
    callers surface it instead of hiding it). Syncs twice (n_blocks for the
    extraction prefix, n_tris for the stride choice).
    """
    nb = int(vol.n_blocks)
    E = snap_extract_blocks(nb, vol.tsdf.shape[0])
    mtris = max(n_points // 3, 1)
    v, _c, n_tris, ovf = extract_mesh_arrays(
        vol, cfg, max_cells=max_cells, max_tris=4 * mtris, extract_blocks=E)
    nt = int(n_tris)
    stride = 1 if nt <= mtris else (2 if nt <= 2 * mtris else 4)
    v = v[:, :, ::stride][:, :, :mtris]  # (3, 3, mtris) at every stride
    pts = v.transpose(2, 0, 1).reshape(-1, 3)  # (3*mtris, 3)
    n_keep = min(-(-nt // stride), mtris)
    mask = (jax.lax.broadcasted_iota(jnp.int32, (3 * mtris, 1), 0)[:, 0]
            < 3 * n_keep)
    return pts, mask, ovf


def extract_surface_samples_device(vol: TSDFVolume, cfg: TSDFConfig,
                                   n_points: int, extract_blocks: int,
                                   max_cells: int = 64 * 8192,
                                   emit_mask=None):
    """ZERO-SYNC twin of :func:`extract_surface_samples` for hot-loop
    callers (the frame-to-model refresh runs at tracking cadence, where a
    host round trip stalls the dispatch queue): the
    caller supplies the static extraction prefix (e.g. from a prefetched
    block count), the stride subsample happens device-side, and overflow
    comes back as a DEVICE flag for deferred telemetry. Same sampling
    semantics: identical stride ladder, identical indices, identical mask
    arithmetic — only where the scalars live differs."""
    mtris = max(n_points // 3, 1)
    v, _c, n_tris, ovf = extract_mesh_arrays(
        vol, cfg, max_cells=max_cells, max_tris=4 * mtris,
        extract_blocks=extract_blocks, emit_mask=emit_mask)
    pts, mask = _stride_subsample(v, n_tris, mtris)
    return pts, mask, ovf


@partial(jax.jit, static_argnames=("mtris",))
def _stride_subsample(v, n_tris, mtris: int):
    """Device-side form of the stride pick in extract_surface_samples:
    stride in {1, 2, 4} by emission size, gather every stride-th triangle,
    mask the kept prefix."""
    nt = n_tris.astype(jnp.int32)
    stride = jnp.where(nt <= mtris, 1, jnp.where(nt <= 2 * mtris, 2, 4))
    idx = jnp.arange(mtris, dtype=jnp.int32) * stride
    idx = jnp.minimum(idx, v.shape[2] - 1)
    pts = v[:, :, idx].transpose(2, 0, 1).reshape(-1, 3)
    n_keep = jnp.minimum((nt + stride - 1) // stride, mtris)
    mask = (jax.lax.broadcasted_iota(jnp.int32, (3 * mtris, 1), 0)[:, 0]
            < 3 * n_keep)
    return pts, mask


@partial(jax.jit, static_argnames=("B", "S"))
def sample_block_selection(vol: TSDFVolume, T_world_cam, reach, block_size,
                           B: int, S: int):
    """Device-side view-local block sample: a deterministic stride-pick of
    up to ``B`` alive EMITTING blocks whose centers lie within ``reach`` of
    the camera, plus up to ``S`` of their alive +corner neighbors as
    non-emitting corner-value SUPPLIERS, in the COMPACT form
    ``_extract_stage1`` takes (sel, nbr_sel, emit) — all shapes static,
    zero host syncs, no rung ladder (the stride is a traced scalar).

    This is how the frame-to-model refresh scales with the MODEL instead of
    the pool (VERDICT r4 next-round #1): the r4 prefix form scanned every
    alive block (stage A cost ~56 ms at the 4096-block rung) to produce a
    32k-point sample that needs a few hundred blocks of coverage. The
    stride-pick covers the near scene UNIFORMLY. Suppliers matter: a
    surface lying in a block's +boundary layer (a wall on a block-grid
    plane — common at 8 cm blocks) emits ONLY from boundary cells, whose
    corner values live in the +corner neighbors; without them those cells
    fail validity and whole grid-aligned walls vanish from the sample
    (caught by test_block_sampled_model_view_local_and_covers). Supplier
    overflow (> S distinct alive neighbors) is returned as a flag — the
    affected boundary cells degrade to non-emission, never to wrong
    geometry. With stride == 1 and every alive block near, the selection
    is the identity over the alive prefix (suppliers all picked, S rows
    all dead) and extraction is bit-identical to the prefix form (tested).
    """
    cap = vol.block_coords.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (cap, 1), 0)[:, 0]
    alive = iota < vol.n_blocks
    centers = (vol.block_coords.astype(jnp.float32) + 0.5) * jnp.float32(
        block_size)
    d = jnp.linalg.norm(centers - T_world_cam[:3, 3], axis=1)
    near = alive & (d <= reach)
    cnt = jnp.sum(near.astype(jnp.int32))
    stride = jnp.maximum((cnt + B - 1) // B, 1)
    rank = jnp.cumsum(near.astype(jnp.int32)) - 1
    pick = near & (rank % stride == 0)
    pos = jnp.cumsum(pick.astype(jnp.int32)) - 1
    dst = jnp.where(pick & (pos < B), pos, B)  # B = drop (OOB)
    selB = jnp.full((B,), -1, jnp.int32).at[dst].set(iota, mode="drop")
    live = selB >= 0
    slot = jnp.where(live, selB, 0)
    nbr_pool = _neighbor_slots(vol.table, vol.block_coords[slot])  # (B, 8)
    nbr_ok = (nbr_pool >= 0) & live[:, None]
    # suppliers: alive +corner neighbors of picked blocks, not themselves
    # picked, compacted into S rows in pool order (deterministic)
    picked = jnp.zeros((cap + 1,), bool).at[
        jnp.where(live, selB, cap)].set(True)[:cap]
    sup = jnp.zeros((cap + 1,), bool).at[
        jnp.where(nbr_ok[:, 1:], nbr_pool[:, 1:], cap)].set(True)[:cap]
    sup = sup & ~picked
    n_sup = jnp.sum(sup.astype(jnp.int32))
    spos = jnp.cumsum(sup.astype(jnp.int32)) - 1
    sdst = jnp.where(sup & (spos < S), spos, S)
    selS = jnp.full((S,), -1, jnp.int32).at[sdst].set(iota, mode="drop")
    sel = jnp.concatenate([selB, selS])  # (B + S,)
    # pool slot -> compact row (-1 where not selected); dead rows park
    # their write at [cap], which no nbr_pool slot can read
    rows = jax.lax.broadcasted_iota(jnp.int32, (B + S, 1), 0)[:, 0]
    pool2c = jnp.full((cap + 1,), -1, jnp.int32).at[
        jnp.where(sel >= 0, sel, cap)].set(rows)
    # only emitting rows need neighbor resolution (code 0 = self is read
    # directly from the row's own data in _case_mask, and supplier rows
    # never emit)
    nbrB = jnp.where(nbr_ok, pool2c[jnp.clip(nbr_pool, 0, cap)], -1)
    nbr_sel = jnp.concatenate([nbrB, jnp.full((S, 8), -1, jnp.int32)])
    emit = jnp.concatenate([live, jnp.zeros((S,), bool)])
    return sel, nbr_sel, emit, n_sup > S


def extract_sampled_surface_model(vol: TSDFVolume, cfg: TSDFConfig,
                                  n_points: int, T_world_cam, reach: float,
                                  sample_blocks: int = 256,
                                  bricks_per_block: int = 8,
                                  supplier_rows: int = None):
    """ZERO-SYNC surface model sampler whose cost scales with the SAMPLE,
    not the scene: stride-pick ``sample_blocks`` near blocks
    (:func:`sample_block_selection`), extract only their cells through the
    compact path with a ``sample_blocks * bricks_per_block`` group budget
    (brick-level stride-subsample on overflow — never pool-order
    truncation), then stride-subsample triangles to ``n_points``. Three
    levels of deterministic uniform thinning, all device-side.

    Used by the frame-to-model refresh (pipelines/mono_odometry_tsdf) in
    place of the full-prefix ``extract_surface_samples_device``: same
    output contract (points (3*(n_points//3), 3), mask, overflow device
    flag). The triangle stride in stage D already thins uniformly to the
    budget (no 4x over-emission + ladder needed), so the returned overflow
    reports only a supplier-row overflow (> ``supplier_rows`` distinct
    alive +corner neighbors — affected boundary cells degrade to
    non-emission; ``supplier_rows`` defaults to 3x the picked blocks,
    comfortably above the ~2-4 alive +neighbors surface blocks average).

    ``bricks_per_block`` sets the group budget, which is what stage C/D
    cost scales with (the D_map scatter pays per BUDGETED cell, active or
    not). The default 8 (of 64 bricks in a 16^3 block) is deliberate: a
    32k-point model keeps ~43 triangles per sampled block after the
    triangle stride — orders below even 8 bricks' worth of emission — so
    a tighter brick budget thins a thinning that already happens, at half
    the stage-1 cost of 16 (measured 37 -> ~20 ms on the f2m bench pool).

    The whole chain runs as ONE jit dispatch (:func:`_sampled_model_impl`):
    the mesh path's stage1/stage2 split exists because its (max_tris, 64)
    gather runs 2x faster on a MATERIALIZED payload at ~1M rows — at the
    sampler's ~11k rows that effect is noise, while a 5-dispatch chain
    pays ~5x the per-dispatch host overhead every refresh."""
    S = 3 * sample_blocks if supplier_rows is None else supplier_rows
    return _sampled_model_impl(
        vol, jnp.asarray(T_world_cam, jnp.float32), jnp.float32(reach),
        cfg, n_points, sample_blocks, bricks_per_block, S)


@partial(jax.jit, static_argnames=("cfg", "n_points", "sample_blocks",
                                   "bricks_per_block", "S"))
def _sampled_model_impl(vol: TSDFVolume, T_world_cam, reach,
                        cfg: TSDFConfig, n_points: int, sample_blocks: int,
                        bricks_per_block: int, S: int):
    mtris = max(n_points // 3, 1)
    sel, nbr_sel, emit, sel_ovf = sample_block_selection(
        vol, T_world_cam, reach, jnp.float32(cfg.block_size),
        sample_blocks, S)
    v, _c, n_tris, ovf = extract_mesh_arrays(
        vol, cfg, max_cells=sample_blocks * bricks_per_block * 64,
        max_tris=mtris, sel=sel, nbr_sel=nbr_sel, emit_mask=emit,
        subsample_bricks=True)
    pts, mask = _flatten_tris(v, n_tris, mtris)
    return pts, mask, ovf | sel_ovf


@partial(jax.jit, static_argnames=("mtris",))
def _flatten_tris(v, n_tris, mtris: int):
    """(3, 3, mtris) tri-minor vertex planes -> ((3*mtris, 3) points, kept
    mask) — the sampler's output layout, already uniformly thinned by the
    stage-D triangle stride."""
    pts = v.transpose(2, 0, 1).reshape(-1, 3)
    mask = (jax.lax.broadcasted_iota(jnp.int32, (3 * mtris, 1), 0)[:, 0]
            < 3 * n_tris.astype(jnp.int32))
    return pts, mask


@partial(jax.jit, static_argnames=("cfg", "extract_blocks"))
def count_active_bricks(vol: TSDFVolume, cfg: TSDFConfig,
                        extract_blocks: int):
    """Number of 64-cell groups stage B would compact (stage-A case math
    only — ins/val corner views, no value/color planes). Callers use it to
    FIT ``max_cells`` to the scene instead of over-provisioning: most of
    stage C/D's cost scales with the padded worklist (the D_map scatter is
    ~4.3 ns per BUDGETED cell, active or not — docs/PERF.md), so a snug
    budget measured 92.9 -> 76.9 ms on the 738k-tri bench scene. One cheap
    extra dispatch (~6 ms); bench.py and long-lived pipelines re-fit when
    the scene grows past the budgeted rung."""
    R = cfg.block_resolution
    C3 = R * R * R
    E = min(extract_blocks, vol.tsdf.shape[0])
    t2 = vol.tsdf[:E].reshape(E, C3)
    w2 = vol.weight[:E].reshape(E, C3)
    coords = vol.block_coords[:E]
    alive = jax.lax.broadcasted_iota(jnp.int32, (E, 1), 0)[:, 0] < vol.n_blocks
    nbr = _neighbor_slots(vol.table, coords)
    nbr = jnp.where(nbr < E, nbr, -1)
    casem = _case_mask(t2, w2, alive, nbr, R)
    B3 = min(64, C3)
    return jnp.any(casem.reshape(E * (C3 // B3), B3) != 0, axis=1).sum()


def build_compact_selection(find, n_live: int, sel_slots, emit_slots,
                            coords, Es: int, pack=None):
    """Host-side arguments for the COMPACT form of ``extract_mesh_arrays``
    (one definition shared by tsdf.incremental and tsdf.streaming — the
    -1-padding and searchsorted-clamp subtleties must not drift apart).

    ``find``: callable mapping packed keys -> pool slots (-1 absent);
    ``pack``: the key packing ``find``'s index was built with (callers keep
    their own — incremental's int64 form vs the hash module's int32 form —
    so it must travel with ``find``; default hash.pack_key_np);
    ``sel_slots``: the unique pool slots to select (emitted blocks + their
    alive positive-corner suppliers); ``emit_slots``: the subset that emits
    triangles; ``coords``: (n_live, 3) alive block coords; ``Es``: padded
    selection bucket. Returns (sel (Es,), nbr_sel (Es, 8), emit (Es,))."""
    if pack is None:
        pack = vhash.pack_key_np
    ns = len(sel_slots)
    pool2c = np.full(n_live, -1, np.int32)
    pool2c[sel_slots] = np.arange(ns, dtype=np.int32)
    nsl = find(pack(
        coords[sel_slots][:, None, :] + _CORNERS[None]).reshape(-1))
    nbr_c = np.where(nsl >= 0, pool2c[np.maximum(nsl, 0)], -1
                     ).reshape(ns, 8).astype(np.int32)
    sel = np.full(Es, -1, np.int32)
    sel[:ns] = sel_slots
    nbr_pad = np.full((Es, 8), -1, np.int32)
    nbr_pad[:ns] = nbr_c
    emit = np.zeros(Es, bool)
    emit[:ns] = np.isin(sel_slots, emit_slots, assume_unique=True)
    return sel, nbr_pad, emit


_TRIANGLE_IDX_CACHE = {}


def extract_mesh(vol: TSDFVolume, cfg: TSDFConfig, max_cells: int = 65536,
                 max_tris: int = 131072, auto_grow: bool = True) -> TriangleMesh:
    """Extract a triangle-soup mesh; grows static budgets (x2, recompile)
    if they overflow and ``auto_grow`` (x2 not x4: stage C/D cost scales
    with the PADDED budgets — see count_active_bricks — so the tighter
    ladder halves the average over-provisioning at the price of one more
    cached compile rung).

    Device outputs are tri-minor (3, 3, T) to dodge lane padding; this host
    wrapper reorders them to the conventional (3T, 3) soup (numpy leaves in
    the TriangleMesh — extraction is a host-facing operation)."""
    n_alive = int(vol.n_blocks)
    N = vol.tsdf.shape[0]
    E = snap_extract_blocks(n_alive, N)
    while True:
        verts_t, vcols_t, num_tris, overflow = extract_mesh_arrays(
            vol, cfg, max_cells=max_cells, max_tris=max_tris, extract_blocks=E
        )
        if not (auto_grow and bool(overflow)):
            break
        max_cells *= 2
        max_tris *= 2
    # (vertex, xyz, tri) -> (tri, vertex, xyz) -> (3T, 3)
    verts = np.asarray(verts_t).transpose(2, 0, 1).reshape(max_tris * 3, 3)
    vcols = np.asarray(vcols_t).transpose(2, 0, 1).reshape(max_tris * 3, 3)
    if max_tris not in _TRIANGLE_IDX_CACHE:
        _TRIANGLE_IDX_CACHE[max_tris] = np.arange(max_tris * 3, dtype=np.int32).reshape(-1, 3)
    return TriangleMesh(
        vertices=verts,
        triangles=_TRIANGLE_IDX_CACHE[max_tris],
        num_vertices=np.int32(int(num_tris) * 3),
        num_triangles=np.int32(int(num_tris)),
        vertex_colors=vcols,
    )


def weld_vertices(mesh: TriangleMeshHost, decimals: int = 6) -> TriangleMeshHost:
    """Host-side vertex welding: triangle soup -> indexed mesh (for OBJ/PLY
    export parity with Open3D's indexed meshes)."""
    keys = np.round(mesh.vertices, decimals)
    uniq, index, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    tris = inverse[mesh.triangles]
    out = TriangleMeshHost(
        vertices=mesh.vertices[index],
        triangles=tris.astype(np.int32),
        vertex_colors=None if mesh.vertex_colors is None else mesh.vertex_colors[index],
    )
    return out
