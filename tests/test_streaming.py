"""Host streaming (tsdf/streaming.py): unbounded scenes on a fixed pool.

The reference's ScalableTSDFVolume grows without bound (CreateMesh.py:
300-336); the fixed HBM pool here needs eviction to match that scale. The
contract under test: a long scan that OVERFLOWS the plain fixed pool runs
overflow-free through StreamingTSDF, and its assembled mesh (live +
frozen caches) is BIT-IDENTICAL to extracting one infinite pool that saw
the same frames — including after evict -> revisit -> reload round trips.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from azurekinect3dreconstruction_tpu.config import TSDFConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu.tsdf import volume as tv
from azurekinect3dreconstruction_tpu.tsdf.marching_cubes import extract_mesh
from azurekinect3dreconstruction_tpu.tsdf.streaming import (
    StreamingTSDF,
    pack_np,
    unpack_np,
)

SMALL = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                   block_capacity=256, hash_capacity=1024)
BIG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                 block_capacity=4096, hash_capacity=16384)


@pytest.fixture(scope="module")
def corridor():
    """A textured wall 1 m in front of a camera translating along +x: every
    frame allocates a fresh column of blocks, painting an arbitrarily long
    corridor — the workload the reference's unbounded volume absorbs and a
    fixed pool cannot."""
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    rays = pixel_rays(intr)
    h, w = intr.height, intr.width
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")

    def frame(x_cam):
        # mild depth relief so the surface is not a single flat plane
        d = 0.6 + 0.03 * np.sin(0.2 * (xx + 37.0 * x_cam)) * np.sin(0.15 * yy)
        c = np.stack([0.5 + 0.5 * np.sin(0.05 * xx + x_cam),
                      np.full_like(d, 0.3),
                      0.5 + 0.5 * np.cos(0.07 * yy)], axis=-1)
        T = np.eye(4)
        T[0, 3] = x_cam
        return d.astype(np.float32), c.astype(np.float32), T

    return intr, rays, frame


def _integrate_all(cfg, frames, intr, rays):
    vol = tv.create(cfg)
    for d, c, T in frames:
        vol = tv.integrate_frame(vol, d, c, rays, T, intr, cfg,
                                 stride=2)
    return vol


def _sorted_soup(verts, cols):
    """Canonical order for triangle soups: triangles as (9 xyz + 9 rgb)
    rows, lexsorted — slot order is run-dependent, geometry is not."""
    t = np.concatenate([verts.reshape(-1, 9), cols.reshape(-1, 9)], axis=1)
    return t[np.lexsort(t.T[::-1])]


def _stream_mesh_sorted(sv):
    m = sv.extract_mesh()
    return _sorted_soup(m.vertices.reshape(-1, 3, 3),
                        m.vertex_colors.reshape(-1, 3, 3))


def _full_mesh_sorted(vol, cfg):
    m = extract_mesh(vol, cfg, max_cells=1 << 15, max_tris=1 << 17)
    nt = int(m.num_triangles)
    return _sorted_soup(m.vertices.reshape(-1, 3, 3)[:nt],
                        m.vertex_colors.reshape(-1, 3, 3)[:nt])


def test_pack_np_matches_device_pack():
    from azurekinect3dreconstruction_tpu.tsdf import hash as vhash

    c = np.array([[0, 0, 0], [1, -2, 3], [-511, 510, -1], [17, -400, 255]],
                 np.int32)
    np.testing.assert_array_equal(pack_np(c),
                                  np.asarray(vhash.pack_key(jnp.asarray(c))))
    np.testing.assert_array_equal(unpack_np(pack_np(c)), c)


def test_long_scan_overflows_plain_pool(corridor):
    """The workload must actually exceed the fixed pool — otherwise the
    streaming assertions below prove nothing."""
    intr, rays, frame = corridor
    frames = [frame(0.04 * i) for i in range(80)]
    vol = _integrate_all(SMALL, frames, intr, rays)
    assert bool(vol.overflow)
    assert int(vol.n_blocks) == SMALL.block_capacity - 1  # trash row reserved


def test_streaming_scan_no_overflow_and_exact_mesh(corridor):
    intr, rays, frame = corridor
    frames = [frame(0.04 * i) for i in range(80)]
    sv = StreamingTSDF(SMALL, evict_dist=1.4, reload_dist=1.1,
                       high_water=0.75, check_interval=4,
                       max_cells=1 << 14, max_tris=1 << 16)
    for d, c, T in frames:
        sv.integrate_frame(d, c, rays, T, intr)
    assert not bool(sv.vol.overflow)
    assert sv.n_evictions > 0
    assert sv.n_stored > 0
    assert sv.n_frozen >= sv.n_stored  # every stored block is frozen

    ref = _integrate_all(BIG, frames, intr, rays)
    got = _stream_mesh_sorted(sv)
    want = _full_mesh_sorted(ref, BIG)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)

    # the point-cloud API must also cover the stored (evicted) region
    gp, gc = sv.extract_point_cloud()
    wp, wc = tv.extract_point_cloud(ref, BIG)
    g = np.concatenate([gp, gc], axis=1)
    w = np.concatenate([wp, wc], axis=1)
    g = g[np.lexsort(g.T[::-1])]
    w = w[np.lexsort(w.T[::-1])]
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


def test_streaming_revisit_reloads_and_stays_exact(corridor):
    """Scan right 3.16 m, return to the start, keep integrating: the stored
    blocks must stream back in (bit-exact restore), unfreeze, and the final
    mesh must still equal the infinite-pool run of the same frames.

    Policy arithmetic (the contract the manager documents): integration
    reach here is 0.92 m (measured: 0.6 m wall + trunc + block diagonal),
    camera covers 0.05 * 4 = 0.2 m per check interval, so reload_dist must
    exceed 0.92 + 0.2 — walking back faster than that re-integrates
    still-frozen blocks and the frozen caches go stale by design."""
    intr, rays, frame = corridor
    xs = [0.04 * i for i in range(80)]              # out to 3.16 m
    xs += [3.16 - 0.05 * i for i in range(1, 64)]   # walk back to 0.01
    xs += [0.0, 0.02, 0.04, 0.06]                   # re-integrate the start
    frames = [frame(x) for x in xs]
    sv = StreamingTSDF(SMALL, evict_dist=1.45, reload_dist=1.2,
                       high_water=0.75, check_interval=4,
                       max_cells=1 << 14, max_tris=1 << 16)
    for d, c, T in frames:
        sv.integrate_frame(d, c, rays, T, intr)
    assert not bool(sv.vol.overflow)
    assert sv.n_evictions > 0
    assert sv.n_reloads > 0

    ref = _integrate_all(BIG, frames, intr, rays)
    got = _stream_mesh_sorted(sv)
    want = _full_mesh_sorted(ref, BIG)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_streaming_reset_then_rescan_stays_exact(corridor):
    """reset_state mid-scan (the 'C' key with store/soups populated) must
    forget everything; a rescan afterwards matches a fresh infinite-pool
    run of just the post-reset frames."""
    intr, rays, frame = corridor
    frames = [frame(0.04 * i) for i in range(60)]
    sv = StreamingTSDF(SMALL, evict_dist=1.4, reload_dist=1.1,
                       high_water=0.75, check_interval=4,
                       max_cells=1 << 14, max_tris=1 << 16)
    for d, c, T in frames:
        sv.integrate_frame(d, c, rays, T, intr)
    assert sv.n_stored > 0
    sv.reset_state()
    assert sv.n_stored == 0 and sv.n_frozen == 0
    assert int(sv.vol.n_blocks) == 0
    rescan = [frame(0.04 * i) for i in range(20)]
    for d, c, T in rescan:
        sv.integrate_frame(d, c, rays, T, intr)
    ref = _integrate_all(BIG, rescan, intr, rays)
    np.testing.assert_array_equal(_stream_mesh_sorted(sv),
                                  _full_mesh_sorted(ref, BIG))


@pytest.mark.slow
def test_streaming_thrash_across_hysteresis_band(corridor):
    """Oscillating across the reload/evict hysteresis band must not corrupt
    geometry or leak state: repeated evict/reload cycles of the same blocks
    end bit-exact, and every block is in exactly one of live/stored."""
    intr, rays, frame = corridor
    xs = [0.04 * i for i in range(70)]            # out to 2.76 m
    for _ in range(3):  # oscillate deep enough to cross the reload ring of
        #                 the evicted start region (stored blocks sit at
        #                 x <= camera_at_first_eviction - ~1.2)
        xs += [2.76 - 0.04 * i for i in range(1, 45)]  # back to 1.00
        xs += [1.00 + 0.04 * i for i in range(1, 45)]  # forward to 2.76
    frames = [frame(x) for x in xs]
    sv = StreamingTSDF(SMALL, evict_dist=1.4, reload_dist=1.1,
                       high_water=0.75, check_interval=4,
                       max_cells=1 << 14, max_tris=1 << 16)
    for d, c, T in frames:
        sv.integrate_frame(d, c, rays, T, intr)
    assert not bool(sv.vol.overflow)
    assert sv.n_reloads >= 3
    n = int(sv.vol.n_blocks)
    live = set(pack_np(np.asarray(sv.vol.block_coords[:n])).tolist())
    stored = set(sv.store.keys())
    assert not (live & stored), "a block may not be live AND stored"
    ref = _integrate_all(BIG, frames, intr, rays)
    got = _stream_mesh_sorted(sv)
    want = _full_mesh_sorted(ref, BIG)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_incremental_extractor_survives_streaming_compaction(corridor):
    """live_mono --streaming (non-headless) runs IncrementalExtractor over
    the streaming pipe's volume for the live preview: pool compaction must
    read as a volume reset there (slot checksums shuffle), not crash or
    serve stale spans — and its soup must equal a fresh full extraction of
    the LIVE region."""
    from azurekinect3dreconstruction_tpu.tsdf.incremental import (
        IncrementalExtractor,
    )

    intr, rays, frame = corridor
    sv = StreamingTSDF(SMALL, evict_dist=1.4, reload_dist=1.1,
                       high_water=0.75, check_interval=4,
                       max_cells=1 << 14, max_tris=1 << 16)
    inc = IncrementalExtractor(SMALL, max_cells=1 << 14, max_tris=1 << 16)
    for i in range(60):
        d, c, T = frame(0.04 * i)
        sv.integrate_frame(d, c, rays, T, intr)
        if i % 4 == 0:
            m = inc.update(sv.vol)
    assert sv.n_evictions > 0
    m = inc.update(sv.vol)
    fresh = IncrementalExtractor(SMALL, max_cells=1 << 14,
                                 max_tris=1 << 16).update(sv.vol)
    got = _sorted_soup(m.vertices.reshape(-1, 3, 3),
                       m.vertex_colors.reshape(-1, 3, 3))
    want = _sorted_soup(fresh.vertices.reshape(-1, 3, 3),
                        fresh.vertex_colors.reshape(-1, 3, 3))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_incremental_index_survives_shuffle_at_constant_nb(corridor):
    """The adversarial compaction case (review finding): slots shuffle while
    n_blocks stays IDENTICAL (evict k + allocate k, or a pure permutation),
    so neither the nb-decrease nor the monotonic-decrease reset heuristics
    fire — the extractor's sorted key->slot index must rebuild anyway (it
    now compares the in-band coords), or selections would index slots that
    hold different blocks."""
    from azurekinect3dreconstruction_tpu.tsdf.incremental import (
        IncrementalExtractor,
    )
    from azurekinect3dreconstruction_tpu.tsdf.streaming import _compact

    intr, rays, frame = corridor
    vol = _integrate_all(SMALL, [frame(0.04 * i) for i in range(8)],
                         intr, rays)
    inc = IncrementalExtractor(SMALL, max_cells=1 << 14, max_tris=1 << 16)
    inc.update(vol)
    n = int(vol.n_blocks)
    # shuffle the pool at constant nb; weights only MOVE (the monotonic
    # per-slot sums change but in both directions — the reset heuristic may
    # or may not fire; correctness must not depend on it)
    perm = np.random.RandomState(7).permutation(n).astype(np.int32)
    full = np.zeros(SMALL.block_capacity, np.int32)
    full[:n] = perm
    vol2 = _compact(vol, full, np.int32(n))
    assert int(vol2.n_blocks) == n
    # one more frame so the update has changed blocks to re-extract
    d, c, T = frame(0.32)
    from azurekinect3dreconstruction_tpu.tsdf import volume as tvol

    vol2 = tvol.integrate_frame(vol2, d, c, rays, T, intr, SMALL,
                                stride=2)
    m = inc.update(vol2)
    fresh = IncrementalExtractor(SMALL, max_cells=1 << 14,
                                 max_tris=1 << 16).update(vol2)
    got = _sorted_soup(m.vertices.reshape(-1, 3, 3),
                       m.vertex_colors.reshape(-1, 3, 3))
    want = _sorted_soup(fresh.vertices.reshape(-1, 3, 3),
                        fresh.vertex_colors.reshape(-1, 3, 3))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_reload_defers_when_pool_full(corridor):
    """A reload into a full pool must DEFER (payload back in the store,
    warning logged) — never silently lose the block (review finding r3)."""
    cfg = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                     block_capacity=64, hash_capacity=256)
    sv = StreamingTSDF(cfg, evict_dist=1.4, reload_dist=1.1, high_water=0.9)
    intr, rays, frame = corridor
    d, c, T = frame(0.0)
    from azurekinect3dreconstruction_tpu.tsdf import volume as tvol

    sv.vol = tvol.integrate_frame(sv.vol, d, c, rays, T, intr, cfg,
                                  stride=2)
    assert int(sv.vol.n_blocks) == cfg.block_capacity - 1  # full (trash row)
    s = cfg.block_resolution ** 3 // 128
    key = int(pack_np(np.array([[50, 50, 50]], np.int32))[0])
    payload = (np.ones((s, 128), np.float32), np.ones((s, 128), np.float32),
               np.zeros((3, s, 128), np.float32),
               np.array([50, 50, 50], np.int32))
    sv._store_payload(key, *payload)
    sv._stored_cks[key] = 123
    sv._reload_keys(np.array([key], np.int32))
    assert key in sv.store, "deferred payload must survive in the store"
    assert sv._stored_cks[key] == 123
    np.testing.assert_array_equal(sv._stored_payload(key)[0], payload[0])


def test_compact_preserves_volume_semantics(corridor):
    """Device compaction with a shuffling permutation must preserve every
    key -> voxel-data mapping (lookup through the rebuilt table)."""
    from azurekinect3dreconstruction_tpu.tsdf.streaming import _compact

    intr, rays, frame = corridor
    frames = [frame(0.04 * i) for i in range(6)]
    vol = _integrate_all(SMALL, frames, intr, rays)
    n = int(vol.n_blocks)
    assert n > 8
    qpts = np.random.RandomState(0).uniform(-0.5, 1.4, (512, 3)).astype(
        np.float32)
    qpts[:, 2] += 0.6  # bias toward the wall
    t0, w0 = (np.asarray(a) for a in tv.sample_tsdf(vol, qpts, SMALL))

    perm = np.random.RandomState(1).permutation(n).astype(np.int32)
    full = np.zeros(SMALL.block_capacity, np.int32)
    full[:n] = perm
    vol2 = _compact(vol, full, np.int32(n))
    t1, w1 = (np.asarray(a) for a in tv.sample_tsdf(vol2, qpts, SMALL))
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(w0, w1)
    # freed rows (none here) aside, a second compaction dropping half the
    # blocks keeps the survivors' data intact and marks the rest absent
    keep = perm[: n // 2]
    full2 = np.zeros(SMALL.block_capacity, np.int32)
    full2[: len(keep)] = np.arange(len(keep))  # slots in vol2 order
    # survivors = first half of vol2's prefix
    vol3 = _compact(vol2, full2, np.int32(len(keep)))
    t3, w3 = (np.asarray(a) for a in tv.sample_tsdf(vol3, qpts, SMALL))
    kept_keys = set(pack_np(np.asarray(vol2.block_coords[: n // 2])).tolist())
    qvox = np.floor(qpts / SMALL.voxel_size).astype(np.int64)
    qblk = pack_np((qvox // SMALL.block_resolution).astype(np.int32))
    in_kept = np.array([int(k) in kept_keys for k in qblk])
    np.testing.assert_array_equal(t3[in_kept], t0[in_kept])
    np.testing.assert_array_equal(w3[in_kept], w0[in_kept])
    assert np.all(w3[~in_kept] == 0.0)


def test_tick_defers_while_state_in_flight(corridor):
    """With max_defer > 0 the interval tick must NOT block on an unfinished
    state transfer: it keeps returning False (counting deferred_frames)
    until the worker's future resolves, then runs exactly one tick and
    restarts the interval cycle. Models a slow link, where a pull takes
    longer than the interval no matter how early it was dispatched."""
    from concurrent.futures import Future

    intr, rays, frame = corridor
    sv = StreamingTSDF(SMALL, evict_dist=1.6, reload_dist=1.3,
                       high_water=0.95, check_interval=3,
                       max_cells=1 << 14, max_tris=1 << 16, max_defer=8)

    class SlowLander:
        def submit(self, fn, st):
            self.fut = Future()
            self.land = lambda: fn(st)  # the real np.asarray, run on demand
            return self.fut

    lander = SlowLander()
    sv._lander = lander
    ticks = {"n": 0}
    orig = sv.tick
    sv.tick = lambda *a, **kw: (ticks.__setitem__("n", ticks["n"] + 1),
                                orig(*a, **kw))[1]

    pose = np.eye(4)
    assert sv.maybe_tick(pose) is False  # frame 1: prefetch staged
    assert sv._prefetch is not None
    assert sv.maybe_tick(pose) is False  # frame 2
    assert sv.maybe_tick(pose) is False  # frame 3 = interval: defers
    assert sv.maybe_tick(pose) is False  # frame 4: still in flight
    assert sv.tick_ms.get("deferred_frames") == 2.0
    assert ticks["n"] == 0 and sv._prefetch is not None
    lander.fut.set_result(lander.land())  # transfer lands
    assert sv.maybe_tick(pose) is True   # frame 5: tick runs on landing
    assert ticks["n"] == 1 and sv._since_check == 0 and sv._prefetch is None
    # the cycle restarts: next frame stages a fresh prefetch
    assert sv.maybe_tick(pose) is False
    assert sv._prefetch is not None


def test_tick_blocks_when_defer_budget_spent(corridor):
    """The safety valve: once max_defer extra frames have passed, the tick
    blocks on the future rather than let the policy lag unboundedly."""
    import threading
    from concurrent.futures import Future

    intr, rays, frame = corridor
    sv = StreamingTSDF(SMALL, evict_dist=1.6, reload_dist=1.3,
                       high_water=0.95, check_interval=2,
                       max_cells=1 << 14, max_tris=1 << 16, max_defer=2)

    class SlowLander:
        def submit(self, fn, st):
            self.fut = Future()
            threading.Timer(0.3, lambda: self.fut.set_result(fn(st))).start()
            return self.fut

    sv._lander = SlowLander()
    pose = np.eye(4)
    assert sv.maybe_tick(pose) is False  # frame 1: prefetch (0.05 s away)
    assert sv.maybe_tick(pose) is False  # frame 2 = interval: defers
    assert sv.maybe_tick(pose) is False  # frame 3: defer budget ends
    assert sv.maybe_tick(pose) is True   # frame 4: valve blocks, tick runs
    assert sv.n_ticks == 1 and sv._since_check == 0


def test_direct_tick_orphans_pending_prefetch(corridor):
    """A tick issued between maybe_tick's prefetch frame and its tick frame
    (e.g. an explicit policy run from a script) must invalidate the pending
    prefetched state: consuming it later would hand the tick a snapshot
    from BEFORE the interposed tick's reload/evict mutations. The interval
    cycle must also keep ticking correctly afterwards."""
    intr, rays, frame = corridor
    sv = StreamingTSDF(SMALL, evict_dist=1.4, reload_dist=1.1,
                       high_water=0.75, check_interval=4,
                       max_cells=1 << 14, max_tris=1 << 16)
    ticks = {"n": 0}
    orig = sv.tick

    def counting_tick(cam_pos, _state=None):
        ticks["n"] += 1
        # a consumed prefetch must never be the orphaned one
        orig(cam_pos, _state=_state)

    sv.tick = counting_tick
    for i in range(3):  # frames 1..3: frame 3 is the prefetch frame
        d, c, T = frame(0.04 * i)
        sv.integrate_frame(d, c, rays, T, intr)
    assert sv._prefetch is not None  # prefetch staged one frame early
    orig(np.zeros(3))  # direct tick: orphan it
    assert sv._prefetch is None
    # the counter restarted: three more frames re-stage a prefetch, the
    # fourth consumes it
    for i in range(4):
        d, c, T = frame(0.04 * (3 + i))
        sv.integrate_frame(d, c, rays, T, intr)
    assert ticks["n"] == 1 and sv._prefetch is None
