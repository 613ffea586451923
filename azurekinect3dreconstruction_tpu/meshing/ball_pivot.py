"""First-party ball-pivoting surface reconstruction (host-side).

Parity target: the reference's mesh fallback chain is Poisson -> Open3D
``create_from_point_cloud_ball_pivoting`` with the radius ladder
[0.005, 0.01, 0.02, 0.04] (CodeThatKindaWorks/PointCloudToMesh.py:146,
CodeThatWorks/BetterVisualizerD2camerasWorks1Cam.py:431-441). This module is
the dependency-free equivalent, so the chain no longer needs Open3D for its
middle rung (meshing.poisson delegates here when Open3D is absent).

Why host-side: ball pivoting is an advancing-front algorithm — each accepted
triangle changes which edge is pivoted next, a serial data-dependent chain
with no batch parallelism to offer an accelerator (SURVEY.md §7.3's reasoning for
Poisson applies verbatim). It runs at save/export cadence on clouds that the
callers have already voxel-downsampled, where a numpy front loop is fine;
the per-edge candidate math (circumcenters, empty-ball tests) is vectorized
over the 27-cell grid neighborhood, so Python only pays per front edge, not
per candidate.

Algorithm (Bernardini et al. 1999, the same paper Open3D implements): seed a
triangle whose circumscribing r-ball is empty, then roll the ball over each
front edge; the first point it touches (smallest pivot angle around the edge
axis) forms the next triangle. Edges that the ball cannot pivot past at one
radius are retried at the next rung of the ladder (larger ball bridges
sparser regions), matching the multi-radius semantics of the Open3D call.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np

from azurekinect3dreconstruction_tpu.core.types import (
    PointCloudHost,
    TriangleMeshHost,
)
from azurekinect3dreconstruction_tpu.utils.telemetry import log_info, log_warning


class _CellGrid:
    """Uniform host grid for fixed-radius candidate queries. Cell edge ==
    query radius, so the 27-cell neighborhood is complete for any query
    point inside the center cell (same invariant as ops.neighbors.knn)."""

    def __init__(self, points: np.ndarray, cell: float):
        self.points = points
        self.cell = float(cell)
        coords = np.floor(points / self.cell).astype(np.int64)
        # pack to a scalar key (clouds are metres-scale; 2^21 cells per axis
        # is overkill-safe) and sort once: runs of equal keys are cells
        self._keys = ((coords[:, 0] & 0x1FFFFF) << 42 |
                      (coords[:, 1] & 0x1FFFFF) << 21 |
                      (coords[:, 2] & 0x1FFFFF))
        self._order = np.argsort(self._keys, kind="stable")
        sk = self._keys[self._order]
        first = np.concatenate([[True], sk[1:] != sk[:-1]])
        self._cell_keys = sk[first]
        self._cell_start = np.flatnonzero(first)
        self._cell_end = np.concatenate([self._cell_start[1:], [len(sk)]])
        self._offs = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3),
                                          indexing="ij"), -1).reshape(27, 3)

    def query(self, center: np.ndarray, radius: float) -> np.ndarray:
        """Indices of points within ``radius`` of ``center``. Requires
        ``radius <= cell`` (the 27-neighborhood completeness bound)."""
        c = np.floor(center / self.cell).astype(np.int64) + self._offs
        keys = ((c[:, 0] & 0x1FFFFF) << 42 | (c[:, 1] & 0x1FFFFF) << 21 |
                (c[:, 2] & 0x1FFFFF))
        pos = np.searchsorted(self._cell_keys, keys)
        pos = np.clip(pos, 0, len(self._cell_keys) - 1)
        hit = self._cell_keys[pos] == keys
        if not hit.any():
            return np.empty((0,), np.int64)
        segs = [self._order[self._cell_start[p]:self._cell_end[p]]
                for p in pos[hit]]
        idx = np.concatenate(segs)
        d2 = np.einsum("ij,ij->i", self.points[idx] - center,
                       self.points[idx] - center)
        return idx[d2 <= radius * radius]


def _ball_centers(pa, pb, pc, r, n_hint):
    """Centers of the radius-``r`` balls touching point triples, on the side
    ``n_hint`` points to. ``pc``/``n_hint`` may be batched (K,3); returns
    (centers (K,3), valid (K,), tri_normals (K,3)). Invalid where the
    triple's circumradius exceeds r (the ball cannot touch all three) or the
    triple is degenerate."""
    pc = np.atleast_2d(pc)
    n_hint = np.atleast_2d(n_hint)
    ab, ac = pb - pa, pc - pa  # (3,), (K,3)
    n = np.cross(np.broadcast_to(ab, ac.shape), ac)  # (K,3)
    n2 = np.einsum("ij,ij->i", n, n)
    ok = n2 > 1e-24
    n2s = np.where(ok, n2, 1.0)
    # circumcenter: a + (|ac|^2 (n x ab) + |ab|^2 (ac x n)) / (2 |n|^2)
    ab2 = float(ab @ ab)
    ac2 = np.einsum("ij,ij->i", ac, ac)
    cc = pa + (ac2[:, None] * np.cross(n, ab) + ab2 * np.cross(ac, n)) \
        / (2.0 * n2s[:, None])
    rc2 = np.einsum("ij,ij->i", cc - pa, cc - pa)
    h2 = r * r - rc2
    ok &= h2 > 0.0
    nn = n / np.sqrt(n2s)[:, None]
    flip = np.einsum("ij,ij->i", nn, n_hint) < 0.0
    nn = np.where(flip[:, None], -nn, nn)
    centers = cc + np.sqrt(np.where(ok, h2, 0.0))[:, None] * nn
    return centers, ok, nn


def _edge_key(u: int, v: int):
    return (u, v) if u < v else (v, u)


def ball_pivot(points: np.ndarray, normals: np.ndarray,
               radii: Sequence[float] = (0.005, 0.01, 0.02, 0.04),
               max_triangles: int = 2_000_000) -> np.ndarray:
    """Ball-pivoting triangulation of an oriented point cloud.

    Returns int32 triangles (T,3) indexing ``points``, wound so triangle
    normals agree with the vertex normals (Open3D BPA convention). Points
    the ladder's balls never reach stay unreferenced — BPA interpolates, it
    never invents or moves vertices.
    """
    points = np.ascontiguousarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    n_pts = len(points)
    if n_pts < 3:
        return np.zeros((0, 3), np.int32)

    triangles: list = []
    edge_tris: dict = {}  # undirected edge -> number of adjacent triangles
    used = np.zeros(n_pts, bool)  # vertex is part of some triangle
    # front entries: (i, j, opposite, ball_center); boundary edges that
    # failed a radius are retried (center recomputed) at the next rung
    boundary: list = []
    EPS = 1e-7

    def emit(a: int, b: int, c: int) -> None:
        triangles.append((a, b, c))
        for u, v in ((a, b), (b, c), (c, a)):
            k = _edge_key(u, v)
            edge_tris[k] = edge_tris.get(k, 0) + 1
        used[a] = used[b] = used[c] = True

    for r in radii:
        grid = _CellGrid(points, 2.0 * r)
        front: deque = deque()

        def try_seed(i: int) -> bool:
            """Seed triangle at an unused point: among its 2r-neighbors,
            take the first pair whose r-ball (on the normal side) is empty."""
            cand = grid.query(points[i], 2.0 * r)
            cand = cand[(cand != i) & ~used[cand]]
            if len(cand) < 2:
                return False
            d2 = np.einsum("ij,ij->i", points[cand] - points[i],
                           points[cand] - points[i])
            cand = cand[np.argsort(d2)][:12]  # nearest-first, bounded pairs
            for ai, j in enumerate(cand):
                ks = cand[ai + 1:]
                if not len(ks):
                    continue
                hint = normals[i] + normals[j] + normals[ks]
                centers, ok, _ = _ball_centers(points[i], points[j],
                                               points[ks], r, hint)
                for w in np.flatnonzero(ok):
                    c = centers[w]
                    near = grid.query(c, r - EPS)
                    keep = np.array([i, j, ks[w]])
                    if len(np.setdiff1d(near, keep, assume_unique=False)):
                        continue
                    k = int(ks[w])
                    # wind so the face normal matches the vertex normals
                    fn = np.cross(points[j] - points[i], points[k] - points[i])
                    if fn @ (normals[i] + normals[j] + normals[k]) < 0:
                        j2, k2 = k, int(j)
                    else:
                        j2, k2 = int(j), k
                    emit(i, j2, k2)
                    front.append((i, j2, k2, c))
                    front.append((j2, k2, i, c))
                    front.append((k2, i, j2, c))
                    return True
            return False

        def pivot(i: int, j: int, o: int, c_old: np.ndarray):
            """Roll the ball over directed front edge (i->j) (triangle on
            the (i,j,o) side): return (k, center) of the first point hit, or
            None. Candidates must keep both new edges manifold."""
            pi, pj = points[i], points[j]
            m = 0.5 * (pi + pj)
            cand = grid.query(m, 2.0 * r)
            cand = cand[(cand != i) & (cand != j) & (cand != o)]
            if not len(cand):
                return None
            man = np.fromiter((edge_tris.get(_edge_key(i, int(k)), 0) < 2
                               and edge_tris.get(_edge_key(j, int(k)), 0) < 2
                               for k in cand), bool, len(cand))
            cand = cand[man]
            if not len(cand):
                return None
            hint = normals[i] + normals[j] + normals[cand]
            centers, ok, tnrm = _ball_centers(pi, pj, points[cand], r, hint)
            # the new triangle (j, i, k) must face WITH the vertex normals —
            # rejecting fold-backs keeps the front from wrapping onto itself
            fn = np.cross(pi - pj, points[cand] - pj)
            ok &= np.einsum("ij,ij->i", fn, hint) > 0.0
            if not ok.any():
                return None
            # pivot angle: rotation of the ball center around the edge axis,
            # starting at the CURRENT center, in the direction away from the
            # existing triangle. Smallest angle = first point touched.
            e = pj - pi
            e = e / np.linalg.norm(e)
            v0 = c_old - m
            v0 = v0 - (v0 @ e) * e
            v0n = np.linalg.norm(v0)
            if v0n < 1e-12:
                return None
            v0 = v0 / v0n
            v1 = centers - m
            v1 = v1 - (v1 @ e)[:, None] * e[None]
            sin = np.cross(np.broadcast_to(v0, v1.shape), v1) @ e
            cos = v1 @ v0
            theta = np.arctan2(sin, cos)
            # direction convention: with the edge directed i->j by the CCW
            # winding of the OLD triangle (i,j,o), rolling the ball over the
            # edge away from o sweeps POSITIVE angle around e (right-hand
            # rule; derived from cross(pj-pi, po-pi) being the outward
            # normal). theta ~ 0 is the old position itself — a candidate
            # there comes from behind, so it maps to a full 2-pi sweep.
            theta = np.where(theta <= 1e-9, theta + 2.0 * np.pi, theta)
            theta = np.where(ok, theta, np.inf)  # smallest sweep touches first
            for w in np.argsort(theta):
                if not np.isfinite(theta[w]):
                    break
                c = centers[w]
                near = grid.query(c, r - EPS)
                keep = np.array([i, j, cand[w]])
                if len(np.setdiff1d(near, keep)):
                    continue
                return int(cand[w]), c
            return None

        # re-arm the previous rung's boundary edges with this radius's ball
        for (i, j, o) in boundary:
            if edge_tris.get(_edge_key(i, j), 0) != 1:
                continue
            hint = normals[i] + normals[j] + normals[o]
            centers, ok, _ = _ball_centers(points[i], points[j],
                                           points[o][None], r, hint[None])
            if ok[0]:
                front.append((i, j, o, centers[0]))
        boundary = []

        seed_scan = 0  # resume position: each point seeds at most once/rung
        while len(triangles) < max_triangles:
            while front:
                i, j, o, c_old = front.popleft()
                if edge_tris.get(_edge_key(i, j), 0) != 1:
                    continue  # stale: a pivot from elsewhere closed it
                hit = pivot(i, j, o, c_old)
                if hit is None:
                    boundary.append((i, j, o))
                    continue
                k, c = hit
                emit(j, i, k)
                for (u, v, w) in ((i, k, j), (k, j, i)):
                    if edge_tris.get(_edge_key(u, v), 0) == 1:
                        front.append((u, v, w, c))
                if len(triangles) >= max_triangles:
                    break
            # front exhausted: seed the next connected component
            while seed_scan < n_pts and (used[seed_scan]
                                         or not try_seed(seed_scan)):
                seed_scan += 1
            if not front:
                break
        log_info(f"ball_pivot r={r}: {len(triangles)} triangles, "
                 f"{len(boundary)} boundary edges")

    return np.asarray(triangles, np.int32).reshape(-1, 3)


def ball_pivot_mesh(cloud: PointCloudHost,
                    radii: Sequence[float] = (0.005, 0.01, 0.02, 0.04)
                    ) -> Optional[TriangleMeshHost]:
    """BPA mesh of an oriented cloud (first-party twin of Open3D
    ``create_from_point_cloud_ball_pivoting`` as the reference calls it,
    PointCloudToMesh.py:139-148). Requires normals (the callers' preprocess
    always estimates them); returns None on unusable input."""
    if len(cloud) < 3:
        return None
    if cloud.normals is None:
        log_warning("ball_pivot_mesh: cloud has no normals; estimate them "
                    "first (ops.neighbors.estimate_normals_knn)")
        return None
    tris = ball_pivot(cloud.points, cloud.normals, radii=radii)
    if not len(tris):
        return None
    return TriangleMeshHost(vertices=np.asarray(cloud.points, np.float32),
                            triangles=tris,
                            vertex_colors=cloud.colors,
                            vertex_normals=np.asarray(cloud.normals,
                                                      np.float32))
