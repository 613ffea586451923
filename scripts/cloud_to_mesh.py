#!/usr/bin/env python
"""Standalone PLY -> mesh converter.

Entry-point parity: reference CodeThatKindaWorks/PointCloudToMesh.py —
preprocess (downsample + outlier removal + normals) then Poisson with
density-quantile culling, falling back to ball pivoting. Poisson delegates
to Open3D when installed; ``--method ballpivot`` runs the first-party BPA
(meshing/ball_pivot.py) without it, and ``--method sdf`` the first-party
oriented-point SDF-splat mesher (meshing/sdf_mesh.py) — no Open3D required
for either.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import jax
import jax.numpy as jnp
import numpy as np

from azurekinect3dreconstruction_tpu.core.types import PointCloudHost
from azurekinect3dreconstruction_tpu.meshing.poisson import mesh_with_fallback
from azurekinect3dreconstruction_tpu.ops.neighbors import (
    estimate_normals_knn,
    remove_statistical_outliers,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu.utils.telemetry import log_error, log_info
from azurekinect3dreconstruction_tpu.viz.savers import read_ply, write_ply_mesh


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="input .ply point cloud")
    ap.add_argument("output", nargs="?", default=None, help="output .ply mesh")
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--depth", type=int, default=9, help="Poisson depth")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "poisson", "ballpivot", "sdf"],
                    help="auto = Poisson -> ball-pivot -> sdf fallback chain")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU JAX backend (an offline converter "
                         "whose eager preprocessing gains little from the "
                         "GPU)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    verts, cols, _ = read_ply(args.input)
    if verts is None or not len(verts):
        log_error(f"no points in {args.input}")
        raise SystemExit(1)
    n = verts.shape[0]
    log_info(f"loaded {n} points")

    mask = jnp.ones((n,), bool)
    dp, dm, dc, _ = voxel_downsample_arrays(
        jnp.asarray(verts), mask, args.voxel, 1 << max(12, (n - 1).bit_length()),
        colors=None if cols is None else jnp.asarray(cols))
    dm = remove_statistical_outliers(dp, dm, k=16, radius=3 * args.voxel)
    centroid = verts.mean(0) + np.array([0, 0, -2.0], np.float32)
    nr = estimate_normals_knn(dp, dm, radius=3 * args.voxel, k=16, orient_to=centroid)
    m = np.asarray(dm)
    cloud = PointCloudHost(points=np.asarray(dp)[m],
                           colors=None if dc is None else np.asarray(dc)[m],
                           normals=np.asarray(nr)[m])
    log_info(f"preprocessed -> {len(cloud)} points")

    if args.method == "sdf":
        from azurekinect3dreconstruction_tpu.meshing.sdf_mesh import (
            sdf_mesh_from_cloud,
        )

        mesh = sdf_mesh_from_cloud(cloud, voxel=args.voxel)
    elif args.method == "poisson":
        from azurekinect3dreconstruction_tpu.meshing.poisson import (
            poisson_mesh_from_cloud,
        )

        mesh = poisson_mesh_from_cloud(cloud, depth=args.depth)
    elif args.method == "ballpivot":
        from azurekinect3dreconstruction_tpu.meshing.poisson import (
            ball_pivot_mesh_from_cloud,
        )

        mesh = ball_pivot_mesh_from_cloud(cloud)
    else:
        mesh = mesh_with_fallback(cloud, voxel=args.voxel, depth=args.depth)
    if mesh is None:
        log_error("meshing failed; wrote nothing")
        raise SystemExit(1)
    out = args.output or args.input.replace(".ply", "_mesh.ply")
    write_ply_mesh(out, mesh)
    log_info(f"wrote {out} ({mesh.triangles.shape[0]} triangles)")


if __name__ == "__main__":
    main()
