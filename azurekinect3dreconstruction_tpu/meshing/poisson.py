"""Host-side surface meshing from point clouds: Poisson + ball pivoting.

The reference meshes saved clouds with Open3D's Poisson reconstruction
(depth 9, density-quantile culling) falling back to ball pivoting
(reference CreateMesh.py:32-70, CodeThatKindaWorks/PointCloudToMesh.py:6-119,
BetterVisualizerD2camerasWorks1Cam.py:426-444). Poisson's octree solver is
not accelerator-shaped (SURVEY.md §7.3), so it stays a host-side Open3D delegate;
ball pivoting has a first-party implementation (meshing.ball_pivot) that
this module falls back to when Open3D is absent. The TSDF -> marching-cubes
path is the framework's primary mesher (it is what the reference's "works"
pipelines actually render).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from azurekinect3dreconstruction_tpu.core.types import PointCloudHost, TriangleMeshHost
from azurekinect3dreconstruction_tpu.utils.telemetry import log_warning


def _o3d():
    try:
        import open3d as o3d  # noqa

        return o3d
    except ImportError:
        return None


def _to_o3d_cloud(cloud: PointCloudHost):
    o3d = _o3d()
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(cloud.points.astype(np.float64))
    if cloud.colors is not None:
        pcd.colors = o3d.utility.Vector3dVector(cloud.colors.astype(np.float64))
    if cloud.normals is not None:
        pcd.normals = o3d.utility.Vector3dVector(cloud.normals.astype(np.float64))
    return pcd


def _from_o3d_mesh(mesh) -> TriangleMeshHost:
    return TriangleMeshHost(
        vertices=np.asarray(mesh.vertices, np.float32),
        triangles=np.asarray(mesh.triangles, np.int32),
        vertex_colors=(np.asarray(mesh.vertex_colors, np.float32)
                       if len(mesh.vertex_colors) else None),
    )


def poisson_mesh_from_cloud(cloud: PointCloudHost, depth: int = 9,
                            density_quantile: float = 0.01
                            ) -> Optional[TriangleMeshHost]:
    """Poisson reconstruction + density-quantile culling (reference
    CreateMesh.py:414-461 runs Poisson twice; here once, reusing densities).
    Returns None when Open3D is unavailable or the cloud is unusable."""
    o3d = _o3d()
    if o3d is None:
        log_warning("open3d not installed; Poisson meshing unavailable "
                    "(use the TSDF marching-cubes mesher)")
        return None
    if len(cloud) < 100:
        return None
    pcd = _to_o3d_cloud(cloud)
    if cloud.normals is None:
        pcd.estimate_normals()
        pcd.orient_normals_consistent_tangent_plane(30)
    mesh, densities = o3d.geometry.TriangleMesh.create_from_point_cloud_poisson(
        pcd, depth=depth)
    densities = np.asarray(densities)
    keep = densities >= np.quantile(densities, density_quantile)
    mesh.remove_vertices_by_mask(~keep)
    return _from_o3d_mesh(mesh)


def ball_pivot_mesh_from_cloud(cloud: PointCloudHost,
                               radii=(0.005, 0.01, 0.02, 0.04)
                               ) -> Optional[TriangleMeshHost]:
    """Ball pivoting with the reference's radius ladder
    (CodeThatKindaWorks/PointCloudToMesh.py:146). Uses Open3D's BPA when it
    is installed (byte-parity with what the reference ran), otherwise the
    first-party implementation (meshing.ball_pivot) — the capability itself
    no longer depends on Open3D."""
    if len(cloud) < 100:
        return None
    o3d = _o3d()
    if o3d is None:
        from azurekinect3dreconstruction_tpu.meshing.ball_pivot import (
            ball_pivot_mesh,
        )

        if cloud.normals is None:
            from azurekinect3dreconstruction_tpu.ops.neighbors import (
                estimate_normals_knn,
            )
            import jax.numpy as jnp

            n = estimate_normals_knn(
                jnp.asarray(cloud.points), jnp.ones((len(cloud),), bool),
                radius=3 * float(radii[0]), k=16,
                orient_to=cloud.points.mean(0) + np.array([0, 0, -2.0]))
            cloud = PointCloudHost(points=cloud.points, colors=cloud.colors,
                                   normals=np.asarray(n))
        return ball_pivot_mesh(cloud, radii=radii)
    pcd = _to_o3d_cloud(cloud)
    if cloud.normals is None:
        pcd.estimate_normals()
    mesh = o3d.geometry.TriangleMesh.create_from_point_cloud_ball_pivoting(
        pcd, o3d.utility.DoubleVector(list(radii)))
    return _from_o3d_mesh(mesh)


def mesh_with_fallback(cloud: PointCloudHost, voxel: float = 0.01,
                       **kw) -> Optional[TriangleMeshHost]:
    """Poisson -> ball-pivot -> first-party SDF-splat fallback chain (the
    reference chains Poisson -> ball-pivot,
    BetterVisualizerD2camerasWorks1Cam.py:426-444; the SDF mesher makes the
    capability Open3D-free)."""
    mesh = poisson_mesh_from_cloud(cloud, **kw)
    if mesh is None or mesh.triangles.shape[0] == 0:
        # chain policy: the first-party BPA's advancing front is a host
        # Python loop — sound at export scale but not on a huge un-culled
        # cloud, where the SDF-splat mesher (one batched device pass) is
        # the better automatic fallback. Explicit --method ballpivot
        # bypasses this cap.
        if _o3d() is not None or len(cloud) <= 60000:
            mesh = ball_pivot_mesh_from_cloud(cloud)
        else:
            log_warning(f"fallback chain: skipping first-party ball pivot "
                        f"({len(cloud)} points > 60k); using the SDF mesher")
    if mesh is None or mesh.triangles.shape[0] == 0:
        from azurekinect3dreconstruction_tpu.meshing.sdf_mesh import (
            sdf_mesh_from_cloud,
        )

        mesh = sdf_mesh_from_cloud(cloud, voxel=voxel)
    return mesh
