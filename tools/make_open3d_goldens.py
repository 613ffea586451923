"""Generate Open3D golden fixtures for tests/golden/*.npz.

Run this ONCE in any environment with open3d installed (it is not available
in the CI image):

    python tools/make_open3d_goldens.py

and commit the resulting ``tests/golden/*.npz``. Each fixture stores both
the INPUTS (rendered deterministically here and frozen into the file — the
test never re-renders) and Open3D's OUTPUT, so ``tests/test_golden_open3d.py``
can assert parity against the real Open3D C++ implementations (the
reference's actual behavior: odometry CodeThatWorks/1camera-detectsScene
Changes.py:243-248, ScalableTSDFVolume CreateMesh.py:300-336, FPFH
CreateMesh.py:214-217) without importing open3d.

Goldens:
- odometry_pair.npz: intensity/depth pair + compute_rgbd_odometry (Hybrid)
  4x4 transform.
- tsdf_mesh.npz: frames + poses + ScalableTSDFVolume mesh vertices.
- fpfh_cloud.npz: points + normals + FPFH descriptors.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "golden")


def main():
    import open3d as o3d

    from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu.core import se3
    from azurekinect3dreconstruction_tpu.io.synthetic import (
        SyntheticCamera,
        orbit_trajectory,
    )

    os.makedirs(OUT, exist_ok=True)
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    cam = SyntheticCamera(intrinsics=intr)
    o3d_intr = o3d.camera.PinholeCameraIntrinsic(
        intr.width, intr.height, intr.fx, intr.fy, intr.cx, intr.cy)

    def rgbd(z, c):
        color = o3d.geometry.Image((np.asarray(c) * 255).astype(np.uint8))
        depth = o3d.geometry.Image((np.asarray(z) * 1000).astype(np.uint16))
        return o3d.geometry.RGBDImage.create_from_color_and_depth(
            color, depth, depth_scale=1000.0, depth_trunc=3.0,
            convert_rgb_to_intensity=False)

    # ---- odometry golden ---------------------------------------------------
    import jax.numpy as jnp

    T0 = np.eye(4, dtype=np.float32)
    T1 = np.asarray(se3.se3_exp(jnp.asarray(
        [0.01, -0.006, 0.008, 0.012, -0.01, 0.008], jnp.float32)), np.float32)
    z0, c0 = cam.render(T0)
    z1, c1 = cam.render(T1)
    ok, T, _info = o3d.pipelines.odometry.compute_rgbd_odometry(
        rgbd(z0, c0), rgbd(z1, c1), o3d_intr, np.eye(4),
        o3d.pipelines.odometry.RGBDOdometryJacobianFromHybridTerm(),
        o3d.pipelines.odometry.OdometryOption())
    assert ok
    np.savez_compressed(
        os.path.join(OUT, "odometry_pair.npz"),
        depth0=np.asarray(z0, np.float32), color0=np.asarray(c0, np.float32),
        depth1=np.asarray(z1, np.float32), color1=np.asarray(c1, np.float32),
        intrinsics=np.array([intr.width, intr.height, intr.fx, intr.fy,
                             intr.cx, intr.cy]),
        T_true=np.asarray(T1),
        T_o3d=np.asarray(T, np.float64),
    )
    print("odometry golden:", np.asarray(T)[:3, 3])

    # ---- TSDF mesh golden --------------------------------------------------
    voxel = 0.02
    vol = o3d.pipelines.integration.ScalableTSDFVolume(
        voxel_length=voxel, sdf_trunc=4 * voxel,
        color_type=o3d.pipelines.integration.TSDFVolumeColorType.RGB8)
    poses = orbit_trajectory(4, radius=0.25, angle_span=0.6)
    frames = []
    for T in poses:
        z, c = cam.render(np.asarray(T, np.float32))
        frames.append((np.asarray(z, np.float32), np.asarray(c, np.float32)))
        # o3d integrate takes world->camera
        vol.integrate(rgbd(*frames[-1]), o3d_intr,
                      np.linalg.inv(np.asarray(T, np.float64)))
    mesh = vol.extract_triangle_mesh()
    np.savez_compressed(
        os.path.join(OUT, "tsdf_mesh.npz"),
        depths=np.stack([f[0] for f in frames]),
        colors=np.stack([f[1] for f in frames]),
        poses=np.stack([np.asarray(T, np.float64) for T in poses]),
        intrinsics=np.array([intr.width, intr.height, intr.fx, intr.fy,
                             intr.cx, intr.cy]),
        voxel=np.float64(voxel),
        vertices=np.asarray(mesh.vertices, np.float32),
        triangles=np.asarray(mesh.triangles, np.int32),
    )
    print("tsdf golden:", len(mesh.vertices), "vertices")

    # ---- FPFH golden -------------------------------------------------------
    z, c = cam.render(np.eye(4, dtype=np.float32))
    from azurekinect3dreconstruction_tpu.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu.ops.backproject import backproject_depth

    pts = np.asarray(backproject_depth(jnp.asarray(z), pixel_rays(intr))
                     ).reshape(-1, 3)
    pts = pts[pts[:, 2] > 0][::16][:2000].astype(np.float64)
    pcd = o3d.geometry.PointCloud(o3d.utility.Vector3dVector(pts))
    pcd.estimate_normals(o3d.geometry.KDTreeSearchParamRadius(0.06))
    pcd.orient_normals_towards_camera_location(np.zeros(3))
    fpfh = o3d.pipelines.registration.compute_fpfh_feature(
        pcd, o3d.geometry.KDTreeSearchParamRadius(0.1))
    np.savez_compressed(
        os.path.join(OUT, "fpfh_cloud.npz"),
        points=np.asarray(pcd.points, np.float32),
        normals=np.asarray(pcd.normals, np.float32),
        fpfh=np.asarray(fpfh.data, np.float64).T,  # (N, 33)
    )
    print("fpfh golden:", np.asarray(fpfh.data).shape)


if __name__ == "__main__":
    main()
