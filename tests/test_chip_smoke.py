"""chip_smoke.py off the card: it must refuse to report a result without a
GPU, and each of its phases must pass at tiny shapes on the CPU (the same
code the card runs at full width). Also the compile-cache location the
package picks at import, which chip runs rely on to find earlier work."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

from azurekinect3dreconstruction_tpu.config import OdometryConfig  # noqa: E402
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics  # noqa: E402

TINY_POOL = dict(block_capacity=1024, hash_capacity=4096)


@pytest.fixture(scope="module")
def tiny():
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    cfg = chip_smoke.smoke_tsdf_config(voxel=0.01, **TINY_POOL)
    frames, gt = chip_smoke.orbit_frames(intr, 6)
    return intr, cfg, frames, gt


def _env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_chip_smoke_refuses_without_gpu():
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env=_env())
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_phase_main_path_tiny(tiny):
    intr, cfg, frames, gt = tiny
    ok, info = chip_smoke.phase_main_path(intr, cfg, frames, gt)
    assert ok, info
    assert info["odo_ok"] == len(frames) - 1 and info["triangles"] > 0


def test_phase_integrate_parity_tiny(tiny):
    intr, cfg, frames, gt = tiny
    ok, info = chip_smoke.phase_integrate_parity(intr, cfg, frames, gt, n=4,
                                                 worklist_size=512)
    assert ok, info
    # on the CPU the two forms agree exactly
    assert info["weight_equal_frac"] == 1.0
    assert info["max_abs_dtsdf"] == 0.0 and info["max_abs_dcolor"] == 0.0


def test_phase_odometry_tiny(tiny):
    intr, _, frames, _ = tiny
    ok, info = chip_smoke.phase_odometry(intr, OdometryConfig(), frames,
                                         reps=1)
    assert ok, info


def test_phase_streaming_tiny(tiny):
    intr, cfg, frames, gt = tiny
    ok, info = chip_smoke.phase_streaming(intr, cfg, frames, gt, n=3,
                                          n_evict=16)
    assert ok, info
    assert info["evicted"] == 16


def test_phase_multi_tiny():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    ok, info = chip_smoke.phase_multi(intr, n_pairs=2, voxel=0.02)
    assert ok, info
    # on the CPU the sharded step and the sequential reference agree exactly
    assert info["weight_equal_frac"] == 1.0
    assert info["max_abs_dtsdf"] == 0.0 and info["max_abs_dcolor"] == 0.0
    assert info["centroid_overlap_on_0p1mm_grid"] == 1.0


@pytest.mark.parametrize("set_dir", [True, False])
def test_compile_cache_dir(tmp_path, set_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    the fixed <checkout>/.jax_cache (partitioned per host CPU on the CPU
    backend)."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if set_dir else {}
    env = _env(**extra)
    if not set_dir:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
    code = ("import json, jax, azurekinect3dreconstruction_tpu\n"
            "print(json.dumps(jax.config.jax_compilation_cache_dir))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    if set_dir:
        assert got == str(tmp_path)
    else:
        assert os.path.dirname(got) == os.path.join(REPO, ".jax_cache")
