"""azurekinect3dreconstruction_tpu — an accelerator-resident RGB-D 3D reconstruction framework.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the
mishn-0/AzureKinect3DReconstruction reference stack (pyk4a + Open3D + OpenCV):

- k4a camera models (intrinsics, Brown–Conrady distortion, depth→color registration)
- depth→point-cloud backprojection, voxel downsampling, normal estimation
- hybrid photometric+geometric RGB-D odometry (Gauss–Newton, image pyramids)
- point-to-plane / colored ICP with projective data association
- FPFH features + massively-parallel RANSAC global registration
- block-hashed scalable TSDF volume resident in device memory, worklist integrate
- marching-cubes mesh extraction with generated (not hand-typed) case tables
- pose-graph optimization with loop closure (offline "BundleFusion-style" mode)
- two-camera extrinsic auto-calibration and fusion
- npz/framelog record & replay, PLY/OBJ persistence, optional Open3D viewers

The public API mirrors the reference's de-facto layer map (SURVEY.md §1) but is
organized as a real package. Heavy math runs on the GPU via jnp/XLA; host-side
runtime (IO, ring buffers, mesh serialization) has native C++ implementations
with pure-Python fallbacks.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def _cpu_fingerprint() -> str:
    """Short stable hash of this host's CPU ISA feature flags (the thing
    XLA:CPU AOT code is specialized to)."""
    import hashlib
    import platform as _platform

    feats = _platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats += " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return hashlib.sha1(feats.encode()).hexdigest()[:12]


def _enable_compilation_cache() -> None:
    """Persist compiled executables across processes, so the heavy steps
    compile once per machine, not once per script run. Uses
    JAX_COMPILATION_CACHE_DIR (or a cache dir already configured) when set,
    and otherwise the fixed ``<checkout>/.jax_cache`` (the path is part of
    the cache key, so it must not move). Embedding applications that manage
    their own JAX cache policy can opt out of this import-time side effect
    entirely with ``AZK3D_NO_CACHE_SETUP=1``."""
    try:
        if _os.environ.get("AZK3D_NO_CACHE_SETUP"):
            return
        if _jax.config.jax_compilation_cache_dir:
            return
        root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
        cache = _os.path.join(root, ".jax_cache")
        plats = (_os.environ.get("JAX_PLATFORMS")
                 or getattr(_jax.config, "jax_platforms", None) or "")
        if "cpu" in plats:
            # XLA:CPU persists AOT machine code compiled for THIS host's exact
            # CPU feature set; loading another host's entries trips
            # cpu_aot_loader "machine type doesn't match" warnings and risks
            # SIGILL (observed when the cache dir travels with the repo).
            # Partition CPU entries per feature fingerprint so a different
            # host starts a fresh subdir instead of loading foreign code.
            cache = _os.path.join(cache, "cpu-" + _cpu_fingerprint())
        _os.makedirs(cache, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", cache)
        # Persist SMALL compiles too. jax's default refuses to cache
        # anything that compiled in under 1 s, but a warmup ladder of ~250
        # small executables (relocalizer rungs, bucket ladder) adds up to
        # minutes of compiles that each duck the threshold and are never
        # written. 0.0 persists everything; disk cost is a few hundred
        # ~100 KB files.
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except Exception:
        pass  # caching is an optimization; never block import on it


_enable_compilation_cache()

from azurekinect3dreconstruction_tpu.config import (
    CameraConfig,
    OdometryConfig,
    PipelineConfig,
    RegistrationConfig,
    TSDFConfig,
)

__all__ = [
    "CameraConfig",
    "OdometryConfig",
    "PipelineConfig",
    "RegistrationConfig",
    "TSDFConfig",
    "__version__",
]
