"""Test harness: force CPU with 8 virtual devices so multi-device sharding
paths are exercised without a GPU. Must run before the first jax import.

The tests run on the CPU; what only the card can run is a phase of
``chip_smoke.py`` (``python chip_smoke.py`` on a GPU host)."""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# set the config too, in case something imported jax before the env var
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_runtest_teardown(item, nextitem):
    """XLA:CPU JIT leaves thousands of code/data mappings per large compiled
    executable, all held alive by jax's executable caches; a full-suite
    process crosses the kernel's vm.max_map_count (65530) at ~94% of the
    run and dies with SIGSEGV inside the next compile's mmap (observed
    three times before this hook existed — always at the same test, always
    inside compilation_cache deserialization). Clearing jax's caches when
    the map count gets crowded returns the process to baseline (measured:
    6111 -> 523 maps) at the cost of recompiling whatever later tests
    reuse. One /proc/self/maps line count per test is ~free."""
    from azurekinect3dreconstruction_tpu.utils.telemetry import (
        release_jit_maps_if_crowded,
    )

    release_jit_maps_if_crowded()


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope="session")
def synthetic_camera():
    from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera

    # Small image keeps CPU tests fast; geometry is resolution-independent.
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    return SyntheticCamera(intrinsics=intr)
