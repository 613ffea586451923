#!/usr/bin/env python
"""Hardware / environment smoke test.

Entry-point parity: reference CodeThatKindaWorks/test_device.py (start device,
print color/depth/transformed_depth shapes) + checktorch.py (accelerator
probe). Without a camera it reports the synthetic backend shapes and the JAX
device, so the smoke test is meaningful on GPU hosts too.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", default="auto", help="auto | k4a | synthetic")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU JAX backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    print(f"[INFO] jax backend: {jax.default_backend()}, devices: {jax.devices()}")

    from azurekinect3dreconstruction_tpu.io import k4a_live

    if args.source in ("auto", "k4a") and k4a_live.is_available():
        ids = k4a_live.detect_cameras()
        print(f"[INFO] k4a devices: {ids}")
        if ids:
            src = k4a_live.K4ALiveSource(ids[0])
            d, c = next(src.frames())
            print(f"[INFO] depth {d.shape} {d.dtype}; color {c.shape} {c.dtype}")
            src.stop()
            return
    print("[INFO] no camera; exercising the synthetic backend")
    from azurekinect3dreconstruction_tpu.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera

    cam = SyntheticCamera(intrinsics=Intrinsics.azure_kinect_depth_nfov())
    d, c = cam.capture()
    print(f"[INFO] depth {d.shape} {d.dtype} (max {d.max()}mm); "
          f"color {c.shape} {c.dtype}")
    import jax.numpy as jnp

    x = jnp.ones((256, 256))
    print(f"[INFO] device matmul OK: {float((x @ x).sum())}")


if __name__ == "__main__":
    main()
