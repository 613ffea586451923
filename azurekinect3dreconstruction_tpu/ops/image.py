"""Image-space ops: color conversion, flips, pyramids, gradients.

Replaces the reference's OpenCV calls — ``cv2.cvtColor(BGRA->RGB)`` and
``cv2.flip`` (reference CodeThatWorks/GoodColorReconstruction.py:127-128,
bundlefusionattemps/bundlefusion_reconstruction.py:67-101) — with trivially
fusable jnp ops, plus the Gaussian pyramid / Scharr gradients the RGB-D
odometry needs (Open3D builds these inside compute_rgbd_odometry; here they
are explicit and jit-compiled once per resolution).
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp


def bgra_to_rgb(img):
    """uint8 BGRA (H, W, 4) -> float32 RGB in [0, 1]."""
    img = jnp.asarray(img)
    return img[..., 2::-1].astype(jnp.float32) / 255.0


def flip_ud(img):
    """Vertical flip — the reference's cv2.flip(-1)/flip transform family."""
    return jnp.asarray(img)[::-1]


def rgb_to_intensity(rgb):
    rgb = jnp.asarray(rgb)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


# Pyramid/gradient glue is SHIFT-ADD f32, not conv_general_dilated: the
# shifted-slice form is exact f32, fuses into its consumers, and keeps the
# matrix units out of what is a bandwidth-bound stencil.


def _gauss_blur(img):
    """Separable 5-tap binomial blur (1 4 6 4 1)/16, edge-clamped."""
    if img.ndim != 2:  # color stacks: blur channels independently
        return jnp.stack([_gauss_blur(img[..., c])
                          for c in range(img.shape[-1])], axis=-1)
    x = jnp.pad(img, ((2, 2), (0, 0)), mode="edge")
    x = ((x[:-4] + x[4:]) + 4.0 * (x[1:-3] + x[3:-1]) + 6.0 * x[2:-2]) / 16.0
    x = jnp.pad(x, ((0, 0), (2, 2)), mode="edge")
    x = ((x[:, :-4] + x[:, 4:]) + 4.0 * (x[:, 1:-3] + x[:, 3:-1])
         + 6.0 * x[:, 2:-2]) / 16.0
    return x


def downsample2(img):
    """Blur + 2x decimation (intensity images)."""
    return _gauss_blur(img)[::2, ::2]


def downsample2_depth(depth):
    """Depth-aware 2x decimation: plain subsampling (no blending across
    depth discontinuities — blurring depth invents phantom surfaces)."""
    d = jnp.asarray(depth)
    h, w = d.shape
    if h % 2 or w % 2:  # odd extents: keep the strided form (trace-time branch)
        return d[::2, ::2]
    # even extents (every sensor mode): reshape + unit-stride slice instead of
    # a 2-strided gather — the reshape is a free layout change
    return d.reshape(h // 2, 2, w // 2, 2)[:, 0, :, 0]


def build_pyramid(intensity, depth, levels: int) -> List[Tuple[jax.Array, jax.Array]]:
    """[(intensity, depth)] from finest (level 0) to coarsest."""
    out = [(intensity, depth)]
    for _ in range(levels - 1):
        intensity = downsample2(intensity)
        depth = downsample2_depth(depth)
        out.append((intensity, depth))
    return out


def sobel_gradients(img):
    """(dI/du, dI/dv) with Sobel/8 (matches Open3D's odometry gradient scale).

    Edge pixels are zero (gradient undefined there); invalid regions are the
    caller's concern via masks.
    """
    p = jnp.pad(jnp.asarray(img), ((1, 1), (1, 1)), mode="edge")
    # separable: smooth (1 2 1) along one axis, central-difference the other
    sv = p[:-2] + 2.0 * p[1:-1] + p[2:]           # (H, W+2) row-smoothed
    gx = (sv[:, 2:] - sv[:, :-2]) / 8.0
    su = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]  # (H+2, W) col-smoothed
    gy = (su[2:] - su[:-2]) / 8.0
    return gx, gy


def depth_gradient_colors(depth, near=0.5, far=3.0, mode: str = "turbo"):
    """Depth -> RGB gradient coloring, the reference's depth-visualization
    modes (apply_depth_colors, reference CreateMesh.py:685-721; cv2 JET/TURBO
    colormaps at azure-kinect-DK/Reconstruction/3Dreconstruction.py:178-215).
    """
    d = jnp.asarray(depth)
    t = jnp.clip((d - near) / (far - near), 0.0, 1.0)
    if mode == "gray":
        return jnp.stack([1.0 - t] * 3, axis=-1)
    # compact turbo-like ramp: blue -> cyan -> green -> yellow -> red
    r = jnp.clip(1.5 - jnp.abs(4.0 * t - 3.0), 0.0, 1.0)
    g = jnp.clip(1.5 - jnp.abs(4.0 * t - 2.0), 0.0, 1.0)
    b = jnp.clip(1.5 - jnp.abs(4.0 * t - 1.0), 0.0, 1.0)
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.where((d > 0)[..., None], rgb, 0.0)
