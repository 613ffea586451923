"""Image-op semantics: the shift-add forms (ops/image.py) must match the
plain padded-sum definitions written out longhand here.

The pyramid/gradient ops are shifted-slice/add chains rather than native
``conv_general_dilated`` calls (ops/image.py says why). These tests anchor
those numerics to the
original longhand definitions (reference behavior: the pyramid/gradient
stack inside Open3D's compute_rgbd_odometry, used at
/root/reference/CodeThatWorks/1camera-detectsSceneChanges.py:243-248).
"""

import numpy as np
import pytest

from azurekinect3dreconstruction_tpu.ops.image import (
    _gauss_blur,
    build_pyramid,
    downsample2,
    downsample2_depth,
    sobel_gradients,
)


def _blur_ref(img):
    """Edge-clamped separable 5-tap binomial blur — the original form."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    p = np.pad(img, ((2, 2), (0, 0)), mode="edge")
    img = sum(k[i] * p[i : i + img.shape[0]] for i in range(5))
    p = np.pad(img, ((0, 0), (2, 2)), mode="edge")
    return sum(k[i] * p[:, i : i + img.shape[1]] for i in range(5))


def _sobel_ref(img):
    """Edge-clamped Sobel/8 — the original shifted-slice form."""
    p = np.pad(img, ((1, 1), (1, 1)), mode="edge")
    gx = ((p[0:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
          - (p[0:-2, 0:-2] + 2 * p[1:-1, 0:-2] + p[2:, 0:-2])) / 8.0
    gy = ((p[2:, 0:-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
          - (p[0:-2, 0:-2] + 2 * p[0:-2, 1:-1] + p[0:-2, 2:])) / 8.0
    return gx, gy


@pytest.fixture(scope="module")
def img(rng):
    return rng.rand(96, 160).astype(np.float32)


def test_blur_matches_separable_reference(img):
    np.testing.assert_allclose(np.asarray(_gauss_blur(img)), _blur_ref(img),
                               atol=1e-6)


def test_downsample2_matches_blur_then_decimate(img):
    ref = _blur_ref(img)[::2, ::2]
    got = np.asarray(downsample2(img))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("shape", [(95, 161), (96, 161), (95, 160)])
def test_downsample_odd_extents(rng, shape):
    x = rng.rand(*shape).astype(np.float32)
    assert np.asarray(downsample2(x)).shape == ((shape[0] + 1) // 2,
                                                (shape[1] + 1) // 2)
    np.testing.assert_array_equal(np.asarray(downsample2_depth(x)),
                                  x[::2, ::2])


def test_downsample2_depth_is_pure_decimation(img):
    np.testing.assert_array_equal(np.asarray(downsample2_depth(img)),
                                  img[::2, ::2])


def test_sobel_matches_reference(img):
    gx, gy = sobel_gradients(img)
    rgx, rgy = _sobel_ref(img)
    np.testing.assert_allclose(np.asarray(gx), rgx, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gy), rgy, atol=1e-6)


def test_sobel_sign_convention(img):
    """gx positive on a left->right ramp, gy positive on a top->bottom ramp."""
    u = np.tile(np.arange(32, dtype=np.float32), (32, 1))
    gx, gy = sobel_gradients(u)
    assert float(np.asarray(gx)[5:-5, 5:-5].min()) > 0.9
    np.testing.assert_allclose(np.asarray(gy)[5:-5, 5:-5], 0.0, atol=1e-6)
    gx, gy = sobel_gradients(u.T)
    assert float(np.asarray(gy)[5:-5, 5:-5].min()) > 0.9


def test_blur_color_channels_independent(rng):
    c = rng.rand(32, 40, 3).astype(np.float32)
    out = np.asarray(_gauss_blur(c))
    for ch in range(3):
        np.testing.assert_allclose(out[..., ch],
                                   np.asarray(_gauss_blur(c[..., ch])),
                                   atol=1e-6)


def test_pyramid_shapes(img):
    pyr = build_pyramid(img, img, 3)
    assert [p[0].shape for p in pyr] == [(96, 160), (48, 80), (24, 40)]
    assert [p[1].shape for p in pyr] == [(96, 160), (48, 80), (24, 40)]
