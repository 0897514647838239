"""Masked Scharr / LR-Sobel vs the naive transcription."""

import numpy as np
import jax.numpy as jnp

from better_flow.ops.gradient import gradient_img_fuse, lr_sobel, masked_scharr

import naive_ref


def _sparse_image(rng, shape=(24, 30), density=0.6):
    img = rng.random(shape).astype(np.float32) * 0.2
    img[rng.random(shape) > density] = 0.0
    return img


def test_masked_scharr_matches_naive(rng):
    img = _sparse_image(rng)
    egx, egy = naive_ref.sobel_cpu(img.astype(np.float64))
    gx, gy = masked_scharr(jnp.asarray(img))
    np.testing.assert_allclose(np.asarray(gx), egx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gy), egy, rtol=1e-4, atol=1e-5)


def test_masked_scharr_border_and_holes(rng):
    img = np.full((8, 8), 0.5, np.float32)
    img[4, 4] = 0.0  # a hole
    gx, gy = masked_scharr(jnp.asarray(img))
    gx = np.asarray(gx); gy = np.asarray(gy)
    # border is always zero
    assert np.all(gx[0, :] == 0) and np.all(gx[-1, :] == 0)
    assert np.all(gx[:, 0] == 0) and np.all(gx[:, -1] == 0)
    # every pixel adjacent to the hole is masked
    for r in range(3, 6):
        for c in range(3, 6):
            assert gx[r, c] == 0 and gy[r, c] == 0
    # a constant patch far from the hole has zero gradient but passed mask
    assert gx[1, 1] == 0  # constant -> coefficients cancel


def test_lr_sobel_matches_naive(rng):
    img = _sparse_image(rng, shape=(20, 22), density=0.7)
    wsize = 5
    egx, egy = naive_ref.lr_sobel(img.astype(np.float64), wsize)
    gx, gy = lr_sobel(jnp.asarray(img), wsize)
    np.testing.assert_allclose(np.asarray(gx), egx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gy), egy, rtol=1e-4, atol=1e-5)


def test_gradient_img_fuse(rng):
    gx = np.array([[3.0, 0.0], [0.0, -4.0]], np.float32)
    gy = np.array([[4.0, 0.0], [0.0, 3.0]], np.float32)
    pr = np.array([[55.0, 10.0], [20.0, 255.0]], np.float32)
    fx, fy = gradient_img_fuse(jnp.asarray(pr), jnp.asarray(gx), jnp.asarray(gy))
    # unit direction scaled by 255 - pr
    np.testing.assert_allclose(float(fx[0, 0]), (3 / 5) * 200, rtol=1e-6)
    np.testing.assert_allclose(float(fy[0, 0]), (4 / 5) * 200, rtol=1e-6)
    assert float(fx[0, 1]) == 0.0  # zero gradient stays zero
    np.testing.assert_allclose(float(fy[1, 1]), 0.0, atol=1e-6)  # pr=255
