"""Centroid / model reductions / sharpness vs the naive transcription."""

import numpy as np
import jax.numpy as jnp

from better_flow.ops.gradient import masked_scharr
from better_flow.ops.reductions import (
    center_of_mass,
    model_compute,
    model_compute_partial,
    model_from_partials,
    nonzero_average,
)

import naive_ref


def _image(rng, shape=(20, 26)):
    img = rng.random(shape).astype(np.float32) * 0.2
    img[rng.random(shape) > 0.65] = 0.0
    img[3:9, 4:12] += 0.1
    return img


def test_center_of_mass_matches_naive(rng):
    img = _image(rng)
    ecx, ecy, ecnt = naive_ref.center_of_mass(img.astype(np.float64))
    cx, cy, cnt = center_of_mass(jnp.asarray(img))
    np.testing.assert_allclose(float(cx), ecx, rtol=1e-5)
    np.testing.assert_allclose(float(cy), ecy, rtol=1e-5)
    assert int(cnt) == ecnt


def test_model_compute_matches_naive(rng):
    img = _image(rng)
    ecx, ecy, _ = naive_ref.center_of_mass(img.astype(np.float64))
    edx, edy, erot, ediv, ecnt = naive_ref.model_compute(
        img.astype(np.float64), ecx, ecy
    )
    gx, gy = masked_scharr(jnp.asarray(img))
    t = model_compute(jnp.asarray(img), gx, gy, jnp.float32(ecx), jnp.float32(ecy))
    np.testing.assert_allclose(float(t.dx), edx, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(t.dy), edy, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(t.rot), erot, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(t.div), ediv, rtol=1e-3, atol=1e-5)
    assert int(t.cnt) == ecnt


def test_partial_reductions_recombine(rng):
    """Tile-partial sums + affine centroid correction == direct reduction."""
    img = _image(rng)
    gx, gy = masked_scharr(jnp.asarray(img))
    p = model_compute_partial(jnp.asarray(img), gx, gy)
    cx, cy, terms = model_from_partials(p)
    dcx, dcy, dcnt = center_of_mass(jnp.asarray(img))
    direct = model_compute(jnp.asarray(img), gx, gy, dcx, dcy)
    np.testing.assert_allclose(float(cx), float(dcx), rtol=1e-5)
    np.testing.assert_allclose(float(cy), float(dcy), rtol=1e-5)
    np.testing.assert_allclose(float(terms.dx), float(direct.dx), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(terms.rot), float(direct.rot), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(terms.div), float(direct.div), rtol=1e-3, atol=1e-5)


def test_nonzero_average_matches_naive(rng):
    img = (rng.random((15, 17)) * 255).astype(np.uint8)
    img[rng.random((15, 17)) > 0.5] = 0
    expected = naive_ref.nonzero_average(img.astype(np.float64))
    got = float(nonzero_average(jnp.asarray(img, jnp.float32)))
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    assert float(nonzero_average(jnp.zeros((4, 4)))) == 0.0
