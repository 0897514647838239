"""Masked reductions over the time surface: centroid, model update terms,
sharpness.

Reference: ObjectModel::center_of_mass / compute (object_model.cpp:4-39,
103-126) and EventFile::nonzero_average (event_file.cpp:282-294).  Here
these are plain masked means that XLA fuses with the producing stencil — the
same fusion the reference hand-rolled in its OpenCL model_helper kernel
(gpu_impl.cl:86-131).

For multi-device execution every function here has a *partial* variant that
returns (sum, count) pairs so tiles can be combined with ``psum`` — the four
model terms are all means over pixels, hence trivially reassociable.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from better_flow.config import NONZERO_EPS


def nonzero_average(img: jnp.ndarray) -> jnp.ndarray:
    """Mean over strictly nonzero pixels; 0 if none (event_file.cpp:282-294).

    The reference operates on uint8 images (``*p == 0`` skip); pass images in
    uint8-value space (f32 dtype is fine).
    """
    mask = img != 0
    cnt = jnp.sum(mask)
    return jnp.where(cnt == 0, 0.0, jnp.sum(jnp.where(mask, img, 0.0)) / jnp.maximum(cnt, 1))


def center_of_mass(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(cx, cy, cnt): mean (row, col) over pixels > 1e-6
    (object_model.cpp:103-126).  The reference asserts cnt > 0; here an empty
    image yields (0, 0, 0) and is excluded upstream by the slice gates."""
    mask = img > jnp.float32(NONZERO_EPS)
    H, W = img.shape
    rows = jnp.arange(H, dtype=jnp.float32)[:, None]
    cols = jnp.arange(W, dtype=jnp.float32)[None, :]
    cnt = jnp.sum(mask.astype(jnp.float32))
    denom = jnp.maximum(cnt, 1.0)
    cx = jnp.sum(jnp.where(mask, rows, 0.0)) / denom
    cy = jnp.sum(jnp.where(mask, cols, 0.0)) / denom
    return cx, cy, cnt


class ModelTerms(NamedTuple):
    dx: jnp.ndarray
    dy: jnp.ndarray
    rot: jnp.ndarray
    div: jnp.ndarray
    cnt: jnp.ndarray


def model_compute(
    img: jnp.ndarray, gx: jnp.ndarray, gy: jnp.ndarray, cx, cy
) -> ModelTerms:
    """The four model reductions (ObjectModel::compute, object_model.cpp:4-39).

    Over every pixel with img > 1e-6 (NOT the stricter all-nine gradient
    mask — pixels whose gradient was masked to zero still count in cnt):

        dx  = mean(gx)            dy  = mean(gy)
        rot = mean(r x g)         div = mean(r . g)

    with r = (row - cx, col - cy) and g = (gx, gy).
    """
    mask = img > jnp.float32(NONZERO_EPS)
    H, W = img.shape
    rows = jnp.arange(H, dtype=jnp.float32)[:, None]
    cols = jnp.arange(W, dtype=jnp.float32)[None, :]
    rx = rows - cx
    ry = cols - cy
    m = mask.astype(jnp.float32)
    cnt = jnp.sum(m)
    denom = jnp.maximum(cnt, 1.0)
    dx = jnp.sum(gx * m) / denom
    dy = jnp.sum(gy * m) / denom
    rot = jnp.sum((rx * gy - ry * gx) * m) / denom
    div = jnp.sum((rx * gx + ry * gy) * m) / denom
    return ModelTerms(dx=dx, dy=dy, rot=rot, div=div, cnt=cnt)


def model_compute_sampled(
    img, pr_x, pr_y, valid, cx, cy, scale, x_shift, y_shift, key, p: float = 0.1
) -> ModelTerms:
    """Monte-Carlo model update sampling events instead of pixels.

    Reference: the second ObjectModel::compute overload
    (object_model.cpp:42-99), unused by the shipped pipeline but part of its
    surface.  Samples ~p*N events (with replacement), evaluates the strict
    unmasked Scharr at their projected pixels, keeps samples whose 3x3
    neighbourhood is fully nonzero, and computes dx/dy as sample means, then
    rot/div from the *mean-subtracted* sample gradients (:82-90 — note this
    differs from the pixel path, which does not center the gradients).

    Vectorized form: a fixed sample count with validity masking replaces the
    reference's resample-until-cnt loop (which can spin forever on sparse
    images); the estimator is the same.
    """
    import jax

    n = pr_x.shape[0]
    n_samples = max(int(n * p), 1)
    idx = jax.random.randint(key, (n_samples,), 0, n)
    sx = (pr_x[idx] * scale + x_shift).astype(jnp.int32)
    sy = (pr_y[idx] * scale + y_shift).astype(jnp.int32)
    H, W = img.shape
    inb = valid[idx] & (sx >= 1) & (sx < H - 1) & (sy >= 1) & (sy < W - 1)
    sxc = jnp.clip(sx, 1, H - 2)
    syc = jnp.clip(sy, 1, W - 2)

    ok = inb
    dx = jnp.zeros(n_samples)
    dy = jnp.zeros(n_samples)
    kx = [[3.0, 10.0, 3.0], [0.0, 0.0, 0.0], [-3.0, -10.0, -3.0]]
    ky = [[3.0, 0.0, -3.0], [10.0, 0.0, -10.0], [3.0, 0.0, -3.0]]
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            v = img[sxc + dr, syc + dc]
            ok = ok & (v > jnp.float32(NONZERO_EPS))
            dx = dx + v * kx[dr + 1][dc + 1]
            dy = dy + v * ky[dr + 1][dc + 1]
    m = ok.astype(jnp.float32)
    cnt = jnp.maximum(jnp.sum(m), 1.0)
    mdx = jnp.sum(dx * m) / cnt
    mdy = jnp.sum(dy * m) / cnt
    rx = sxc.astype(jnp.float32) - cx
    ry = syc.astype(jnp.float32) - cy
    gu = dx - mdx
    gv = dy - mdy
    rot = jnp.sum((rx * gv - ry * gu) * m) / cnt
    div = jnp.sum((rx * gu + ry * gv) * m) / cnt
    return ModelTerms(dx=mdx, dy=mdy, rot=rot, div=div, cnt=jnp.sum(m))


def model_compute_partial(img, gx, gy):
    """Tile-local sums for a psum-combinable model update.

    Returns sums of (1, row, col, gx, gy, row*gy - col*gx, row*gx + col*gy)
    over the nonzero mask.  Because rot/div are affine in the centroid,
    global (cx, cy) can be applied *after* the psum:

        rot = S_rg - cx*S_gy + cy*S_gx      (r x g with r = p - c)
        div = S_dg - cx*S_gx - cy*S_gy

    where S_rg/S_dg use absolute pixel coordinates.  Tiles must pass their
    global row/col offsets.
    """
    mask = img > jnp.float32(NONZERO_EPS)
    m = mask.astype(jnp.float32)
    H, W = img.shape
    rows = jnp.arange(H, dtype=jnp.float32)[:, None]
    cols = jnp.arange(W, dtype=jnp.float32)[None, :]
    return {
        "cnt": jnp.sum(m),
        "s_row": jnp.sum(rows * m),
        "s_col": jnp.sum(cols * m),
        "s_gx": jnp.sum(gx * m),
        "s_gy": jnp.sum(gy * m),
        "s_rg": jnp.sum((rows * gy - cols * gx) * m),
        "s_dg": jnp.sum((rows * gx + cols * gy) * m),
    }


def model_from_partials(p) -> Tuple[jnp.ndarray, jnp.ndarray, ModelTerms]:
    """Combine (already psum'd) partial sums into (cx, cy, ModelTerms)."""
    denom = jnp.maximum(p["cnt"], 1.0)
    cx = p["s_row"] / denom
    cy = p["s_col"] / denom
    dx = p["s_gx"] / denom
    dy = p["s_gy"] / denom
    rot = (p["s_rg"] - cx * p["s_gy"] + cy * p["s_gx"]) / denom
    div = (p["s_dg"] - cx * p["s_gx"] - cy * p["s_gy"]) / denom
    return cx, cy, ModelTerms(dx=dx, dy=dy, rot=rot, div=div, cnt=p["cnt"])
