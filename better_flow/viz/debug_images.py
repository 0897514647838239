"""OptimizerRolling's debug imagery (optimizer_rolling.h:351-515).

These are the diagnostic views the reference renders in manual mode and for
video frames: fused low-res gradient magnitude, colored Scharr / LR-Sobel
gradients, and the misalignment map whose value at each pixel is the length
of the walk to the local minimum plus to the local maximum of the time
surface (goto_min/goto_max, :437-515).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from better_flow.config import NONZERO_EPS
from better_flow.ops.gradient import (
    gradient_img_fuse,
    lr_sobel,
    lr_sobel_fuse,
    masked_scharr,
)
from better_flow.viz.images import color_gradient_img


def gradient_img(time_img, pr_img, wsize: int = 50):
    """OptimizerRolling::get_gradient_img (optimizer_rolling.h:351-373):
    LR_Sobel_fuse of the time image with the projection image (fuse happens
    BEFORE the window mean, accel_lib.h:441-442), a second fuse on the
    window-mean output (:363), then the 0.5*|gx| + 0.5*|gy| magnitude."""
    gx, gy = lr_sobel_fuse(jnp.asarray(time_img, jnp.float32),
                           jnp.asarray(pr_img, jnp.float32), wsize)
    gx, gy = gradient_img_fuse(jnp.asarray(pr_img, jnp.float32), gx, gy)
    grad = 0.5 * jnp.abs(gx) + 0.5 * jnp.abs(gy)
    return np.asarray(jnp.clip(grad, 0, 255)).astype(np.uint8)


def gradient_img_color(time_img):
    """get_gradient_img_color (:375-387): full-res masked Scharr in the
    direction-hue encoding."""
    gx, gy = masked_scharr(jnp.asarray(time_img, jnp.float32))
    return color_gradient_img(np.asarray(gx), np.asarray(gy))


def lr_gradient_img_color(time_img, wsize: int = 9):
    """get_LR_gradient_img_color (:389-402)."""
    gx, gy = lr_sobel(jnp.asarray(time_img, jnp.float32), wsize)
    return color_gradient_img(np.asarray(gx), np.asarray(gy))


def _walk_lengths(img: jnp.ndarray, maximize: bool, max_steps: int = 64):
    """Vectorized goto_min/goto_max (optimizer_rolling.h:437-515): from each
    nonzero pixel, repeatedly step to the best (strictly smaller/larger)
    nonzero 8-neighbour; the result is the step count (starting at 1).

    The reference walks pointer-style per pixel; here every pixel walks in
    lock-step via gathers, bounded by ``max_steps`` (the reference's walks
    are bounded by the image diameter; 64 covers its 543x723 images in
    practice and truncates identically for both the min and max walk)."""
    H, W = img.shape
    eps = jnp.float32(NONZERO_EPS)
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)

    neigh = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)
             if not (dr == 0 and dc == 0)]

    def best_neighbor(r, c, val):
        """(r', c', improved) of the best nonzero neighbour."""
        best_v = val
        best_r, best_c = r, c
        for dr, dc in neigh:
            rr = jnp.clip(r + dr, 0, H - 1)
            cc = jnp.clip(c + dc, 0, W - 1)
            inb = (r + dr >= 0) & (r + dr < H) & (c + dc >= 0) & (c + dc < W)
            v = img[rr, cc]
            ok = inb & (v > eps)
            better = ok & ((v > best_v) if maximize else (v < best_v))
            best_r = jnp.where(better, rr, best_r)
            best_c = jnp.where(better, cc, best_c)
            best_v = jnp.where(better, v, best_v)
        return best_r, best_c, best_v

    def body(state):
        r, c, val, steps, alive = state
        nr, nc, nv = best_neighbor(r, c, val)
        moved = alive & ((nr != r) | (nc != c))
        # stop at the image border like the reference (:469, :509)
        border = (nr <= 0) | (nc <= 0) | (nr >= H - 1) | (nc >= W - 1)
        steps = steps + moved.astype(jnp.int32)
        alive = moved & ~border
        return (jnp.where(moved, nr, r), jnp.where(moved, nc, c),
                jnp.where(moved, nv, val), steps, alive)

    def cond(state):
        *_, steps, alive = state
        return jnp.any(alive) & (jnp.max(steps) < max_steps)

    start_alive = img > eps
    state = (rows, cols, img, jnp.ones((H, W), jnp.int32), start_alive)
    r, c, v, steps, _ = lax.while_loop(cond, body, state)
    return jnp.where(start_alive, steps, 0)


def misalignment_img(time_img, max_steps: int = 64) -> np.ndarray:
    """get_misalignment_img_color (optimizer_rolling.h:405-434): per-pixel
    goto_min + goto_max walk length, min-max normalized to uint8."""
    img = jnp.asarray(time_img, jnp.float32)
    total = _walk_lengths(img, False, max_steps) + _walk_lengths(img, True, max_steps)
    total = total.astype(jnp.float32)
    lo, hi = jnp.min(total), jnp.max(total)
    out = jnp.where(hi > lo, (total - lo) * 255.0 / (hi - lo), 0.0)
    return np.asarray(out).astype(np.uint8)
