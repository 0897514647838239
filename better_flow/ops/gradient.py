"""Masked Scharr gradients of the time surface.

Reference: AccelLib::Sobel_cpu / sobel_point (accel_lib.h:513-615) — a 3x3
Scharr stencil where a pixel receives a gradient only if *all nine* pixels of
its neighbourhood exceed the nonzero threshold (any zero neighbour makes
sobel_point return false, accel_lib.h:596-599; the partial mask_x/mask_y
arrays there are dead code).  Border rows/cols are excluded
(accel_lib.h:528-533), which zero padding reproduces automatically: a border
pixel always has an out-of-image (zero) neighbour and therefore fails the
all-nine test.

Kernel orientation (transcribed from sharr_x/sharr_y with the reference's
[col][row] flattening, accel_lib.h:546-547, and cross-checked against the
explicit row layout of the OpenCL kernel, gpu_impl.cl:72-79):

    dx = 3*a[r-1,c-1] + 10*a[r-1,c] + 3*a[r-1,c+1]
       - 3*a[r+1,c-1] - 10*a[r+1,c] - 3*a[r+1,c+1]
    dy = 3*a[r-1,c-1] - 3*a[r-1,c+1]
       + 10*a[r,c-1] - 10*a[r,c+1]
       + 3*a[r+1,c-1] - 3*a[r+1,c+1]
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import lax

from better_flow.config import NONZERO_EPS


def _shift(padded: jnp.ndarray, dr: int, dc: int, H: int, W: int) -> jnp.ndarray:
    """View of the zero-padded image shifted by (dr, dc) in [-1, 1]."""
    return padded[1 + dr : 1 + dr + H, 1 + dc : 1 + dc + W]


def masked_scharr(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(grad_x, grad_y) with the all-nine-nonzero mask; zeros elsewhere."""
    H, W = img.shape
    p = jnp.pad(img, 1)
    a = {
        (dr, dc): _shift(p, dr, dc, H, W) for dr in (-1, 0, 1) for dc in (-1, 0, 1)
    }
    eps = jnp.float32(NONZERO_EPS)
    ok = None
    for v in a.values():
        nz = v > eps
        ok = nz if ok is None else (ok & nz)
    dx = (
        3.0 * a[(-1, -1)]
        + 10.0 * a[(-1, 0)]
        + 3.0 * a[(-1, 1)]
        - 3.0 * a[(1, -1)]
        - 10.0 * a[(1, 0)]
        - 3.0 * a[(1, 1)]
    )
    dy = (
        3.0 * a[(-1, -1)]
        - 3.0 * a[(-1, 1)]
        + 10.0 * a[(0, -1)]
        - 10.0 * a[(0, 1)]
        + 3.0 * a[(1, -1)]
        - 3.0 * a[(1, 1)]
    )
    zero = jnp.float32(0)
    return jnp.where(ok, dx, zero), jnp.where(ok, dy, zero)


def _window_mean_sparse(g: jnp.ndarray, wsize: int) -> jnp.ndarray:
    """Window mean over entries with |g| > 1e-8, requiring >= wsize^2/4
    support (LR_sobel_point, accel_lib.h:495-510); interior-only fill."""
    half = wsize // 2
    H, W = g.shape
    nz = (jnp.abs(g) > 1e-8).astype(jnp.float32)
    ssum = lax.reduce_window(
        g, jnp.float32(0), lax.add, (wsize, wsize), (1, 1),
        ((half, half), (half, half)),
    )
    scnt = lax.reduce_window(
        nz, jnp.float32(0), lax.add, (wsize, wsize), (1, 1),
        ((half, half), (half, half)),
    )
    ok = scnt >= (wsize * wsize) // 4
    out = jnp.where(ok, ssum / jnp.maximum(scnt, 1.0), 0.0)
    rows = jnp.arange(H)[:, None]
    cols = jnp.arange(W)[None, :]
    interior = (
        (rows >= half) & (rows < H - half) & (cols >= half) & (cols < W - half)
    )
    return jnp.where(interior, out, jnp.float32(0))


def lr_sobel(
    img: jnp.ndarray, wsize: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Low-resolution gradient: window mean of the sparse Scharr gradient.

    Reference: AccelLib::LR_Sobel / LR_sobel_point (accel_lib.h:466-510).
    Per pixel, over a wsize x wsize window of the high-res gradient, average
    the entries with |g| > 1e-8; require at least wsize^2/4 such entries
    (integer division) else 0.  Only pixels in [wsize/2, n - wsize/2) of both
    axes are filled (:447-452).
    """
    gx, gy = masked_scharr(img)
    return _window_mean_sparse(gx, wsize), _window_mean_sparse(gy, wsize)


def gradient_img_fuse(pr_img: jnp.ndarray, gx: jnp.ndarray, gy: jnp.ndarray):
    """Rescale gradient magnitude by inverted projection brightness.

    Reference: EventFile::gradient_img_fuse (event_file.cpp:58-87): normalize
    (gx, gy) to unit length, then scale by (255 - pr_img) where the gradient
    is nonzero.  ``pr_img`` is a uint8-range image (f32 here).
    """
    speed = jnp.hypot(gx, gy)
    safe = jnp.maximum(speed, 1e-30)
    ux = jnp.where(speed == 0, 0.0, gx / safe)
    uy = jnp.where(speed == 0, 0.0, gy / safe)
    mag = jnp.where(speed != 0, 255.0 - pr_img, 0.0)
    return ux * mag, uy * mag


def lr_sobel_fuse(
    img: jnp.ndarray, pr_img: jnp.ndarray, wsize: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """AccelLib::LR_Sobel_fuse (accel_lib.h:436-464): full-res masked Scharr,
    then gradient_img_fuse against the projection image, THEN the window-mean
    sparsity filter — the fuse happens before the averaging, unlike
    LR_Sobel + fuse."""
    gx, gy = masked_scharr(img)
    gx, gy = gradient_img_fuse(pr_img, gx, gy)
    return _window_mean_sparse(gx, wsize), _window_mean_sparse(gy, wsize)
