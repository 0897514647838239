"""The image-space finish of one optimizer iteration as one Pallas kernel
through Triton: box filter -> normalize -> masked Scharr -> the seven
psum-combinable model partials (ops.reductions.model_compute_partial).

The plain composition (ops.time_image.time_image, ops.gradient.masked_scharr,
ops.reductions) makes separate passes over the image with the centroid
reduction between them.  Here one program per (BH, BW) tile reads the raw
(time-sum, count) splat images through shifted loads, keeps every
intermediate in registers, and writes one row of partial sums; XLA adds the
rows and model_from_partials applies the centroid afterwards.

The splat writes into a zero-padded image (``pad`` rows and columns of
zeros around the logical (H, W) image, and the tiles' overhang beyond it),
so every shifted load is in bounds and zero padding needs no masks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from better_flow.config import NONZERO_EPS

BH, BW = 16, 32        # tile rows x cols (Triton wants powers of two)
NUM_WARPS = 4

PARTIAL_KEYS = ("cnt", "s_row", "s_col", "s_gx", "s_gy", "s_rg", "s_dg")


def halo(scale: int) -> int:
    """Zero rows/cols the kernel reads around a pixel: 1 for the Scharr
    ring plus scale//2 for the box filter."""
    return 1 + scale // 2


def padded_shape(scale: int, H: int, W: int):
    """(grid, HP, WP): tile grid over the logical image and the padded
    splat image shape the kernel reads."""
    P = halo(scale)
    gi, gj = -(-H // BH), -(-W // BW)
    return (gi, gj), gi * BH + 2 * P, gj * BW + 2 * P


def _kernel(img_ref, out_ref, *, scale: int, H: int, W: int):
    P = halo(scale)
    h = scale // 2
    r0 = pl.program_id(0) * BH
    c0 = pl.program_id(1) * BW

    def raw(k, dr, dc):
        # Logical pixel (r0 + i + dr, c0 + j + dc) sits at padded
        # (r0 + i + dr + P, c0 + j + dc + P).
        return plgpu.load(img_ref.at[k, pl.ds(r0 + P + dr, BH),
                                     pl.ds(c0 + P + dc, BW)])

    # Separable box sums: column sums for every row offset the Scharr ring
    # needs, then row sums of those.
    col = {}
    for k in (0, 1):
        for dr in range(-P, P + 1):
            for dc in (-1, 0, 1):
                s = raw(k, dr, dc - h)
                for b in range(-h + 1, h + 1):
                    s = s + raw(k, dr, dc + b)
                col[k, dr, dc] = s

    rows_i = lax.broadcasted_iota(jnp.int32, (BH, BW), 0) + r0
    cols_i = lax.broadcasted_iota(jnp.int32, (BH, BW), 1) + c0
    eps = jnp.float32(NONZERO_EPS)
    img = {}
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            t_box = col[0, dr - h, dc]
            c_box = col[1, dr - h, dc]
            for a in range(-h + 1, h + 1):
                t_box = t_box + col[0, dr + a, dc]
                c_box = c_box + col[1, dr + a, dc]
            r = rows_i + dr
            c = cols_i + dc
            inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
            img[dr, dc] = jnp.where(inside & (c_box >= 1.0),
                                    t_box / jnp.maximum(c_box, 1.0), 0.0)

    allnine = img[-1, -1] > eps
    for v in img.values():
        allnine = allnine & (v > eps)
    gx = (3.0 * img[-1, -1] + 10.0 * img[-1, 0] + 3.0 * img[-1, 1]
          - 3.0 * img[1, -1] - 10.0 * img[1, 0] - 3.0 * img[1, 1])
    gy = (3.0 * img[-1, -1] - 3.0 * img[-1, 1]
          + 10.0 * img[0, -1] - 10.0 * img[0, 1]
          + 3.0 * img[1, -1] - 3.0 * img[1, 1])
    gx = jnp.where(allnine, gx, 0.0)
    gy = jnp.where(allnine, gy, 0.0)
    m = (img[0, 0] > eps).astype(jnp.float32)
    rf = rows_i.astype(jnp.float32)
    cf = cols_i.astype(jnp.float32)

    def total(a):
        return jnp.sum(jnp.sum(a, axis=1), axis=0)

    vals = (total(m), total(rf * m), total(cf * m), total(gx), total(gy),
            total(rf * gy - cf * gx), total(rf * gx + cf * gy))
    lane = lax.broadcasted_iota(jnp.int32, (8,), 0)
    row = jnp.zeros((8,), jnp.float32)
    for j, v in enumerate(vals):
        row = jnp.where(lane == j, v, row)
    out_ref[...] = row


@functools.partial(jax.jit, static_argnames=("scale", "H", "W", "interpret"))
def finish_partials(padded, scale: int, H: int, W: int,
                    interpret: bool = False) -> dict:
    """Model partials of the (2, HP, WP) padded splat images [time-sum,
    count] (see padded_shape).  ``interpret`` runs the kernel in the Pallas
    interpreter; only tests ask for it."""
    grid, HP, WP = padded_shape(scale, H, W)
    if padded.shape != (2, HP, WP):
        raise ValueError(f"padded splat images {padded.shape}, want "
                         f"{(2, HP, WP)}")
    rows = pl.pallas_call(
        functools.partial(_kernel, scale=scale, H=H, W=W),
        grid=grid,
        in_specs=[pl.BlockSpec((2, HP, WP), lambda i, j: (0, 0, 0))],
        out_specs=pl.BlockSpec((None, None, 8), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct(grid + (8,), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="finish_partials",
    )(padded)
    sums = jnp.sum(rows.reshape(-1, 8), axis=0)
    return {k: sums[j] for j, k in enumerate(PARTIAL_KEYS)}
