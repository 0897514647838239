"""Time / count images as a race-free scatter + box filter.

The reference's hottest kernel splats every non-noise event into a
scale x scale footprint centred at its scaled projected position,
accumulating per-pixel sums of slice-local time and counts, then divides
(AccelLib::get_time_img_cpu, accel_lib.h:147-178).  Its OpenCL port of this
kernel has an unsynchronized scatter race and was abandoned
(gpu_impl.cl:24-53, accel_lib.h:216-217).

Formulation: since every event writes the *same* value to all scale^2
pixels of its footprint, the splat factorizes into

    footprint scatter  ==  single-pixel scatter  ∘  (scale x scale) box filter

— one scatter-add of N items (instead of N*scale^2) followed by a dense
separable sum filter, both of which XLA compiles well.  The scatter-add is
race-free on every backend (the reference's GPU path died on its
unsynchronized one).  It is bit-deterministic on the CPU; on a GPU XLA adds
with atomics whose order varies from run to run, so sums may differ in the
last bits between runs.

Geometry: images here have a *static* shape (H, W) covering the whole sensor
(scale*res + scale), while the reference allocates a dynamic bbox-sized
window (w+scale, h+scale).  Events land at identical pixel coordinates (the
same x_shift/y_shift are applied), all out-of-window tests use the *dynamic*
window bounds, and everything outside the dynamic window stays exactly zero —
so every downstream masked reduction matches the reference bit-for-bit in
structure.  See better_flow/core/geometry notes in models/global_flow.py.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def box_filter(img: jnp.ndarray, size: int) -> jnp.ndarray:
    """Sum over a size x size window, zero padding, stride 1 (size odd).

    out[p] = sum of img over the window centred at p — exactly the set of
    footprint centres that would have splatted into p.
    """
    if size == 1:
        return img
    pad = size // 2
    return lax.reduce_window(
        img,
        jnp.float32(0),
        lax.add,
        window_dimensions=(size, size),
        window_strides=(1, 1),
        padding=((pad, pad), (pad, pad)),
    )


def splat_indices(
    pr_x, pr_y, mask, scale: int, x_sh, y_sh, w_dyn, h_dyn, H: int, W: int
):
    """Integer centre pixels + acceptance mask for the footprint splat.

    Transcribes accel_lib.h:154-158: x = int(pr_x*scale + x_sh) with C-style
    truncation toward zero, accepted iff scale/2 <= x < w_dyn + scale/2 (and
    same for y; scale/2 is integer division).  ``w_dyn``/``h_dyn`` are the
    *dynamic* window dims (traced scalars); H, W the static image shape.

    Returns (flat_index, accept) where flat_index is H*W (an out-of-bounds
    sentinel, dropped by the scatter) for rejected or masked events.
    """
    half = scale // 2
    fx = pr_x * jnp.float32(scale) + x_sh
    fy = pr_y * jnp.float32(scale) + y_sh
    ix = fx.astype(jnp.int32)  # XLA f32->s32 convert truncates toward zero
    iy = fy.astype(jnp.int32)
    ok = (
        mask
        & (ix >= half)
        & (ix < w_dyn + half)
        & (iy >= half)
        & (iy < h_dyn + half)
    )
    lin = ix * W + iy
    lin = jnp.where(ok, lin, H * W)
    return lin, ok


def scatter_images(
    pr_x,
    pr_y,
    t_ns,
    mask,
    scale: int,
    x_sh,
    y_sh,
    w_dyn,
    h_dyn,
    H: int,
    W: int,
    axis_name=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel (time-sum, count) images after the footprint splat.

    Equivalent to the double accumulation loop of accel_lib.h:151-166 with
    t contributed as t/1e9 seconds (accel_lib.h:162).

    With ``axis_name`` (inside shard_map), events are sharded across devices:
    each device scatters its local events and the pre-filter images are
    psum'd over the mesh axis — the race-free replacement for the
    reference's abandoned GPU scatter (gpu_impl.cl:24-53).
    """
    lin, _ = splat_indices(pr_x, pr_y, mask, scale, x_sh, y_sh, w_dyn, h_dyn, H, W)
    t_sec = t_ns / jnp.float32(1e9)
    vals = jnp.stack([t_sec, jnp.ones_like(t_sec)], axis=-1)
    flat = jnp.zeros((H * W, 2), jnp.float32)
    flat = flat.at[lin].add(vals, mode="drop")
    if axis_name is not None:
        flat = jax.lax.psum(flat, axis_name)
    imgs = flat.reshape(H, W, 2)
    t_sum = box_filter(imgs[:, :, 0], scale)
    cnt = box_filter(imgs[:, :, 1], scale)
    return t_sum, cnt


def splat_padded(
    pr_x, pr_y, t_ns, mask, scale: int, x_sh, y_sh, w_dyn, h_dyn, H: int,
    W: int, pad: int, HP: int, WP: int, axis_name=None,
) -> jnp.ndarray:
    """(2, HP, WP) [time-sum, count] single-pixel splat images with the
    logical (H, W) image at offset (pad, pad) and zeros around it — the
    input of ops.finish_kernel.  Same acceptance and values as
    scatter_images before its box filter."""
    lin, ok = splat_indices(pr_x, pr_y, mask, scale, x_sh, y_sh, w_dyn, h_dyn, H, W)
    plin = jnp.where(ok, (lin // W + pad) * WP + (lin % W + pad), HP * WP)
    t_sec = t_ns / jnp.float32(1e9)
    vals = jnp.stack([t_sec, jnp.ones_like(t_sec)])
    flat = jnp.zeros((2, HP * WP), jnp.float32).at[:, plin].add(vals, mode="drop")
    if axis_name is not None:
        flat = jax.lax.psum(flat, axis_name)
    return flat.reshape(2, HP, WP)


def time_image(
    pr_x, pr_y, t_ns, mask, scale: int, x_sh, y_sh, w_dyn, h_dyn, H: int, W: int,
    axis_name=None,
) -> jnp.ndarray:
    """Average-timestamp image (the reference's 'time image').

    Pixels with no contributions stay 0 (accel_lib.h:168-175 divides only
    where cnt >= 1; the sum there is already 0).
    """
    t_sum, cnt = scatter_images(
        pr_x, pr_y, t_ns, mask, scale, x_sh, y_sh, w_dyn, h_dyn, H, W,
        axis_name=axis_name,
    )
    return jnp.where(cnt >= 1, t_sum / jnp.maximum(cnt, 1), 0.0)


def count_image(
    pr_x, pr_y, mask, scale: int, x_sh, y_sh, w_dyn, h_dyn, H: int, W: int
) -> jnp.ndarray:
    """Footprint count image with the uint8 saturation of the reference's
    projection images (event_file.h:500-505: per-pixel increments stop at
    255, i.e. final value = min(count, 255)).  Returned as f32."""
    lin, _ = splat_indices(pr_x, pr_y, mask, scale, x_sh, y_sh, w_dyn, h_dyn, H, W)
    flat = jnp.zeros((H * W,), jnp.float32)
    flat = flat.at[lin].add(1.0, mode="drop")
    cnt = box_filter(flat.reshape(H, W), scale)
    return jnp.minimum(cnt, 255.0)
