"""Time/count image scatter vs the naive footprint-splat transcription."""

import numpy as np
import jax.numpy as jnp

from better_flow.ops.time_image import (
    box_filter,
    count_image,
    scatter_images,
    time_image,
)

import naive_ref


def _setup(rng, n=500, scale=3, res=(24, 32)):
    """Random warped events over a small sensor, some out of window."""
    fx = rng.integers(0, res[0], n).astype(np.float64)
    fy = rng.integers(0, res[1], n).astype(np.float64)
    t = rng.integers(0, int(2e8), n).astype(np.float64)
    noise = rng.random(n) < 0.1
    ev = naive_ref.NaiveEvents(fx, fy, t, noise)
    # random warp so pr != fr, with some events pushed out of the window
    ev.pr_x = fx + rng.normal(0, 2.0, n)
    ev.pr_y = fy + rng.normal(0, 2.0, n)
    x_min, x_max = int(fx.min()), int(fx.max())
    y_min, y_max = int(fy.min()), int(fy.max())
    w = scale * (x_max - x_min)
    h = scale * (y_max - y_min)
    x_sh = -float((x_max - x_min) // 2 + x_min) * scale + w / 2.0 + scale // 2
    y_sh = -float((y_max - y_min) // 2 + y_min) * scale + h / 2.0 + scale // 2
    return ev, w, h, x_sh, y_sh


def test_time_image_matches_naive(rng):
    scale = 3
    res = (24, 32)
    ev, w, h, x_sh, y_sh = _setup(rng, scale=scale, res=res)
    expected = naive_ref.get_time_img(ev, w, h, scale, x_sh, y_sh)

    H = res[0] * scale + scale
    W = res[1] * scale + scale
    got = np.asarray(
        time_image(
            jnp.asarray(ev.pr_x, jnp.float32),
            jnp.asarray(ev.pr_y, jnp.float32),
            jnp.asarray(ev.t, jnp.float32),
            jnp.asarray(~ev.noise),
            scale,
            jnp.float32(x_sh),
            jnp.float32(y_sh),
            jnp.int32(w),
            jnp.int32(h),
            H,
            W,
        )
    )
    # the static image embeds the dynamic window at the origin
    np.testing.assert_allclose(got[: w + scale, : h + scale], expected, rtol=1e-5, atol=1e-6)
    # everything outside the dynamic window is exactly zero
    assert np.all(got[w + scale :, :] == 0)
    assert np.all(got[:, h + scale :] == 0)


def test_scatter_counts_match_naive(rng):
    scale = 5
    res = (20, 20)
    ev, w, h, x_sh, y_sh = _setup(rng, n=300, scale=scale, res=res)
    # count via naive: reuse get_time_img with t=1e9 so avg==1 where cnt>0,
    # and recompute counts directly
    half = scale // 2
    cnt_expected = np.zeros((w + scale, h + scale))
    for i in range(len(ev.fr_x)):
        if ev.noise[i]:
            continue
        x = int(ev.pr_x[i] * scale + x_sh)
        y = int(ev.pr_y[i] * scale + y_sh)
        if x >= w + half or x < half or y >= h + half or y < half:
            continue
        cnt_expected[x - half : x + half + 1, y - half : y + half + 1] += 1

    H = res[0] * scale + scale
    W = res[1] * scale + scale
    _, cnt = scatter_images(
        jnp.asarray(ev.pr_x, jnp.float32),
        jnp.asarray(ev.pr_y, jnp.float32),
        jnp.asarray(ev.t, jnp.float32),
        jnp.asarray(~ev.noise),
        scale,
        jnp.float32(x_sh),
        jnp.float32(y_sh),
        jnp.int32(w),
        jnp.int32(h),
        H,
        W,
    )
    np.testing.assert_array_equal(
        np.asarray(cnt)[: w + scale, : h + scale], cnt_expected
    )


def test_count_image_saturates_at_255(rng):
    # all events on one pixel -> count saturates like the uint8 splat
    n = 400
    scale = 1
    prx = np.full(n, 5.0)
    pry = np.full(n, 5.0)
    img = count_image(
        jnp.asarray(prx, jnp.float32),
        jnp.asarray(pry, jnp.float32),
        jnp.ones(n, bool),
        scale,
        jnp.float32(0),
        jnp.float32(0),
        jnp.int32(20),
        jnp.int32(20),
        21,
        21,
    )
    assert float(img[5, 5]) == 255.0


def test_box_filter_is_footprint_sum(rng):
    img = jnp.asarray(rng.random((16, 16)), jnp.float32)
    out = np.asarray(box_filter(img, 3))
    padded = np.pad(np.asarray(img), 1)
    expected = sum(
        padded[1 + dr : 17 + dr, 1 + dc : 17 + dc]
        for dr in (-1, 0, 1)
        for dc in (-1, 0, 1)
    )
    np.testing.assert_allclose(out, expected, rtol=1e-6)
