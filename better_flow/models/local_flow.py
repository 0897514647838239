"""Local 2-parameter flow: per-window sharpness ascent, vmapped into a
per-pixel flow field.

Reference: OptimizerLocal (optimizer_sampler.h/.cpp) — coordinate ascent on
the nonzero-mean sharpness of a windowed count image, with the step-halving
rule "if the score did not improve, halve and flip the step"
(optimizer_sampler.cpp:90-117).  The reference only ever runs one window at
a time; here the same optimizer is ``vmap``-ed over a grid of windows to
produce a dense local flow field (BASELINE.json config 3), coarse-to-fine
over ``scale``.

Design: each window owns a fixed gathered subset of K events (the C++
constructor also fixes the window's event subset at construction,
optimizer_sampler.h:31-35).  A window iteration projects its K events,
splats a small static (wsz*scale+scale)^2 count image (single-pixel scatter
+ box filter, like ops.time_image), Gaussian-blurs it with the same kernel
OpenCV uses, and scores it.  The data-dependent descent runs as
``lax.while_loop``; vmap batches the while loops across windows.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from better_flow.config import NZ, T_DIVIDER
from better_flow.ops.time_image import box_filter
from better_flow.ops.warp import apply_project, compute_uv


_CV_SMALL_GAUSS = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel_1d(ksize: int) -> np.ndarray:
    """OpenCV's getGaussianKernel(ksize, 0) — used by
    cv::GaussianBlur(img, (scale, scale), 0, 0) (optimizer_sampler.cpp:
    148-150).  OpenCV hardcodes the small kernels (ksize <= 7, sigma <= 0);
    larger ones use sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if ksize in _CV_SMALL_GAUSS:
        return _CV_SMALL_GAUSS[ksize].astype(np.float32)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(xs**2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _gauss_blur(img: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Separable Gaussian blur with zero (border-replicate-free) padding.

    OpenCV uses BORDER_DEFAULT (reflect-101); window interiors dominate the
    sharpness score so zero padding is an accepted deviation, covered by the
    field-level tests rather than bit-parity ones.
    """
    if ksize <= 1:
        return img
    k = jnp.asarray(gaussian_kernel_1d(ksize))
    pad = ksize // 2
    img = jnp.pad(img, ((pad, pad), (0, 0)))
    # separable conv via correlation with lax.conv_general_dilated
    img4 = img[None, None, :, :]
    kr = k[None, None, :, None]
    img4 = lax.conv_general_dilated(img4, kr, (1, 1), "VALID")
    img2 = img4[0, 0]
    img2 = jnp.pad(img2, ((0, 0), (pad, pad)))
    img4 = img2[None, None, :, :]
    kc = k[None, None, None, :]
    img4 = lax.conv_general_dilated(img4, kc, (1, 1), "VALID")
    return img4[0, 0]


class LocalWindow(NamedTuple):
    """One window's fixed event subset (K gathered events + validity)."""

    x: jnp.ndarray       # f32[K] original pixels
    y: jnp.ndarray
    t: jnp.ndarray       # f32[K] slice-local ns
    valid: jnp.ndarray   # bool[K]
    cx: jnp.ndarray      # f32 window centre (original pixel coords)
    cy: jnp.ndarray


class LocalState(NamedTuple):
    nx: jnp.ndarray
    ny: jnp.ndarray
    dnx: jnp.ndarray
    dny: jnp.ndarray
    last_score: jnp.ndarray
    iters: jnp.ndarray


def _count_image(win: LocalWindow, nx, ny, scale: int, wsz: int):
    """OptimizerLocal::iteration_step (optimizer_sampler.cpp:120-153):
    project all window events and the centre with (nx, ny), splat a
    saturating count image shifted so the warped centre stays centred,
    Gaussian blur."""
    prx, pry = apply_project(win.x, win.y, win.t, nx, ny)
    ccx, ccy = apply_project(win.cx, win.cy, jnp.float32(0.0), nx, ny)
    wsx = wsz * scale
    wsy = wsz * scale
    H = wsx + scale
    W = wsy + scale
    x_sh = -ccx * scale + wsx / 2.0
    y_sh = -ccy * scale + wsy / 2.0
    fx = prx * scale + x_sh
    fy = pry * scale + y_sh
    ix = fx.astype(jnp.int32)
    iy = fy.astype(jnp.int32)
    ok = win.valid & (ix >= 0) & (ix < wsx) & (iy >= 0) & (iy < wsy)
    half = scale // 2
    lin = jnp.where(ok, (ix + half) * W + (iy + half), H * W)
    flat = jnp.zeros((H * W,), jnp.float32).at[lin].add(1.0, mode="drop")
    cnt = jnp.minimum(box_filter(flat.reshape(H, W), scale), 255.0)
    return jnp.floor(_gauss_blur(cnt, scale if scale > 1 else 0) + 0.5)


def _score(img: jnp.ndarray) -> jnp.ndarray:
    """nonzero mean (optimizer_sampler.cpp:192-204)."""
    mask = img != 0
    n = jnp.sum(mask)
    return jnp.where(n == 0, 0.0, jnp.sum(jnp.where(mask, img, 0.0)) / jnp.maximum(n, 1))


def local_flow_window(
    win: LocalWindow,
    scale: int,
    wsz: int,
    max_time_ms: int = 100,
    max_iters: int = 100,
    nx0=None,
    ny0=None,
    dn0: float = 0.01,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run the 2-param descent for one window; returns (nx, ny, iters).

    Transcribes OptimizerLocal::run (optimizer_sampler.cpp:4-38):
    dn threshold = NZ*T_DIVIDER*1000 / (10*scale*FROM_MS(MAX_TIME_MS)),
    initial steps ``dn0`` (the reference's 0.01), alternating nx/ny updates
    with halve-and-flip.

    ``nx0``/``ny0`` (traced scalars) warm-start the descent — the
    coarse-to-fine chain seeds each finer scale from the coarser field's
    converged (nx, ny) so the fine-scale search starts inside the right
    basin instead of at zero flow.  The C++ optimizer always starts at
    (0, 0) because it only ever runs one scale (optimizer_sampler.cpp:7-8);
    the seeded start is the coarse-to-fine extension SURVEY §7 step 6
    prescribes.
    """
    dn_th = (NZ * T_DIVIDER * 1000.0) / (10.0 * scale * (1e6 * max_time_ms))

    def score_at(nx, ny):
        return _score(_count_image(win, nx, ny, scale, wsz))

    nx_i = jnp.float32(0) if nx0 is None else jnp.asarray(nx0, jnp.float32)
    ny_i = jnp.float32(0) if ny0 is None else jnp.asarray(ny0, jnp.float32)
    init = LocalState(
        nx=nx_i, ny=ny_i,
        dnx=jnp.float32(dn0), dny=jnp.float32(dn0),
        last_score=score_at(nx_i, ny_i),
        iters=jnp.int32(0),
    )

    def cond(s: LocalState):
        return (jnp.hypot(s.dnx, s.dny) > dn_th) & (s.iters < max_iters)

    def body(s: LocalState):
        # compute_new_nx (optimizer_sampler.cpp:90-102)
        nx_new = s.nx + s.dnx
        sc = score_at(nx_new, s.ny)
        dnx = jnp.where(sc - s.last_score <= 0, -s.dnx / 2.0, s.dnx)
        last = sc
        # compute_new_ny (:105-117)
        ny_new = s.ny + s.dny
        sc2 = score_at(nx_new, ny_new)
        dny = jnp.where(sc2 - last <= 0, -s.dny / 2.0, s.dny)
        return LocalState(nx=nx_new, ny=ny_new, dnx=dnx, dny=dny,
                          last_score=sc2, iters=s.iters + 1)

    out = lax.while_loop(cond, body, init)
    return out.nx, out.ny, out.iters


def gather_windows(
    x, y, t, valid, centers_x, centers_y, wsz: int, k: int
) -> LocalWindow:
    """Fix each window's event subset: the first K events within the wsz
    window around each centre (original positions, like the C++ window
    constructor).  Pure jnp; [G] centers -> LocalWindow with [G, K] fields."""
    x = jnp.asarray(x); y = jnp.asarray(y); t = jnp.asarray(t)
    valid = jnp.asarray(valid)

    def one(cx, cy):
        inside = (
            valid
            & (jnp.abs(x - cx) <= wsz / 2)
            & (jnp.abs(y - cy) <= wsz / 2)
        )
        # stable top-K: indices of first K inside-events
        order = jnp.argsort(~inside, stable=True)[:k]
        sel = inside[order]
        return LocalWindow(
            x=x[order], y=y[order], t=t[order], valid=sel,
            cx=jnp.float32(cx), cy=jnp.float32(cy),
        )

    return jax.vmap(one)(jnp.asarray(centers_x, jnp.float32),
                         jnp.asarray(centers_y, jnp.float32))


@partial(jax.jit, static_argnames=("scale", "wsz", "min_events", "dn0"))
def local_flow_field(
    windows: LocalWindow, scale: int, wsz: int, min_events: int = 30,
    init_nx=None, init_ny=None, dn0: float = 0.01,
):
    """vmapped per-window descent -> (u, v, n_events, iters, nx, ny).

    Windows with fewer than ``min_events`` events keep zero flow (the
    reference's window-size gate analogue, optimizer_sampler.cpp:9-13).
    ``init_nx``/``init_ny`` ([G] f32, optional) seed every window's descent
    — the coarse-to-fine hand-off between scales; ``dn0`` is the initial
    step size (see flow_field_grid for the per-scale schedule).
    """
    if init_nx is None:
        nx, ny, iters = jax.vmap(
            lambda w: local_flow_window(w, scale, wsz, dn0=dn0)
        )(windows)
    else:
        nx, ny, iters = jax.vmap(
            lambda w, a, b: local_flow_window(w, scale, wsz, nx0=a, ny0=b,
                                              dn0=dn0)
        )(windows, jnp.asarray(init_nx, jnp.float32),
          jnp.asarray(init_ny, jnp.float32))
    n_ev = jnp.sum(windows.valid, axis=1)
    ok = n_ev >= min_events
    nx = jnp.where(ok, nx, 0.0)
    ny = jnp.where(ok, ny, 0.0)
    u, v = compute_uv(nx, ny)
    return u, v, n_ev, jnp.where(ok, iters, 0), nx, ny


def flow_field_grid(
    x, y, t_ns, res_x: int, res_y: int,
    step: int = 16, wsz: int = 31, scales=(1, 3, 3), k: int = 1024,
    dense: bool = False, dn0s=None,
) -> dict:
    """Dense local flow on a regular grid, coarse-to-fine over ``scales``.

    The scales CHAIN: each scale's converged per-window (nx, ny) seeds the
    next (finer) scale's descent, so large displacements found on the
    coarse, wide-basin score landscape are refined — not re-searched from
    zero — at fine resolution (SURVEY §7 step 6; the per-scale convergence
    threshold follows optimizer_sampler.cpp:24-31, tightening 1/scale).
    ``scales`` should therefore be ordered coarse -> fine, i.e. ascending
    ``scale`` (the image up-sampling factor: larger = finer sub-pixel
    resolution, smaller convergence threshold); a repeated final scale is
    a refinement pass with a re-inflated (then smaller) initial step.

    Each scale's initial step ``dn0`` halves down the chain
    (0.01 * 2^(m-1-i), so the last scale runs the reference's 0.01,
    optimizer_sampler.cpp:7): the reference's halve-and-flip rule can only
    shrink the step, so a plateau in the quantized score collapses a
    0.01-step search started at zero flow long before it reaches a
    large-displacement optimum — the wide coarse step is what buys the
    basin reach, and re-starting each scale re-inflates the step budget.
    Measured on a 96x96 scene at 350 px/s: single-scale (3,) recovers
    (221, 0) of (350, 100); the default chain recovers (347, 100).
    Override per-scale steps with ``dn0s`` (same length as ``scales``).

    Returns grid centres and per-window flow (px/s); each window's result
    also reports the events and iterations of the FINAL scale (plus
    ``iters_total`` across the chain).  With ``dense=True`` additionally
    returns per-pixel ``u_dense``/``v_dense`` ([res_x, res_y] px/s,
    bilinear interpolation of the window grid — the BASELINE config-3
    per-pixel flow-field output).  Event inputs are the raw recording
    slice (x, y, slice-local t in ns).
    """
    centers_x, centers_y = np.meshgrid(
        np.arange(wsz // 2, res_x - wsz // 2, step),
        np.arange(wsz // 2, res_y - wsz // 2, step),
        indexing="ij",
    )
    cx = centers_x.ravel().astype(np.float32)
    cy = centers_y.ravel().astype(np.float32)
    valid = np.ones(len(x), bool)
    wins = gather_windows(
        np.asarray(x, np.float32), np.asarray(y, np.float32),
        np.asarray(t_ns, np.float32), valid, cx, cy, wsz, k,
    )
    if dn0s is None:
        dn0s = [0.01 * 2 ** (len(scales) - 1 - i) for i in range(len(scales))]
    seed_nx = seed_ny = None
    iters_total = np.zeros(centers_x.size, np.int64)
    out = {}
    for scale, dn0 in zip(scales, dn0s):
        u, v, n_ev, iters, nx, ny = local_flow_field(
            wins, scale, wsz, init_nx=seed_nx, init_ny=seed_ny, dn0=dn0)
        seed_nx, seed_ny = nx, ny
        iters_total += np.asarray(iters)
        out = {
            "grid_x": centers_x, "grid_y": centers_y,
            "u": np.asarray(u).reshape(centers_x.shape),
            "v": np.asarray(v).reshape(centers_x.shape),
            "n_events": np.asarray(n_ev).reshape(centers_x.shape),
            "iters": np.asarray(iters).reshape(centers_x.shape),
            "iters_total": iters_total.reshape(centers_x.shape),
            "scale": scale,
        }
    if dense and out:
        out["u_dense"] = interpolate_grid_to_dense(
            out["u"], centers_x, centers_y, res_x, res_y)
        out["v_dense"] = interpolate_grid_to_dense(
            out["v"], centers_x, centers_y, res_x, res_y)
    return out


def interpolate_grid_to_dense(field, centers_x, centers_y,
                              res_x: int, res_y: int) -> np.ndarray:
    """Bilinear interpolation of a [Gx, Gy] window-grid field to a
    per-pixel [res_x, res_y] map (constant extrapolation beyond the outer
    window centres).  numpy-only — runs once per field, off the hot path."""
    gx = centers_x[:, 0].astype(np.float64)
    gy = centers_y[0, :].astype(np.float64)
    px = np.arange(res_x, dtype=np.float64)
    py = np.arange(res_y, dtype=np.float64)
    # fractional grid coordinates of each pixel, clamped to the grid hull
    ix = np.clip(np.interp(px, gx, np.arange(len(gx))), 0, len(gx) - 1)
    iy = np.clip(np.interp(py, gy, np.arange(len(gy))), 0, len(gy) - 1)
    x0 = np.minimum(ix.astype(np.int64), len(gx) - 2) if len(gx) > 1 else np.zeros(res_x, np.int64)
    y0 = np.minimum(iy.astype(np.int64), len(gy) - 2) if len(gy) > 1 else np.zeros(res_y, np.int64)
    fx = (ix - x0)[:, None]
    fy = (iy - y0)[None, :]
    f = np.asarray(field, np.float64)
    x1 = np.minimum(x0 + 1, len(gx) - 1)
    y1 = np.minimum(y0 + 1, len(gy) - 1)
    out = (
        f[np.ix_(x0, y0)] * (1 - fx) * (1 - fy)
        + f[np.ix_(x1, y0)] * fx * (1 - fy)
        + f[np.ix_(x0, y1)] * (1 - fx) * fy
        + f[np.ix_(x1, y1)] * fx * fy
    )
    return out.astype(np.float32)
