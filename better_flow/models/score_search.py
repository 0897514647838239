"""Score-based flow search: per-event best-(nx, ny) over a candidate sweep.

Reference: OptimizerGlobal (optimizer_global.h/.cpp) — for a candidate
(nx, ny): warp every event, build a blurred count ("projection") image, give
each event the nonzero-mean sharpness of the metric window around its
projected pixel, and keep each event's best-scoring candidate
(project_all + get_event_score + Event::apply_score,
optimizer_global.cpp:4-101).  ``compute_flow_bruteforce`` (:104-148) sweeps
a dense grid of candidates.

Design: one jitted program scores ONE candidate for all events —
the per-pixel window score is computed for the whole image at once with two
box filters (sum and nonzero count), then gathered at event pixels; a
lax.scan sweeps the candidate grid carrying the per-event running best.
The reference computes per-pixel scores lazily only at occupied pixels
(optimizer_global.cpp:43-58); the dense formulation does strictly more work
per pixel but each pixel is a VPU lane, not a branch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from better_flow.config import NZ, UV_FACTOR
from better_flow.ops.time_image import box_filter
from better_flow.ops.warp import apply_project, compute_uv


class BestFlow(NamedTuple):
    """Per-event best-so-far tracking (Event::apply_score, event.h:113-121)."""

    max_score: jnp.ndarray
    best_nx: jnp.ndarray
    best_ny: jnp.ndarray
    best_pr_x: jnp.ndarray
    best_pr_y: jnp.ndarray


def window_scores(count_img: jnp.ndarray, wsize: int) -> jnp.ndarray:
    """Per-pixel nonzero-mean of the count image over a wsize window
    (OptimizerGlobal::get_event_score, optimizer_global.cpp:86-101)."""
    s = box_filter(count_img, wsize)
    n = box_filter((count_img > 0).astype(jnp.float32), wsize)
    return jnp.where(n == 0, 0.0, s / jnp.maximum(n, 1.0))


def score_candidate(
    x, y, t, valid, nx, ny, scale: int, wsize: int,
    x_min, y_min, w_img: int, h_img: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Score one (nx, ny) candidate for every event.

    Geometry transcribes project_all (optimizer_global.cpp:14-35): positions
    shifted by the cloud bbox min, rejected outside the scaled extent, then
    offset by (metric_wsize/2 + scale/2) into a bordered image.
    """
    prx, pry = apply_project(x, y, t, nx, ny)
    fx = prx * scale - x_min * scale
    fy = pry * scale - y_min * scale
    ix = fx.astype(jnp.int32)
    iy = fy.astype(jnp.int32)
    ok = valid & (ix >= 0) & (ix < w_img - scale) & (iy >= 0) & (iy < h_img - scale)
    half = scale // 2
    W = h_img + wsize
    Hb = w_img + wsize
    cix = ix + half + wsize // 2
    ciy = iy + half + wsize // 2
    lin = jnp.where(ok, cix * W + ciy, Hb * W)
    flat = jnp.zeros((Hb * W,), jnp.float32).at[lin].add(1.0, mode="drop")
    cnt = jnp.minimum(box_filter(flat.reshape(Hb, W), scale), 255.0)
    scores = window_scores(cnt, wsize)
    ev_score = jnp.where(ok, scores[jnp.minimum(cix, Hb - 1), jnp.minimum(ciy, W - 1)], -1.0)
    return ev_score, prx, pry


@partial(jax.jit, static_argnames=("scale", "wsize", "w_img", "h_img"))
def sweep_candidates(
    x, y, t, valid, cand_nx, cand_ny, scale: int, wsize: int,
    x_min, y_min, w_img: int, h_img: int,
) -> BestFlow:
    """lax.scan over a [C] candidate grid, carrying per-event best flow.

    Equivalent to compute_flow_bruteforce (optimizer_global.cpp:104-148)
    with apply_score keeping the strictly-best candidate per event."""
    n = x.shape[0]
    init = BestFlow(
        max_score=jnp.zeros(n, jnp.float32),
        best_nx=jnp.zeros(n, jnp.float32),
        best_ny=jnp.zeros(n, jnp.float32),
        best_pr_x=jnp.asarray(x, jnp.float32),
        best_pr_y=jnp.asarray(y, jnp.float32),
    )

    def step(best: BestFlow, cand):
        cnx, cny = cand
        sc, prx, pry = score_candidate(
            x, y, t, valid, cnx, cny, scale, wsize, x_min, y_min, w_img, h_img
        )
        better = sc > best.max_score
        return BestFlow(
            max_score=jnp.where(better, sc, best.max_score),
            best_nx=jnp.where(better, cnx, best.best_nx),
            best_ny=jnp.where(better, cny, best.best_ny),
            best_pr_x=jnp.where(better, prx, best.best_pr_x),
            best_pr_y=jnp.where(better, pry, best.best_pr_y),
        ), None

    best, _ = lax.scan(step, init, (cand_nx, cand_ny))
    return best


def compute_flow_bruteforce(
    x, y, t_ns, res_x: int = 180, res_y: int = 240,
    x_range=(-0.09, 0.09), y_range=(-0.04, 0.04), step: float = 0.001,
    scale: int = 5, wsize: int = 25,
) -> dict:
    """The dense grid sweep with the reference's default ranges
    (optimizer_global.cpp:106-108).  Returns per-event best flow in px/s."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    t = np.asarray(t_ns, np.float32)
    cand_nx, cand_ny = np.meshgrid(
        np.arange(x_range[0], x_range[1], step),
        np.arange(y_range[0], y_range[1], step),
        indexing="ij",
    )
    x_min = float(np.floor(x.min())) if len(x) else 0.0
    y_min = float(np.floor(y.min())) if len(y) else 0.0
    w_img = int((x.max() - x_min + 1) * scale) + scale if len(x) else scale
    h_img = int((y.max() - y_min + 1) * scale) + scale if len(y) else scale
    best = sweep_candidates(
        x, y, t, np.ones(len(x), bool),
        jnp.asarray(cand_nx.ravel(), jnp.float32),
        jnp.asarray(cand_ny.ravel(), jnp.float32),
        scale, wsize, x_min, y_min, w_img, h_img,
    )
    u, v = compute_uv(best.best_nx, best.best_ny)
    return {
        "u": np.asarray(u),
        "v": np.asarray(v),
        "score": np.asarray(best.max_score),
        "best_pr_x": np.asarray(best.best_pr_x),
        "best_pr_y": np.asarray(best.best_pr_y),
    }
