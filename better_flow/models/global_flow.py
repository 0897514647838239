"""Global 4-parameter motion flow — the production optimizer, fully on device.

Reference: OptimizerRolling (optimizer_rolling.h) driving ObjectModel
(object_model.cpp).  One slice is processed as:

    reset -> warm-start warp -> [time image -> Scharr -> 4 masked means ->
    accumulator step -> re-warp every event] repeated under the adaptive
    divider schedule until convergence.

Design:
* The whole iteration is one fused dense computation over a *static* image
  (scale*res + scale per axis) — the reference's dynamic bbox window is
  reproduced exactly by applying the same shifts and rejection bounds as
  traced scalars while leaving out-of-window pixels zero (they are invisible
  to every masked reduction).  No dynamic shapes, no recompilation per slice.
* The data-dependent iteration count (optimizer_rolling.h:76-101) runs as a
  ``lax.while_loop`` whose carry holds (pr, n, model, dividers, iter).
* Per-event mutable state of the C++ (Event::pr_*, n*) is the loop carry;
  events themselves are immutable SoA tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax.numpy as jnp
from jax import lax

from better_flow.config import OptimizerConfig, SensorConfig
from better_flow.core.events import EventSlice, bounding_box
from better_flow.core.model import MotionModel
from better_flow.ops.gradient import masked_scharr
from better_flow.ops.reductions import (
    center_of_mass,
    model_compute,
    model_from_partials,
)
from better_flow.ops.time_image import splat_padded, time_image
from better_flow.ops.warp import compute_uv, project_4param_reinit


class SliceGeometry(NamedTuple):
    """Scaled-window geometry of one slice (optimizer_rolling.h:248-283)."""

    x_shift: jnp.ndarray  # f32 (traced)
    y_shift: jnp.ndarray
    w_dyn: jnp.ndarray    # i32 scaled bbox extent (metric_wsizex)
    h_dyn: jnp.ndarray
    window_small: jnp.ndarray  # bool: the size gate fired (:49)


def slice_geometry(
    ev: EventSlice, scale: int, sensor: SensorConfig, min_window_fraction: int = 15,
    axis_name=None,
) -> SliceGeometry:
    x_min, x_max, y_min, y_max = bounding_box(ev, axis_name=axis_name)
    return geometry_from_bbox(x_min, x_max, y_min, y_max, scale, sensor,
                              min_window_fraction)


def geometry_from_bbox(
    x_min, x_max, y_min, y_max, scale: int, sensor: SensorConfig,
    min_window_fraction: int = 15,
) -> SliceGeometry:
    """Window geometry from a known integer bbox — the host already touches
    every event while slicing, so scan pipelines precompute the bbox there
    and skip four per-slice masked reductions on device."""
    x_min = jnp.asarray(x_min, jnp.int32)
    x_max = jnp.asarray(x_max, jnp.int32)
    y_min = jnp.asarray(y_min, jnp.int32)
    y_max = jnp.asarray(y_max, jnp.int32)
    wx = scale * (x_max - x_min)
    wy = scale * (y_max - y_min)
    # x_shift = -((x_max-x_min)/2 + x_min)*scale + wx/2.0 + scale/2, with the
    # reference's integer divisions (optimizer_rolling.h:279-283).
    half = scale // 2
    x_shift = (
        -((x_max - x_min) // 2 + x_min).astype(jnp.float32) * scale
        + wx.astype(jnp.float32) / 2.0
        + half
    )
    y_shift = (
        -((y_max - y_min) // 2 + y_min).astype(jnp.float32) * scale
        + wy.astype(jnp.float32) / 2.0
        + half
    )
    # Gate: both scaled window dims below scale*RES/min_window_fraction
    # (integer division), optimizer_rolling.h:49 (the reference hardcodes
    # 15; OptimizerConfig exposes it).  scale_img = w + scale.  Host-side
    # gate reconstructions (scan_pipeline's pre-range history) use the same
    # config value — the two must agree for range/multihost hand-offs to
    # stay exact.
    frac = min_window_fraction
    window_small = ((wx + scale) < (scale * sensor.res_x) // frac) & (
        (wy + scale) < (scale * sensor.res_y) // frac
    )
    return SliceGeometry(x_shift, y_shift, wx, wy, window_small)


def static_image_shape(scale: int, sensor: SensorConfig) -> Tuple[int, int]:
    """Static (H, W) covering any dynamic window: scale*res + scale."""
    return sensor.res_x * scale + scale, sensor.res_y * scale + scale


class GlobalFlowState(NamedTuple):
    """lax.while_loop carry for OptimizerRolling::run."""

    pr_x: jnp.ndarray
    pr_y: jnp.ndarray
    nx: jnp.ndarray
    ny: jnp.ndarray
    model: MotionModel
    x_div: jnp.ndarray
    y_div: jnp.ndarray
    rot_div: jnp.ndarray
    div_div: jnp.ndarray
    iters: jnp.ndarray


class SliceResult(NamedTuple):
    model: MotionModel      # event-coordinate centroid + accumulated totals
    pr_x: jnp.ndarray       # final projected positions
    pr_y: jnp.ndarray
    nx: jnp.ndarray         # final direction vectors
    ny: jnp.ndarray
    u: jnp.ndarray          # per-event flow, px/s (compute_uv)
    v: jnp.ndarray
    noise: jnp.ndarray      # updated noise flags
    iters: jnp.ndarray      # optimizer iterations executed (0 if gated)
    ran: jnp.ndarray        # whether the optimizer ran
    window_small: jnp.ndarray  # scalar: the degenerate-window gate fired —
    # the only per-slice noise SOURCE (optimizer_rolling.h:52-54), so slice
    # runtimes can reconstruct noise flags from this scalar history instead
    # of carrying a per-event global array (see scan_pipeline._scan_body)
    seed: jnp.ndarray       # (8,) f32 [slope_mem[4], prev_d[4]] at exit:
    # the secant schedule's slope memory, carried across slices by the scan
    # so a warm-started slice's FIRST step is already curvature-sized
    # instead of a full divider-1 gradient step (zeros for the reference
    # schedule)


def _model_terms(pr_x, pr_y, t, active, x_sh, y_sh, w_dyn, h_dyn, *,
                 scale, H, W, axis_name):
    """Splat -> time image -> centroid and the four model terms, as plain
    XLA passes (fast_model == ObjectModel::update: centroid then the four
    means; object_model.h:31-34, object_model.cpp:4-39, 103-126)."""
    img = time_image(pr_x, pr_y, t, active, scale, x_sh, y_sh, w_dyn, h_dyn,
                     H, W, axis_name=axis_name)
    cx_img, cy_img, _ = center_of_mass(img)
    gx, gy = masked_scharr(img)
    return cx_img, cy_img, model_compute(img, gx, gy, cx_img, cy_img)


def _model_terms_gpu(pr_x, pr_y, t, active, x_sh, y_sh, w_dyn, h_dyn, *,
                     scale, H, W, axis_name):
    """_model_terms on a GPU: the splat into a padded image, then the whole
    image-space finish in one kernel (ops.finish_kernel) whose partial sums
    take the centroid afterwards (ops.reductions.model_from_partials)."""
    from better_flow.ops.finish_kernel import (
        finish_partials,
        halo,
        padded_shape,
    )

    _, HP, WP = padded_shape(scale, H, W)
    padded = splat_padded(pr_x, pr_y, t, active, scale, x_sh, y_sh, w_dyn,
                          h_dyn, H, W, halo(scale), HP, WP,
                          axis_name=axis_name)
    return model_from_partials(finish_partials(padded, scale, H, W))


def _iteration_step(
    state: GlobalFlowState,
    ev: EventSlice,
    geom: SliceGeometry,
    scale: int,
    H: int,
    W: int,
    axis_name=None,
    update_fn=None,
) -> GlobalFlowState:
    """One optimizer iteration (OptimizerRolling::iteration_step,
    optimizer_rolling.h:305-347)."""
    static = dict(scale=scale, H=H, W=W, axis_name=axis_name)
    cx_img, cy_img, terms = lax.platform_dependent(
        state.pr_x, state.pr_y, ev.t, ev.active, geom.x_shift, geom.y_shift,
        geom.w_dyn, geom.h_dyn,
        cuda=functools.partial(_model_terms_gpu, **static),
        default=functools.partial(_model_terms, **static))
    model = state.model._replace(
        cx=cx_img, cy=cy_img, dx=terms.dx, dy=terms.dy,
        rot=terms.rot, div=terms.div, cnt=terms.cnt,
    )
    # total_p += p / divider (optimizer_rolling.h:328; argument order
    # rot, div, x, y per object_model.h:48-53).  A custom ``update_fn``
    # (the fast schedule) may size the step differently.
    if update_fn is None:
        model = model.update_accumulators(
            state.rot_div, state.div_div, state.x_div, state.y_div
        )
    else:
        model = update_fn(model, state)
    # Centroid back to event coordinates (optimizer_rolling.h:330-331).
    cx_ev = (model.cx - geom.x_shift) / scale
    cy_ev = (model.cy - geom.y_shift) / scale
    # Re-warp every event from scratch using the accumulated totals with the
    # production sign pattern (optimizer_rolling.h:340-344).
    pr_x, pr_y, nx, ny = project_4param_reinit(
        ev.x,
        ev.y,
        ev.t,
        state.pr_x,
        state.pr_y,
        -model.total_dx,
        -model.total_dy,
        cx_ev,
        cy_ev,
        model.total_div,
        -model.total_rot,
    )
    model = model._replace(cx=cx_ev, cy=cy_ev)  # :345-346
    return state._replace(
        pr_x=pr_x, pr_y=pr_y, nx=nx, ny=ny, model=model,
        iters=state.iters + 1,
    )


def _adaptive_loop(init, step_fn, cfg: OptimizerConfig):
    """OptimizerRolling::run's adaptive loop (optimizer_rolling.h:60-111),
    parametrized over the iteration body (untiled or tiled).

    ``init`` must carry .model, the four dividers, and .iters; ``step_fn``
    performs one iteration_step (splat -> model update -> re-warp)."""
    state = init._replace(
        x_div=jnp.float32(cfg.init_xy_divider),
        y_div=jnp.float32(cfg.init_xy_divider),
        rot_div=jnp.float32(cfg.init_rotdiv_divider),
        div_div=jnp.float32(cfg.init_rotdiv_divider),
        iters=jnp.int32(0),
    )
    # One unconditional first step (:73-74).
    state = step_fn(state)

    def cond(s):
        m = s.model
        dividers_open = (
            (s.x_div < cfg.xy_divider_cap)
            | (s.y_div < cfg.xy_divider_cap)
            | (s.rot_div < cfg.rotdiv_divider_cap)
            | (s.div_div < cfg.rotdiv_divider_cap)
        )
        small = (
            (jnp.abs(m.dx / s.x_div) < cfg.dx_tol)
            & (jnp.abs(m.dy / s.y_div) < cfg.dy_tol)
            & (jnp.abs(m.rot / s.rot_div) < cfg.rot_tol)
            & (jnp.abs(m.div / s.div_div) < cfg.div_tol)
        )
        over_max = (cfg.max_iter > 0) & (s.iters > cfg.max_iter)
        return dividers_open & ~small & ~over_max & (s.iters < cfg.iter_hard_cap)

    def body(s):
        old = (s.model.dx, s.model.dy, s.model.rot, s.model.div)
        s = step_fn(s)
        m = s.model
        # Divider doubling on sign flips (:98-101).
        return s._replace(
            x_div=jnp.where(m.dx * old[0] < 0, s.x_div * 2, s.x_div),
            y_div=jnp.where(m.dy * old[1] < 0, s.y_div * 2, s.y_div),
            rot_div=jnp.where(m.rot * old[2] < 0, s.rot_div * 2, s.rot_div),
            div_div=jnp.where(m.div * old[3] < 0, s.div_div * 2, s.div_div),
        )

    return lax.while_loop(cond, body, state)


def _totals4(m: MotionModel):
    return jnp.stack([m.total_rot, m.total_div, m.total_dx, m.total_dy])


def _fast_loop(init, step_fn, cfg: OptimizerConfig, seed=None):
    """Fast step-size schedule (OptimizerConfig.schedule == "fast").

    Same gradient signal and convergence tolerances as the reference
    schedule, but each parameter's step is a safeguarded secant: Newton on
    the root of the gradient component g(total), using the slope observed
    between the last two iterates.  Falls back to the reference step
    g/divider (with its sign-flip divider doubling) whenever the local
    slope is not concave or the secant is degenerate, and clamps to 4x the
    reference step so a noisy slope can never fling the warp.  Converges in
    roughly 1/3 the iterations of the divider bisection on typical scenes.

    ``step_fn(state, update_fn)`` must apply ``update_fn(model, state) ->
    model`` in place of update_accumulators.

    ``seed`` (optional (8,) f32 [slope_mem[4], prev_d[4]]) warm-starts the
    secant's SLOPE MEMORY from the previous slice's loop exit: curvature
    is a stable property of the objective across slices, unlike a cross-
    slice (g, d) difference quotient, which mixes in the objective shift
    from ~40% new events per retrigger.  With a valid seeded slope the
    FIRST step is already curvature-sized instead of the full divider-1
    gradient step.  Components with no usable slope (including the whole
    unseeded first call) take the reference step — so seed=None
    reproduces the original schedule exactly."""
    state = init._replace(
        x_div=jnp.float32(cfg.init_xy_divider),
        y_div=jnp.float32(cfg.init_xy_divider),
        rot_div=jnp.float32(cfg.init_rotdiv_divider),
        div_div=jnp.float32(cfg.init_rotdiv_divider),
        iters=jnp.int32(0),
    )
    prev_g0 = jnp.zeros(4, jnp.float32)
    prev_d0 = jnp.zeros(4, jnp.float32)
    slope0 = jnp.zeros(4, jnp.float32) if seed is None else seed[:4]

    tol = jnp.array(
        [cfg.rot_tol, cfg.div_tol, cfg.dx_tol, cfg.dy_tol], jnp.float32
    )

    def cond(carry):
        s, g, prev_d, _sl, exit_small = carry
        # A seeded first step can look converged against a STALE cross-slice
        # slope; refresh the slope pair in-slice once before allowing the
        # exit test (costs nothing unseeded: step 1 is the full reference
        # step and essentially never passes the tolerance).  Exception:
        # when even the REFERENCE divider step is below tolerance (the
        # parity schedule's own convergence test), the gradient is
        # genuinely tiny and the refresh buys nothing — well-seeded slices
        # on smooth motion exit after one iteration.
        ref_small = jnp.all(
            jnp.abs(g) / jnp.stack([s.rot_div, s.div_div, s.x_div, s.y_div])
            < 4.0 * tol
        )
        small = exit_small & ((s.iters >= 2) | ref_small)
        over_max = (cfg.max_iter > 0) & (s.iters > cfg.max_iter)
        return ~small & ~over_max & (s.iters < cfg.iter_hard_cap)

    def body(carry):
        s, prev_g, prev_d, slope_mem, _es = carry
        # The slope actually used for the PREVIOUS iteration's step (the
        # predicted-exit's relerr denominator model); ``slope_mem`` is
        # rebound to this iteration's slope after the step below.
        slope_used_prev = slope_mem

        def two_point(g):
            # In-slice two-point slope when a real previous step exists on
            # THIS objective; when the quotient is unusable (no step yet,
            # or non-concave), the carried slope memory fills in — on
            # smooth streams the memory is accurate and skips the
            # divider-1 flailing (bench mean_iters 3.94 -> 2.6).  Stale
            # slopes carry a tighter trust region (see ``lim`` below), so
            # small noisy windows cannot thrash on them
            # (test_fast_small_sensor_quality_bounded).
            slope2 = (g - prev_g) / prev_d
            stepped = jnp.abs(prev_d) > 0
            valid2 = stepped & jnp.isfinite(slope2) & (slope2 < 0)
            step_slope = jnp.where(valid2, slope2, slope_mem)
            return step_slope, valid2

        def update(model, st):
            g = jnp.stack([model.rot, model.div, model.dx, model.dy])
            ref = g / jnp.stack(
                [st.rot_div, st.div_div, st.x_div, st.y_div]
            )
            # In-slice two-point slope when a real previous step exists on
            # THIS objective; otherwise the carried slope memory.
            slope, valid2 = two_point(g)
            # 0.9 damping: the slope is a noisy two-point estimate on a
            # non-quadratic objective; biasing toward undershoot costs ~1
            # iteration but avoids basin-hopping on small/noisy windows.
            newton = -0.9 * g / slope
            # Trust region: a fresh in-slice quotient earns 4x the
            # reference step; a carried/stale slope only 1x — on small
            # noisy windows repeated memory-driven overshoots at 4x ref
            # thrash for tens of iterations, while clamping them to the
            # reference schedule's own step scale bounds the damage and
            # costs nothing on smooth streams (near convergence g, and
            # hence ref, is already small).
            lim = jnp.where(valid2, 4.0, 1.0) * jnp.abs(ref)
            ok = (slope < 0) & jnp.isfinite(newton)
            delta = jnp.where(ok, jnp.clip(newton, -lim, lim), ref)
            return model.add_totals(delta[0], delta[1], delta[2], delta[3])

        tot_before = _totals4(s.model)
        s = step_fn(s, update)
        m = s.model
        g = jnp.stack([m.rot, m.div, m.dx, m.dy])
        d = _totals4(m) - tot_before
        slope_mem, _ = two_point(g)
        # Keep the reference's divider doubling so the FALLBACK step keeps
        # shrinking on oscillation (it is also the secant's clamp scale).
        # Gated per component on a real previous step (|prev_d| > 0), which
        # on the unseeded first call reproduces the original no-doubling.
        def dbl(div, new, old_g, gate):
            return jnp.where(gate & (new * old_g < 0), div * 2, div)

        pdg = jnp.abs(prev_d) > 0
        s = s._replace(
            x_div=dbl(s.x_div, m.dx, prev_g[2], pdg[2]),
            y_div=dbl(s.y_div, m.dy, prev_g[3], pdg[3]),
            rot_div=dbl(s.rot_div, m.rot, prev_g[0], pdg[0]),
            div_div=dbl(s.div_div, m.div, prev_g[1], pdg[1]),
        )
        # Per-component exit decision for THIS step (consumed by cond).
        # Small DELTAS alone are not convergence: a secant step sized by an
        # overestimated slope (stale cross-slice memory, or a plateau
        # making the in-slice quotient (g_k - g_{k-1})/d steep while g
        # stays large) can be sub-tolerance far from the optimum, and
        # those small-but-persistent steps compound over many
        # reference-schedule iterations (off-bench rotdiv AEE 1.081 vs
        # 0.691 before this gate).  Each component must also pass the
        # reference-step gradient test |g|/divider < factor*tol — the
        # parity schedule's own convergence test, post-doubling dividers.
        # (Exempting fresh-quotient components was tried and rejected: the
        # harmful exits ride fresh quotients too, and it saved nothing.)
        exit_c = jnp.abs(d) < tol
        if cfg.exit_grad_factor > 0:
            gref = jnp.abs(g) / jnp.stack(
                [s.rot_div, s.div_div, s.x_div, s.y_div])
            exit_c = exit_c & (gref < cfg.exit_grad_factor * tol)
        if cfg.exit_predict_cap > 0:
            # Model-validated one-step-ahead exit (round-5): kill the
            # mode-4 "confirmation iteration".  The traced bench chain
            # (tools/trace_fastloop.py) shows 66% of slices spending a
            # last full splat on an iteration whose outcome the
            # secant's linear model already predicts: at the penultimate
            # iteration, predicted next delta <= 0.25*tol and predicted
            # next |g|/divider <= 0.52*tol for EVERY such slice.  Two
            # rejected designs framed this one: the raw linear
            # prediction alone is untrustworthy early (at iteration 2 it
            # predicts sub-tolerance deltas while the real next step is
            # 1-2.5x tol), and an observed-contraction predictor
            # (|d|^2/|prev_d|) never fires at all because the terminal
            # deltas OSCILLATE (sign-flipping overshoots) rather than
            # contract monotonically.  The discriminator that separates
            # the two regimes is the model's own one-step prediction
            # error, measured for free: relerr = |g - (prev_g +
            # slope_prev*prev_d)| / |prev_g|.  On safe exits it measures
            # <= 0.67; where prediction would be premature (iteration 2,
            # rot/div plateau crawls whose slope estimates are wrong —
            # the round-3 quality failure mode) it measures 0.5-4.6.  A
            # component may therefore exit, bypassing the current-delta
            # and current-gradient tests, when: the model predicted THIS
            # gradient well (relerr < 0.75), the predicted next step and
            # next reference step are both sub-tolerance, and the
            # current delta is within cap*tol (prediction only trusted
            # near convergence).  Seed-swept table: BASELINE.md round 5.
            g_pred = prev_g + slope_used_prev * prev_d
            relerr = jnp.abs(g - g_pred) / jnp.maximum(
                jnp.abs(prev_g), 1e-30)
            pred_next_g = g + slope_mem * d
            pred_next_d = jnp.abs(0.9 * pred_next_g /
                                  jnp.where(slope_mem < 0, slope_mem,
                                            -1e-30))
            divs = jnp.stack([s.rot_div, s.div_div, s.x_div, s.y_div])
            pred_next_gref = jnp.abs(pred_next_g) / divs
            pred_ok = (
                (jnp.abs(prev_d) > 0) & (relerr < 0.75)
                & (slope_mem < 0)
                & (pred_next_d < tol) & (pred_next_gref < tol)
                & (jnp.abs(d) < cfg.exit_predict_cap * tol)
            )
            exit_c = exit_c | pred_ok
        exit_small = jnp.all(exit_c)
        return (s, g, d, slope_mem, exit_small)

    # Unconditional first step (same body: with no seed, zero prev_d and
    # zero slope memory route every component to the reference step, as
    # the original schedule did).
    carry = body((state, prev_g0, prev_d0, slope0, jnp.bool_(False)))
    import os as _os
    if _os.environ.get("BF_DEBUG_FASTLOOP"):
        # Eager Python replica of the while loop (debug only; identical
        # math) — lets a harness log per-iteration internals.
        trace = []

        def _snap(c):
            s_, g_, d_, sl_, es_ = c
            trace.append(dict(
                iters=int(s_.iters), g=np.asarray(g_), d=np.asarray(d_),
                slope=np.asarray(sl_),
                divs=np.asarray([float(s_.rot_div), float(s_.div_div),
                                 float(s_.x_div), float(s_.y_div)]),
                exit_small=bool(es_),
                totals=np.asarray(_totals4(s_.model)),
            ))

        import numpy as np
        _snap(carry)
        while bool(cond(carry)):
            carry = body(carry)
            _snap(carry)
        _fast_loop.last_trace = trace
        final, g, d, slope_mem, _es = carry
        return final, jnp.concatenate([slope_mem, d])
    final, g, d, slope_mem, _es = lax.while_loop(cond, body, carry)
    return final, jnp.concatenate([slope_mem, d])


def _drive_loop(init, step_fn, cfg: OptimizerConfig, seed=None):
    """Dispatch on the configured schedule.  ``step_fn(state, update_fn)``.
    Returns (final_state, seed_out) where seed_out is the secant slope
    memory + last deltas at exit ((8,) zeros for the reference
    schedule)."""
    if cfg.schedule == "fast":
        return _fast_loop(init, step_fn, cfg, seed=seed)
    return (_adaptive_loop(init, lambda s: step_fn(s, None), cfg),
            jnp.zeros(8, jnp.float32))


def _run_optimizer(
    init: GlobalFlowState,
    ev: EventSlice,
    geom: SliceGeometry,
    scale: int,
    H: int,
    W: int,
    cfg: OptimizerConfig,
    axis_name=None,
    seed=None,
):
    """The optimizer loop over _iteration_step.  Returns (final_state,
    seed_out)."""
    step = lambda s, u: _iteration_step(s, ev, geom, scale, H, W, axis_name,
                                        update_fn=u)
    return _drive_loop(init, step, cfg, seed=seed)


def process_slice(
    ev: EventSlice,
    last_model: MotionModel,
    cfg: OptimizerConfig,
    sensor: SensorConfig,
    warm_start: bool = True,
    axis_name=None,
    seed=None,
    bbox=None,
    n_valid=None,
    start_model=None,
) -> SliceResult:
    """Process one slice end to end — jit over static (capacity, scale, res).

    Mirrors the per-slice sequence of DVS_flow::recompute (dvs_flow.h:207-235):
    set_cloud (reset + geometry), set_model warm start unless disabled, run,
    then per-event compute_uv.  ``warm_start`` corresponds to !stm_disable
    (dvs_flow.h:218-219) and is a static flag.

    ``start_model`` (optional) replaces ``last_model`` as the RUN
    branch's optimizer starting point only (the extrapolated warm start,
    OptimizerConfig.warm_extrapolate): the skip branch — whose output IS
    the slice's warp of record when gated — and the noise/gate logic
    keep ``last_model``, so gated slices never drift on extrapolations
    that no optimization corrected.
    """
    scale = cfg.scale
    H, W = static_image_shape(scale, sensor)

    if bbox is not None:
        # Host-precomputed bbox (order-independent; the window is a
        # contiguous range of the recording): skips four masked reductions.
        geom = geometry_from_bbox(bbox[0], bbox[1], bbox[2], bbox[3],
                                  scale, sensor, cfg.min_window_fraction)
    else:
        geom = slice_geometry(ev, scale, sensor, cfg.min_window_fraction,
                              axis_name)

    model = last_model if warm_start else MotionModel.zero()
    opt_start = model if (start_model is None or not warm_start) \
        else start_model

    if n_valid is not None:
        n_events = jnp.asarray(n_valid, jnp.int32)
    else:
        n_events = jnp.sum(ev.valid.astype(jnp.int32))
        if axis_name is not None:
            n_events = lax.psum(n_events, axis_name)
    too_few = n_events < cfg.min_events  # optimizer_rolling.h:57
    ran = ~geom.window_small & ~too_few

    # set_cloud resets every event: pr = fr, n = 0 (event.h:54-59).
    # Warm-start warp (set_model, optimizer_rolling.h:289-299): re-apply
    # the previous slice's accumulated warp about its event-coordinate
    # centroid.  With a zero model this is the identity.
    def _warp_init(m):
        pr_x, pr_y, nx, ny = project_4param_reinit(
            ev.x, ev.y, ev.t, ev.x, ev.y,
            -m.total_dx, -m.total_dy, m.cx, m.cy,
            m.total_div, -m.total_rot,
        )
        return GlobalFlowState(
            pr_x=pr_x, pr_y=pr_y, nx=nx, ny=ny, model=m,
            x_div=jnp.float32(1), y_div=jnp.float32(1),
            rot_div=jnp.float32(1), div_div=jnp.float32(1),
            iters=jnp.int32(0),
        )

    if opt_start is model:
        # Plain warm start: one shared warp feeds both branches (the
        # exact pre-round-5 program — keeps golden/parity ulps).
        init = _warp_init(model)
        final, seed_out = lax.cond(
            ran,
            lambda s: _run_optimizer(s, ev, geom, scale, H, W, cfg,
                                     axis_name, seed=seed),
            lambda s: (s, jnp.zeros(8, jnp.float32)),
            init,
        )
    else:
        # Extrapolated start: the run branch warps + optimizes from
        # opt_start; the skip branch keeps the unextrapolated model.
        final, seed_out = lax.cond(
            ran,
            lambda _: _run_optimizer(_warp_init(opt_start), ev, geom,
                                     scale, H, W, cfg, axis_name,
                                     seed=seed),
            lambda _: (_warp_init(model), jnp.zeros(8, jnp.float32)),
            0,
        )
    final_model = final.model
    pr_x, pr_y, nx, ny = final.pr_x, final.pr_y, final.nx, final.ny
    iters = final.iters

    # The degenerate-window gate marks every event noise
    # (optimizer_rolling.h:52-54); the too-few gate does not.
    noise = ev.noise | (geom.window_small & ev.valid)

    u, v = compute_uv(nx, ny)
    return SliceResult(
        model=final_model,
        pr_x=pr_x,
        pr_y=pr_y,
        nx=nx,
        ny=ny,
        u=u,
        v=v,
        noise=noise,
        iters=iters,
        ran=ran,
        window_small=geom.window_small,
        seed=seed_out,
    )


def final_time_image(
    ev: EventSlice,
    res: SliceResult,
    scale: int,
    sensor: SensorConfig,
) -> jnp.ndarray:
    """Time image of the converged (motion-compensated) slice — the decoded
    output checked by the PSNR gate (BASELINE.md)."""
    H, W = static_image_shape(scale, sensor)
    geom = slice_geometry(ev, scale, sensor)
    active = ev.valid & ~res.noise
    return time_image(
        res.pr_x, res.pr_y, ev.t, active, scale,
        geom.x_shift, geom.y_shift, geom.w_dyn, geom.h_dyn, H, W,
    )
