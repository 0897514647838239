"""Typed configuration for the whole framework.

The reference spreads configuration over three tiers: compile-time macros
(common.h:38-64, bf_motion_compensator.cpp:6-10), a hand-rolled CLI parser
(bf_motion_compensator.cpp:36-130) and ROS params (bf_visualizer.cpp:275-292).
Here a single set of frozen dataclasses feeds both the CLI and the library;
every field that shapes a jitted computation is a static (hashable) jit-time
constant.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# --- Global numeric conventions (reference: common.h:58-64) -----------------
# Z (time) component of the direction vector; "can be anything, as long as
# variables do not overflow" (common.h:58-60).
NZ: int = 127
# The event timestamp is divided by T_DIVIDER (integer), converted to float
# and additionally divided by 10000 (common.h:62-64, event.h:164-168).
T_DIVIDER: int = 1
# Nanoseconds per "warp time unit": pr = fr - (n/nz) * (t/T_DIVIDER) / 1e4.
WARP_TIME_DIV: float = 10000.0
# px/s per unit n at nz=1: u = nx * UV_FACTOR / nz  (event.h:131-142).
UV_FACTOR: float = 1e9 / (T_DIVIDER * 10000.0)  # = 1e5

# Nonzero threshold used by every masked image op (accel_lib.h:534, 599,
# object_model.cpp:22, 114).
NONZERO_EPS: float = 0.000001


def from_sec(seconds: float) -> int:
    """Seconds -> integer nanoseconds (reference FROM_SEC, common.h:35)."""
    return int(1_000_000_000 * seconds)


def from_ms(ms: float) -> int:
    """Milliseconds -> integer nanoseconds (reference FROM_MS, common.h:36)."""
    return int(1_000_000 * ms)


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Camera geometry.

    The reference hardcodes RES_X=180, RES_Y=240 (common.h:39-40) with the
    x axis indexing image *rows* and y indexing *columns* (events are read
    with x/y swapped relative to the file, event_file.h:60).  Here the
    resolution is configuration so DAVIS 346x260 and megapixel sensors are
    first-class (BASELINE.json configs 3 and 5).
    """

    res_x: int = 180  # rows
    res_y: int = 240  # cols


@dataclasses.dataclass(frozen=True)
class SliceConfig:
    """Sliding-slice geometry and retrigger thresholds.

    Mirrors the reference's compile-time EVENT_WIDTH/TIME_WIDTH
    (bf_motion_compensator.cpp:6-7) and runtime refresh flags (:9-10).
    """

    max_events: int = 50_000          # ring capacity (EVENT_WIDTH)
    span_ns: int = from_sec(0.2)      # time-span eviction (TIME_WIDTH)
    refresh_events: int = 20_000      # retrigger on this many new events
    refresh_time_ns: int = from_sec(0.033)  # or on this much elapsed time


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Global 4-parameter optimizer settings (optimizer_rolling.h).

    ``scale`` is the image super-resolution factor (odd; assert at
    optimizer_rolling.h:274).  ``max_iter`` < 0 means unbounded, matching
    set_maxiter(-1) (dvs_flow.h:109).  The divider schedule and convergence
    thresholds transcribe optimizer_rolling.h:48-101.
    """

    scale: int = 3
    max_iter: int = -1
    min_events: int = 1000            # size gate (optimizer_rolling.h:57)
    # Initial adaptive-step dividers (optimizer_rolling.h:61-63).
    init_xy_divider: float = 1.0
    init_rotdiv_divider: float = 10_000.0
    # Loop continues while any divider is below its cap (:76-79).
    xy_divider_cap: float = 32.0 * 10.0
    rotdiv_divider_cap: float = 32.0 * 1000.0
    # Delta convergence thresholds (:81-84).
    dx_tol: float = 1e-5
    dy_tol: float = 1e-5
    rot_tol: float = 1e-4
    div_tol: float = 1e-1
    # Window-size gate: skip when both scaled window dims are below
    # scale*RES/15 (optimizer_rolling.h:49; integer division).
    min_window_fraction: int = 15
    # Step-size schedule: "reference" transcribes the sign-flip divider
    # doubling of optimizer_rolling.h:60-111 (bisection-like, ~log2 steps
    # per parameter).  "fast" keeps the same per-iteration gradient signal
    # and the same convergence tolerances but sizes each step with a
    # safeguarded per-parameter secant (Newton on the gradient root,
    # clamped to 4x the reference step, reference fallback when the local
    # slope isn't concave) — typically 2-3x fewer iterations for the same
    # converged warp.  Accuracy-gated against the reference schedule in
    # tests/test_fast_schedule.py.
    schedule: str = "reference"
    # Gradient-qualified exit for the fast schedule (0 = off): exit only
    # when, in addition to sub-tolerance DELTAS, the reference step
    # |g|/divider is below exit_grad_factor * tol — the parity schedule's
    # own convergence test.  With secant steps a trust-region-clamped step
    # can be tiny while the gradient is still large; on rot/div-dominated
    # scenes those small-but-persistent steps compound over many reference
    # iterations, and exiting on them cost 1.56x AEE off-bench (the
    # round-2 gate gap).  Ignored by the reference schedule (whose exit IS
    # this test at factor 1).
    exit_grad_factor: float = 0.0
    # (round-5) The former ``exit_delta_factor`` knob (relax the delta
    # exit test to factor*tol) was REMOVED after the seed sweep
    # (tools/sweep_exit.py, BASELINE.md round 5): factors 1.1-1.5 save
    # under 3% of iterations while degrading the noisy-stream seed-mean
    # (the round-4 single-scene "chaos" was warm-start chain noise, band
    # ~±0.25 per seed, stable seed-means); factors >= 2 save ~10% but
    # systematically under-converge rot/div-dominated scenes (gate seed
    # 777: 1.25x AEE vs the 1.05 gate).  Every useful operating point it
    # could express is dominated by exit_predict_cap below, which
    # validates its exit prediction against the secant model instead of
    # blindly widening the tolerance band.
    # Model-validated one-step-ahead exit for the fast schedule (0 = off;
    # round-5).  The traced bench chain (tools/trace_fastloop.py) shows
    # 66% of slices spending their LAST full splat+finish on an
    # iteration whose outcome the secant's linear model already predicts.
    # With this cap > 0, a component may exit — bypassing the delta and
    # gradient tests — when (a) the linear model predicted THIS
    # iteration's gradient well (one-step prediction error < 0.75 of the
    # previous gradient — measured <= 0.67 on every safe exit, 0.5-4.6
    # where prediction would be premature), (b) the predicted next step
    # AND next reference step are both sub-tolerance, and (c) the current
    # delta is within cap*tol.  MEASURED DECISION (round-5, BASELINE.md
    # seed sweep + trace analysis): on the bench/production regime this
    # cuts mean_iters 4.04 -> 3.24 (-20%) at ~1.03x AEE — but on rot/div-
    # dominated scenes the terminal iterates OSCILLATE with 0.6-1.9*tol
    # of net future travel that NO one-step predictor can see (sampled
    # gradients pass near zero mid-swing: the rotdiv-777 trace fires with
    # predicted-gradient 0.04*tol yet 1.5*tol of travel remaining), so
    # the rotdiv gate degrades 1.02 -> 1.31x AEE.  The presets therefore
    # keep it OFF; it is sound for deployments on translation-dominated
    # streams that can bound rot/div externally.  Ignored by the
    # reference schedule.
    exit_predict_cap: float = 0.0
    # Extrapolated warm start (round-5; 0 = off, i.e. the reference's
    # plain warm start).  The reference warm-starts each slice from the
    # previous slice's converged model (dvs_flow.h:218-219); on smooth
    # streams the optimum still DRIFTS slice to slice (scene evolution:
    # ~5-10x tolerance of first-iteration delta on the bench chain), and
    # the optimizer spends its iteration budget re-walking that drift
    # every slice.  With alpha > 0 the scan path starts the optimizer at
    # model + alpha*(model_k - model_{k-1}) — a linear extrapolation of
    # the converged totals' trajectory — while gated/skipped slices and
    # the warm-start warp of record keep the UNextrapolated model (the
    # carry never random-walks through gaps, and a skipped slice's
    # output warp is exactly the reference's).  This changes only the
    # optimizer's STARTING point: every convergence test (tolerances,
    # gradient qualification) is unchanged.  MEASURED DEAD END for
    # throughput (round-5, kept so it is not re-derived): bench-chain
    # mean_iters 4.04 -> 3.96 at alpha=1.0 — the slope-seeded first
    # step already walks the drift efficiently, and the iteration
    # budget is spent on terminal refinement, which a better start
    # cannot shorten.  alpha=0.5 measured quality-noisy on the rotdiv
    # chain (the usual warm-start chain chaos).  Scan-path only
    # (streaming/tiled keep the reference warm start).
    warm_extrapolate: float = 0.0
    # Hard bound on lax.while_loop iterations when max_iter < 0.  The
    # reference's divider caps guarantee termination (each divider at most
    # doubles ~9 times per parameter before its cap) but we bound the device
    # loop defensively; 250 is far above anything observed.
    iter_hard_cap: int = 250

    @classmethod
    def fast(cls, **overrides) -> "OptimizerConfig":
        """The canonical fast preset used by bench.py: secant schedule with
        20x relaxed convergence tolerances and the gradient-qualified exit
        at exit_grad_factor=4.
        The reference's tolerances demand 1e-5 px warp precision — two
        orders below anything visible in the flow.  Round-2 shipped the
        20x tolerances with a delta-only exit; the round-3 off-bench gates
        caught that combination exiting at 1.56x AEE on a rot/div-dominated
        scene (a stale cross-slice slope can overestimate curvature so the
        secant step goes sub-tolerance while the gradient is still large),
        which the gradient qualification fixes at ~+0.4 iterations/slice
        on the bench stream (rotdiv AEE 0.696 vs reference schedule 0.691).
        Factor sweep: 8 halves the iteration cost but sits on a quality
        cliff — on the dvs_sim noisy GOLDEN scene (seed 11) one bursty
        slice exits between 4x and 8x tol and the warm-start chain then
        diverges from the C++ binary (corr 0.9986 -> 0.48, signal AEE
        0.116 -> 0.509); 16 also fails the rotdiv gate (1.09x).  4 holds
        every gate with margin.  Residual known trade-off: on
        sensor-noise streams (dvs_sim) the preset measures ~1.05-1.16x the
        reference schedule's AEE across stream seeds (still ~0.4% of mean
        speed); use fast_accurate() when that matters."""
        kw = dict(schedule="fast", dx_tol=2e-4, dy_tol=2e-4,
                  rot_tol=2e-3, div_tol=2.0, exit_grad_factor=4.0)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def fast_throughput(cls, **overrides) -> "OptimizerConfig":
        """fast() plus the model-validated one-step-ahead exit
        (exit_predict_cap=4) — for TRANSLATION-DOMINATED deployments.
        Round-5 seed table (AEE ratio vs the reference schedule, mean /
        worst over 5 seeds; iterations as a fraction of the reference
        schedule's):

        * production scenes: 1.009 / 1.085 at 0.325 iterfrac (fast():
          1.012 / 1.021 at 0.402 — ~19% fewer iterations, equal
          seed-mean quality);
        * dvs_sim sensor-noise streams: 1.017 / 1.089 (BETTER than
          fast()'s 1.058 / 1.175) at 0.350;
        * rot/div-DOMINATED scenes: 1.181 / 1.358 — the documented
          exclusion.  The terminal iterates there oscillate with
          0.6-1.9x tolerance of net future travel that no one-step
          predictor can see (exit_predict_cap docstring above), so this
          preset is wrong for spin/zoom-heavy scenes; fast() or
          fast_accurate() cover them.

        Gate test: tests/test_fast_schedule.py::
        test_fast_throughput_domain_gates."""
        kw = dict(exit_predict_cap=4.0)
        kw.update(overrides)
        return cls.fast(**kw)

    @classmethod
    def fast_accurate(cls, **overrides) -> "OptimizerConfig":
        """Fast schedule tuned for reference-equal accuracy: 10x tolerances
        with the gradient-qualified exit at factor 1.  Measured
        at-or-better AEE than the reference schedule on every gate scene
        including sensor-noise streams (noisy seeds 31/7/99: 0.163/0.185/
        0.257 vs reference 0.170/0.185/0.250), at ~15-20% more iterations
        than fast() — still ~2.5x fewer than the reference schedule."""
        kw = dict(schedule="fast", dx_tol=1e-4, dy_tol=1e-4,
                  rot_tol=1e-3, div_tol=1.0, exit_grad_factor=1.0)
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end streaming pipeline configuration (DVS_flow equivalent)."""

    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    slice: SliceConfig = dataclasses.field(default_factory=SliceConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    # Do not warm-start from the previous slice's model (--stm-disable,
    # bf_motion_compensator.cpp:46, dvs_flow.h:137-139).
    stm_disable: bool = False
    # Accumulate processed slices for offline output (dvs_flow.h:100-103).
    accumulate: bool = False
    # Optional picture/video generation (dvs_flow.h:114-135).
    generate_pictures: bool = False
    img_prefix: str = "./"
    generate_video: bool = False
    video_name: str = "./out.mp4"
    video_fps: int = 60
    quiet: bool = True
    # Accumulate the warp totals in float64 (requires jax x64 mode).  The
    # reference keeps its accumulators in double (object_model.h:10-13); the
    # default f32 carry emulates that with Kahan compensation, which is
    # usually indistinguishable — this flag makes the carry exactly double
    # for rot/div-dominated chains where the residual drift matters
    # (PARITY.md "Known behavioural divergence").  The per-event warp stays
    # f32 in both modes (ops/warp.project_4param_reinit entry casts).
    f64_totals: bool = False

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def low_latency_config() -> PipelineConfig:
    """The ROS live preset: 30k events / 0.07 s slices, scale 1, max 10
    iterations (bf_visualizer.cpp:33-34, 102-104)."""
    return PipelineConfig(
        slice=SliceConfig(
            max_events=30_000,
            span_ns=from_sec(0.07),
            refresh_events=30_000,
            refresh_time_ns=from_sec(0.05),
        ),
        optimizer=OptimizerConfig(scale=1, max_iter=10),
    )
