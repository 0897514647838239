"""Accuracy gates for the fast step-size schedule (OptimizerConfig.schedule
== "fast"): same gradient signal and tolerances as the reference divider
schedule, secant-sized steps.  bench.py measures with this schedule, so the
gates here are what make that headline number honest — the fast schedule
must land on the same converged warp, in no more iterations."""

import numpy as np

from better_flow.config import (
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
)
from better_flow.io.synthetic import synthetic_events
from better_flow.runtime.scan_pipeline import compensate_recording_scan


def _cfg(sched, **opt):
    return PipelineConfig(
        sensor=SensorConfig(24, 32),
        slice=SliceConfig(max_events=4000, span_ns=int(0.1e9),
                          refresh_events=1500, refresh_time_ns=int(0.04e9)),
        optimizer=OptimizerConfig(scale=3, min_events=500, schedule=sched,
                                  **opt),
    )


def test_fast_matches_reference_production_sensor():
    """The regime bench.py measures: full 180x240 sensor, production slice
    geometry.  Here the gradient signal is clean and the secant must land
    on the same converged warp in materially fewer iterations."""
    d = synthetic_events(200_000, duration_s=0.2, res_x=180, res_y=240,
                         vx=60.0, vy=-40.0, rot=0.12, div=0.05,
                         n_points=800, seed=42)  # 1 Mev/s: bench density
    cfg_ref = PipelineConfig(optimizer=OptimizerConfig(schedule="reference"))
    cfg_fast = PipelineConfig(optimizer=OptimizerConfig.fast())  # bench cfg
    ref = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg_ref)
    fast = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg_fast)
    ok = ~(ref["noise"] | fast["noise"])
    speed = float(np.hypot(ref["u"][ok], ref["v"][ok]).mean())
    du = np.abs(fast["u"][ok] - ref["u"][ok])
    dv = np.abs(fast["v"][ok] - ref["v"][ok])
    # Same converged warp: sub-percent flow deviation...
    assert np.median(du) < 0.01 * speed, (np.median(du), speed)
    assert np.median(dv) < 0.01 * speed
    # ...at no accuracy cost vs ground truth...
    def aee_med(out):
        m = ~out["noise"]
        return float(np.median(
            np.hypot(out["u"][m] - d["u"][m], out["v"][m] - d["v"][m])))
    assert aee_med(fast) <= 1.02 * aee_med(ref), (aee_med(fast), aee_med(ref))
    # ...in materially fewer iterations.
    assert fast["iters"].sum() <= 0.7 * ref["iters"].sum(), (
        int(fast["iters"].sum()), int(ref["iters"].sum()))


def test_fast_small_sensor_quality_bounded():
    """On tiny windows the gradients are noisy and the secant falls back to
    the reference step most of the time — no speedup to claim, but accuracy
    vs ground truth must stay within a small factor of the reference
    schedule and iterations must not blow up."""
    d = synthetic_events(24000, duration_s=0.4, res_x=24, res_y=32,
                         n_points=80, seed=5, vx=4.0, vy=-3.0, rot=0.5,
                         div=0.15)
    ref = compensate_recording_scan(d["x"], d["y"], d["t_ns"], _cfg("reference"))
    fast = compensate_recording_scan(d["x"], d["y"], d["t_ns"], _cfg("fast"))

    def aee(out):
        ok = ~out["noise"]
        return float(np.median(
            np.hypot(out["u"][ok] - d["u"][ok], out["v"][ok] - d["v"][ok])
        ))

    assert aee(fast) <= 1.2 * aee(ref), (aee(fast), aee(ref))
    assert fast["iters"].sum() <= 1.1 * ref["iters"].sum()


def _prod_cfg(sched):
    opt = (OptimizerConfig.fast() if sched == "fast"
           else OptimizerConfig(schedule="reference"))
    return PipelineConfig(optimizer=opt)


def _aee_med(out, d, extra_mask=None):
    m = ~out["noise"]
    if extra_mask is not None:
        m &= extra_mask
    return float(np.median(
        np.hypot(out["u"][m] - d["u"][m], out["v"][m] - d["v"][m])))


def test_fast_offbench_rotdiv_scene():
    """Off-bench gate 1 (round-2 verdict): a rot/div-dominated production-
    sensor scene with a seed different from bench.py's 42.  Rotation-heavy
    warm-start chains are chaotic, so per-event flow parity vs the
    reference schedule is not an honest gate — accuracy vs ground truth
    and the iteration budget are."""
    d = synthetic_events(150_000, duration_s=0.2, res_x=180, res_y=240,
                         vx=10.0, vy=8.0, rot=0.6, div=0.12,
                         n_points=600, seed=777)
    ref = compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                    _prod_cfg("reference"))
    fast = compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                     _prod_cfg("fast"))
    assert _aee_med(fast, d) <= 1.05 * _aee_med(ref, d), (
        _aee_med(fast, d), _aee_med(ref, d))
    assert fast["iters"].sum() <= ref["iters"].sum(), (
        int(fast["iters"].sum()), int(ref["iters"].sum()))


def test_fast_offbench_noisy_stream():
    """Off-bench gate 2: the dvs_sim sensor-realistic stream (threshold
    mismatch, refractory, BA noise, hot pixels, bursts) with an off-bench
    seed.  fast() carries a known, documented ~1.05-1.16x AEE trade-off
    across noisy-stream seeds (OptimizerConfig.fast docstring) — the gate
    bounds it at 1.2x on this seed so regressions beyond the documented
    band fail.  fast_accurate() must hold reference-equal accuracy on the
    same stream.  Neither may blow the iteration budget."""
    from better_flow.io.dvs_sim import dvs_events

    d = dvs_events(120_000, duration_s=0.25, res_x=180, res_y=240,
                   vx=45.0, vy=-30.0, rot=0.1, div=0.04, seed=31)
    sig = ~d["is_noise"]
    ref = compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                    _prod_cfg("reference"))
    fast = compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                     _prod_cfg("fast"))
    acc = compensate_recording_scan(
        d["x"], d["y"], d["t_ns"],
        PipelineConfig(optimizer=OptimizerConfig.fast_accurate()))
    a_r = _aee_med(ref, d, sig)
    a_f = _aee_med(fast, d, sig)
    a_a = _aee_med(acc, d, sig)
    assert a_f <= 1.2 * a_r, (a_f, a_r)
    assert a_a <= 1.02 * a_r, (a_a, a_r)
    assert fast["iters"].sum() <= ref["iters"].sum()
    assert acc["iters"].sum() <= 0.7 * ref["iters"].sum()


def test_fast_rotdiv_margin_canary():
    """Distance-to-cliff canary on the rotdiv quality axis (round-4).

    Calibration, measured at round 4 on this scene: the SHIPPED factor-4
    preset sits at ~1.01x the reference schedule's AEE against the 1.05x
    gate (headroom ~0.04); one notch looser (factor 6) measures ~1.13x —
    i.e. the shipped config is LESS than one exit_grad_factor notch from
    failing its gate, so pass/fail at factor 4 alone would give no early
    warning.  Two rails:

    * the shipped preset must keep at least HALF its measured headroom
      (ratio <= 1.03) — schedule drift that erodes quality margin fails
      here first, while the production gate (1.05, test above) still
      passes;
    * factor 6's known degraded-but-bounded behavior must not collapse
      into chain divergence (ratio <= 1.3) — the gross-cliff rail.
    """
    d = synthetic_events(150_000, duration_s=0.2, res_x=180, res_y=240,
                         vx=10.0, vy=8.0, rot=0.6, div=0.12,
                         n_points=600, seed=777)
    ref = compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                    _prod_cfg("reference"))
    f4 = compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                   _prod_cfg("fast"))
    f6 = compensate_recording_scan(
        d["x"], d["y"], d["t_ns"],
        PipelineConfig(optimizer=OptimizerConfig.fast(exit_grad_factor=6.0)))
    a_r, a_4, a_6 = _aee_med(ref, d), _aee_med(f4, d), _aee_med(f6, d)
    print(f"[margin canary] rotdiv AEE ratios vs reference: "
          f"factor4={a_4 / a_r:.3f} (canary 1.03, gate 1.05) "
          f"factor6={a_6 / a_r:.3f} (rail 1.3)")
    assert a_4 <= 1.03 * a_r, (
        f"fast-preset rotdiv margin halved: factor-4 AEE ratio "
        f"{a_4 / a_r:.3f} > 1.03 (production gate is 1.05)")
    assert a_6 <= 1.3 * a_r, (
        f"factor-6 rotdiv behavior collapsed: ratio {a_6 / a_r:.3f}")


def test_predicted_exit_parity_and_effect():
    """The model-validated one-step-ahead exit (exit_predict_cap) only
    adds an exit path to _fast_loop.  Pin (a) on one slice, unseeded and
    with an explicit secant-slope seed: the knob never needs more
    iterations than the plain fast exit, and where it exits early the
    totals stay within a few tolerance steps of the plain exit's; and (b)
    over a recording, the knob only ever REDUCES iterations."""
    import jax.numpy as jnp

    from better_flow.core.events import make_slice
    from better_flow.core.model import MotionModel
    from better_flow.models.global_flow import process_slice

    d = synthetic_events(3000, duration_s=0.1, res_x=24, res_y=32,
                         n_points=60, seed=3, vx=8.0, vy=-5.0, rot=0.05,
                         div=0.02)
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64),
                    capacity=3072)
    mk = lambda cap: OptimizerConfig.fast(scale=3, min_events=500,
                                          exit_predict_cap=cap)
    seeds = [None,
             jnp.asarray([-2e3, -2e3, -40.0, -40.0, 0, 0, 0, 0],
                         jnp.float32)]
    for seed in seeds:
        plain = process_slice(ev, MotionModel.zero(), mk(0.0),
                              SensorConfig(24, 32), seed=seed)
        pred = process_slice(ev, MotionModel.zero(), mk(4.0),
                             SensorConfig(24, 32), seed=seed)
        assert int(pred.iters) <= int(plain.iters), (int(pred.iters),
                                                     int(plain.iters))
        opt = mk(4.0)
        for f, tol in (("total_dx", opt.dx_tol), ("total_dy", opt.dy_tol),
                       ("total_rot", opt.rot_tol),
                       ("total_div", opt.div_tol)):
            a = float(getattr(plain.model, f))
            b = float(getattr(pred.model, f))
            assert abs(a - b) <= 8 * tol, (f, a, b)
    # (b) never more iterations than the plain fast exit.
    d2 = synthetic_events(24000, duration_s=0.4, res_x=24, res_y=32,
                          n_points=80, seed=7, vx=6.0, vy=-4.0, rot=0.1,
                          div=0.04)
    plain = compensate_recording_scan(d2["x"], d2["y"], d2["t_ns"],
                                      _cfg("fast"))
    pred = compensate_recording_scan(
        d2["x"], d2["y"], d2["t_ns"],
        PipelineConfig(
            sensor=SensorConfig(24, 32),
            slice=SliceConfig(max_events=4000, span_ns=int(0.1e9),
                              refresh_events=1500,
                              refresh_time_ns=int(0.04e9)),
            optimizer=OptimizerConfig(schedule="fast", scale=3,
                                      min_events=500,
                                      exit_predict_cap=4.0)))
    assert int(pred["iters"].sum()) <= int(plain["iters"].sum()), (
        int(pred["iters"].sum()), int(plain["iters"].sum()))


def test_fast_degenerate_and_gates_identical():
    """The window/count gates and noise marking are schedule-independent."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.integers(0, int(3e8), 5000)).astype(np.int64)
    x = np.full(5000, 3.0)
    y = np.full(5000, 4.0)
    ref = compensate_recording_scan(x, y, t, _cfg("reference"))
    fast = compensate_recording_scan(x, y, t, _cfg("fast"))
    np.testing.assert_array_equal(ref["noise"], fast["noise"])
    assert fast["noise"].all()


def test_fast_throughput_domain_gates():
    """fast_throughput() (fast + the model-validated predicted exit) is
    a DOMAIN-LIMITED preset: on its documented domain it must hold
    fast()-grade quality at materially fewer iterations, and outside it
    (rot/div-dominated scenes) its documented degradation must stay
    bounded.  Seeds beyond the sweep's would drift these numbers, so the
    gates bind the same seeds as the round-5 table (BASELINE.md)."""
    ft = OptimizerConfig.fast_throughput()

    def run(d, opt):
        return compensate_recording_scan(
            d["x"], d["y"], d["t_ns"], PipelineConfig(optimizer=opt))

    # Production family: seed-mean quality within 5% of the reference
    # schedule, every seed within 12%, >=10% fewer iterations than
    # fast() in total.
    ratios, it_ft, it_f = [], 0, 0
    for seed in (42, 101, 202):
        d = synthetic_events(200_000, duration_s=0.2, res_x=180,
                             res_y=240, vx=60.0, vy=-40.0, rot=0.12,
                             div=0.05, n_points=800, seed=seed)
        ref = run(d, OptimizerConfig(schedule="reference"))
        fast = run(d, OptimizerConfig.fast())
        out = run(d, ft)
        r = _aee_med(out, d) / _aee_med(ref, d)
        ratios.append(r)
        assert r <= 1.12, (seed, r)
        it_ft += int(out["iters"].sum())
        it_f += int(fast["iters"].sum())
    assert np.mean(ratios) <= 1.05, ratios
    assert it_ft <= 0.9 * it_f, (it_ft, it_f)
    # Documented exclusion: the rotdiv gate scene degrades (that is WHY
    # this is not the default) but must not collapse into chain
    # divergence.
    d = synthetic_events(150_000, duration_s=0.2, res_x=180, res_y=240,
                         vx=10.0, vy=8.0, rot=0.6, div=0.12,
                         n_points=600, seed=777)
    ref = run(d, OptimizerConfig(schedule="reference"))
    out = run(d, ft)
    assert _aee_med(out, d) <= 1.5 * _aee_med(ref, d)
