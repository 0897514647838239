"""Global 4-parameter optimizer: parity vs the naive transcription and
functional behaviour (convergence, gates, warm start)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from better_flow.config import NZ, OptimizerConfig, SensorConfig, UV_FACTOR
from better_flow.core.events import make_slice
from better_flow.core.model import MotionModel
from better_flow.io.synthetic import synthetic_events
from better_flow.models.global_flow import (
    final_time_image,
    process_slice,
    slice_geometry,
)
from better_flow.ops.reductions import nonzero_average

import naive_ref

SMALL = SensorConfig(res_x=24, res_y=32)


def _small_scene(n=1500, seed=1, vx=18.0, vy=-12.0, rot=0.0, div=0.0):
    d = synthetic_events(
        n, duration_s=0.1, res_x=SMALL.res_x, res_y=SMALL.res_y,
        vx=vx, vy=vy, rot=rot, div=div, n_points=60, seed=seed,
    )
    return d


def _naive_run(d, scale=3, max_iter=-1):
    ev = naive_ref.NaiveEvents(
        d["x"].astype(np.float64),
        d["y"].astype(np.float64),
        d["t_ns"].astype(np.float64),
        np.zeros(len(d["x"]), bool),
    )
    opt = naive_ref.NaiveOptimizerRolling(res_x=SMALL.res_x, res_y=SMALL.res_y)
    opt.set_cloud(ev, scale)
    opt.max_itercount = max_iter
    opt.set_model(naive_ref.NaiveModel())
    opt.run()
    return opt


def _jit_run(d, scale=3, max_iter=-1):
    cfg = OptimizerConfig(scale=scale, max_iter=max_iter)
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64))
    res = process_slice(ev, MotionModel.zero(), cfg, SMALL)
    return ev, res, cfg


def test_single_iteration_parity():
    """One constrained iteration matches the naive model update closely."""
    d = _small_scene()
    naive = _naive_run(d, max_iter=1)
    ev, res, _ = _jit_run(d, max_iter=1)
    assert int(res.iters) == naive.itercount
    m = res.model
    np.testing.assert_allclose(float(m.total_dx), naive.model.total_dx, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(float(m.total_dy), naive.model.total_dy, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(float(m.total_rot), naive.model.total_rot, rtol=5e-3, atol=1e-7)
    np.testing.assert_allclose(float(m.total_div), naive.model.total_div, rtol=5e-3, atol=1e-7)
    assert int(m.cnt) == naive.model.cnt


def test_full_run_parity():
    """The full adaptive loop tracks the naive run (f32 vs f64 drift aside)."""
    d = _small_scene()
    naive = _naive_run(d)
    ev, res, _ = _jit_run(d)
    assert bool(res.ran)
    # iteration counts should agree exactly on this well-conditioned scene
    assert abs(int(res.iters) - naive.itercount) <= 1
    np.testing.assert_allclose(
        float(res.model.total_dx), naive.model.total_dx, rtol=0.05, atol=2e-3
    )
    np.testing.assert_allclose(
        float(res.model.total_dy), naive.model.total_dy, rtol=0.05, atol=2e-3
    )
    # final per-event projections agree
    ne = len(d["x"])
    naive_prx = naive.ev.pr_x
    np.testing.assert_allclose(
        np.asarray(res.pr_x)[:ne], naive_prx, rtol=0.02, atol=0.1
    )


def test_recovers_translation_flow():
    """On a pure-translation scene the recovered flow ~ ground truth."""
    d = _small_scene(vx=25.0, vy=-15.0)
    ev, res, cfg = _jit_run(d)
    ne = len(d["x"])
    u = np.asarray(res.u)[:ne]
    v = np.asarray(res.v)[:ne]
    assert abs(np.median(u) - 25.0) < 6.0
    assert abs(np.median(v) - (-15.0)) < 6.0


def test_sharpness_improves():
    """Motion compensation sharpens the time image (higher nonzero mean of
    the count image == fewer occupied pixels == sharper)."""
    d = _small_scene(vx=30.0, vy=20.0)
    ev, res, cfg = _jit_run(d)
    img0 = final_time_image(ev, res._replace(pr_x=ev.x, pr_y=ev.y), cfg.scale, SMALL)
    img1 = final_time_image(ev, res, cfg.scale, SMALL)
    occupied0 = int(jnp.sum(img0 > 0))
    occupied1 = int(jnp.sum(img1 > 0))
    assert occupied1 < occupied0  # deblurred -> more concentrated


def test_window_gate_marks_noise():
    """A spatially degenerate slice is skipped and flagged noise
    (optimizer_rolling.h:49-54)."""
    n = 1500
    d = {
        "x": np.full(n, 5.0),
        "y": np.full(n, 6.0),
        "t_ns": np.sort(np.random.default_rng(0).integers(0, int(1e8), n)),
    }
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64))
    res = process_slice(ev, MotionModel.zero(), OptimizerConfig(), SMALL)
    assert not bool(res.ran)
    assert bool(jnp.all(res.noise))
    assert int(res.iters) == 0


def test_too_few_events_gate():
    """< 1000 events: skipped but NOT marked noise (optimizer_rolling.h:57)."""
    d = _small_scene(n=500)
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64))
    res = process_slice(ev, MotionModel.zero(), OptimizerConfig(), SMALL)
    assert not bool(res.ran)
    assert not bool(jnp.any(res.noise))


def test_warm_start_reduces_iterations():
    """Re-running with the converged model as warm start converges faster —
    the reference's short-term-memory speedup (dvs_flow.h:215-219)."""
    d = _small_scene(vx=30.0, vy=-20.0)
    ev, res_cold, cfg = _jit_run(d)
    res_warm = process_slice(ev, res_cold.model, cfg, SMALL, warm_start=True)
    assert int(res_warm.iters) <= int(res_cold.iters)


def test_max_iter_bounds_iterations():
    d = _small_scene()
    _, res, _ = _jit_run(d, max_iter=3)
    assert int(res.iters) <= 4  # max+1 steps, matching the C++ break placement


def test_process_slice_jit_compiles_once():
    d = _small_scene()
    cfg = OptimizerConfig(scale=3)
    jitted = jax.jit(
        process_slice, static_argnames=("cfg", "sensor", "warm_start")
    )
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64), capacity=2000)
    r1 = jitted(ev, MotionModel.zero(), cfg, SMALL)
    d2 = _small_scene(seed=7)
    ev2 = make_slice(d2["x"], d2["y"], d2["t_ns"].astype(np.float64), capacity=2000)
    r2 = jitted(ev2, r1.model, cfg, SMALL)
    assert np.isfinite(float(r2.model.total_dx))
