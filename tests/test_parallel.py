"""Multi-device sharding: event-parallel slice processing on a virtual
8-device CPU mesh must match the single-device path."""

import numpy as np
import jax
import pytest

from better_flow.config import OptimizerConfig, SensorConfig
from better_flow.core.events import make_slice
from better_flow.core.model import MotionModel
from better_flow.io.synthetic import synthetic_events
from better_flow.models.global_flow import process_slice
from better_flow.parallel.event_parallel import (
    jit_event_parallel,
    process_slice_event_parallel,
)
from better_flow.parallel.mesh import make_event_mesh

SMALL = SensorConfig(24, 32)

needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@needs_8
def test_event_parallel_matches_single_device():
    d = synthetic_events(1500, duration_s=0.1, res_x=24, res_y=32,
                         vx=18.0, vy=-12.0, n_points=60, seed=1)
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64), capacity=1600)
    cfg = OptimizerConfig(scale=3)
    mesh = make_event_mesh(8)
    res_sh = process_slice_event_parallel(ev, MotionModel.zero(), cfg, SMALL, mesh)
    res = process_slice(ev, MotionModel.zero(), cfg, SMALL)
    assert int(res_sh.iters) == int(res.iters)
    # atol 2e-5: the sharded means reduce in a different order; the
    # Kahan-compensated totals accumulate that f32 reduction noise over
    # ~20 iterations (~6e-6 observed) instead of absorbing it in their own
    # rounding.
    np.testing.assert_allclose(
        float(res_sh.model.total_dx), float(res.model.total_dx), rtol=1e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        float(res_sh.model.total_dy), float(res.model.total_dy), rtol=1e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.pr_x), np.asarray(res.pr_x), rtol=1e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.u), np.asarray(res.u), rtol=1e-3, atol=1e-2
    )


@needs_8
def test_event_parallel_gates():
    """Degenerate window fires identically when events are sharded (the bbox
    is a pmin/pmax collective)."""
    n = 1600
    ev = make_slice(np.full(n, 5.0), np.full(n, 6.0),
                    np.arange(n, dtype=np.float64) * 1e4)
    cfg = OptimizerConfig(scale=3)
    mesh = make_event_mesh(8)
    res = process_slice_event_parallel(ev, MotionModel.zero(), cfg, SMALL, mesh)
    assert not bool(res.ran)
    assert bool(np.asarray(res.noise).all())


@needs_8
def test_jit_event_parallel_reuse():
    cfg = OptimizerConfig(scale=3)
    mesh = make_event_mesh(4)
    fn = jit_event_parallel(cfg, SMALL, mesh)
    d = synthetic_events(1500, duration_s=0.1, res_x=24, res_y=32, seed=3)
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64), capacity=1600)
    r1 = fn(ev, MotionModel.zero())
    r2 = fn(ev, r1.model)  # warm start second call, same compiled program
    assert int(r2.iters) <= int(r1.iters)
