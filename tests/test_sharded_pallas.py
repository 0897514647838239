"""Event-parallel slice processing vs the single-device path.

process_slice(..., axis_name='ev') splats each shard's events, psums the
pre-filter images over the event axis and runs the image-space finish and
the model update replicated on every shard.  These tests pin that path to
the unsharded program on the virtual 8-device CPU mesh.
"""

import jax
import numpy as np
import pytest

from better_flow.config import OptimizerConfig, SensorConfig
from better_flow.core.events import make_slice
from better_flow.core.model import MotionModel
from better_flow.io.synthetic import synthetic_events
from better_flow.models.global_flow import process_slice
from better_flow.parallel.event_parallel import (
    process_slice_event_parallel,
)
from better_flow.parallel.mesh import make_event_mesh

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

SMALL = SensorConfig(24, 32)


def _slice(cap=2048, seed=0):
    d = synthetic_events(int(cap * 0.9), duration_s=0.1, res_x=24, res_y=32,
                         vx=18.0, vy=-12.0, n_points=60, seed=seed)
    return make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64),
                      capacity=cap)


@needs_8
@pytest.mark.parametrize("sched", ["reference", "fast"])
def test_sharded_matches_single_device(sched):
    """8-way event sharding reproduces the unsharded program: the psum'd
    images equal the single-device splat up to the order of the sums."""
    ev = _slice(seed=3)
    mesh = make_event_mesh(8)
    cfg = OptimizerConfig(scale=3, max_iter=6, min_events=100,
                          schedule=sched)
    ref = process_slice(ev, MotionModel.zero(), cfg, SMALL)
    out = process_slice_event_parallel(ev, MotionModel.zero(), cfg, SMALL,
                                       mesh)
    assert int(out.iters) == int(ref.iters), sched
    np.testing.assert_allclose(float(out.model.total_dx),
                               float(ref.model.total_dx),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(out.model.total_rot),
                               float(ref.model.total_rot),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(np.asarray(out.v), np.asarray(ref.v),
                               rtol=1e-3, atol=1e-2)


def test_sharded_one_device_parity_bound():
    """At a 1-device mesh the psum is an exact no-op, so the sharded and
    the plain program differ only in compilation context: XLA may contract
    the 3-term rot/div gradient expressions differently in the two
    programs, and warm-start chains amplify those ulps.  The per-slice
    bound: iteration counts match and the per-event flow agrees to 1e-3
    px/s absolute after a full optimization — far below anything
    physical, and tight enough that a REAL op-order divergence (a missing
    psum term, a wrong seam) fails immediately."""
    ev = _slice(seed=3)
    mesh = make_event_mesh(1)
    for sched in ("reference", "fast"):
        cfg = OptimizerConfig(scale=3, max_iter=6, min_events=100,
                              schedule=sched)
        single = process_slice(ev, MotionModel.zero(), cfg, SMALL)
        shard = process_slice_event_parallel(ev, MotionModel.zero(), cfg,
                                             SMALL, mesh)
        assert int(shard.iters) == int(single.iters), sched
        np.testing.assert_allclose(np.asarray(shard.u),
                                   np.asarray(single.u),
                                   rtol=0, atol=1e-3, err_msg=sched)
        np.testing.assert_allclose(np.asarray(shard.v),
                                   np.asarray(single.v),
                                   rtol=0, atol=1e-3, err_msg=sched)
        for f in ("total_dx", "total_dy", "total_rot", "total_div"):
            a = float(getattr(single.model, f))
            b = float(getattr(shard.model, f))
            assert abs(a - b) <= 1e-5 + 1e-3 * abs(a), (sched, f, a, b)
