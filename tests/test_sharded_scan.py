"""Sharded scan pipeline (multi-chip offline) vs single-device scan."""

import numpy as np
import jax
import pytest

from better_flow.config import (
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
)
from better_flow.io.synthetic import synthetic_events
from better_flow.parallel.event_parallel import compensate_recording_scan_sharded
from better_flow.parallel.mesh import make_event_mesh
from better_flow.runtime.scan_pipeline import compensate_recording_scan

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

SMALL = SensorConfig(24, 32)


def small_cfg():
    return PipelineConfig(
        sensor=SMALL,
        slice=SliceConfig(max_events=4096, span_ns=int(0.1e9),
                          refresh_events=1500, refresh_time_ns=int(0.04e9)),
        optimizer=OptimizerConfig(scale=3, min_events=500),
    )


@needs_8
def test_sharded_scan_matches_single():
    d = synthetic_events(20000, duration_s=0.5, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=2)
    cfg = small_cfg()
    single = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    mesh = make_event_mesh(8)
    sharded = compensate_recording_scan_sharded(d["x"], d["y"], d["t_ns"], cfg, mesh)
    assert sharded["stats"]["n_slices"] == single["stats"]["n_slices"]
    np.testing.assert_array_equal(sharded["iters"], single["iters"])
    np.testing.assert_allclose(
        float(sharded["model"].total_dx), float(single["model"].total_dx),
        rtol=1e-4, atol=1e-6,
    )
    ok = ~single["noise"]
    np.testing.assert_allclose(sharded["u"][ok], single["u"][ok],
                               rtol=1e-3, atol=5e-2)


@needs_8
def test_sharded_scan_noise_persistence():
    """A degenerate prefix (single-pixel burst) marks noise that must
    persist into later slices identically on the sharded path."""
    n1, n2 = 2000, 12000
    d = synthetic_events(n2, duration_s=0.3, res_x=24, res_y=32,
                         vx=18.0, vy=-8.0, seed=5)
    x = np.concatenate([np.full(n1, 5.0), d["x"]])
    y = np.concatenate([np.full(n1, 6.0), d["y"]])
    t = np.concatenate([
        np.linspace(0, 0.05e9, n1, dtype=np.int64),
        d["t_ns"] + int(0.06e9),
    ])
    cfg = small_cfg()
    single = compensate_recording_scan(x, y, t, cfg)
    sharded = compensate_recording_scan_sharded(x, y, t, cfg, make_event_mesh(8))
    np.testing.assert_array_equal(sharded["noise"], single["noise"])
    assert sharded["noise"][:n1].any()  # the burst got flagged
