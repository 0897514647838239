"""f64 warp-total accumulation (PipelineConfig.f64_totals).

The reference accumulates the model totals in double (object_model.h:10-13);
the default f32 carry emulates that with Kahan compensation.  The flag makes
the carry exactly double while keeping the per-event warp f32 (the C++
apply_project also truncates to float, event.h:156-167), so per-slice results
stay on the pinned f32 op order and only the accumulated drift changes.
"""

import numpy as np
import pytest
from jax import enable_x64


def _recording(n=60_000, **scene):
    from better_flow.io.synthetic import synthetic_events

    return synthetic_events(
        n, duration_s=0.4, res_x=180, res_y=240, n_points=400, seed=21,
        **scene
    )


def test_kahan_f32_matches_f64_sum():
    """add_totals: the Kahan f32 carry and the plain f64 carry both track an
    exact f64 running sum over thousands of small mixed-sign steps; an
    uncompensated f32 sum drifts visibly."""
    import jax.numpy as jnp

    from better_flow.core.model import MotionModel

    rng = np.random.default_rng(0)
    deltas = (rng.standard_normal(4000) * 1e-4).astype(np.float32)
    exact = np.sum(deltas.astype(np.float64))

    m32 = MotionModel.zero()
    naive = np.float32(0.0)
    for d in deltas:
        m32 = m32.add_totals(jnp.float32(d), 0.0, 0.0, 0.0)
        naive = np.float32(naive + d)
    err_kahan = abs(float(m32.total_rot) - exact)
    err_naive = abs(float(naive) - exact)
    assert err_kahan <= err_naive
    assert err_kahan < 1e-9

    with enable_x64():
        m64 = MotionModel.zero(jnp.float64)
        for d in deltas[:100]:
            m64 = m64.add_totals(jnp.float64(d), 0.0, 0.0, 0.0)
        assert m64.total_rot.dtype == jnp.float64
        assert abs(float(m64.total_rot) - np.sum(deltas[:100].astype(np.float64))) < 1e-12


def test_scan_f64_totals_matches_f32():
    """Full scan with f64 totals: runs, yields a float64 carry, and agrees
    with the f32 run on a well-conditioned scene (the two modes only differ
    by sub-ulp accumulation residue until a chaotic bifurcation)."""
    import jax.numpy as jnp

    from better_flow.config import PipelineConfig
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    d = _recording(vx=60.0, vy=-40.0, rot=0.1, div=0.03)
    cfg32 = PipelineConfig()
    out32 = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg32)

    with enable_x64():
        cfg64 = PipelineConfig(f64_totals=True)
        out64 = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg64)
        assert out64["model"].total_dx.dtype == jnp.float64

    ok = ~(out32["noise"] | out64["noise"])
    c = np.corrcoef(out32["u"][ok], out64["u"][ok])[0, 1]
    assert c > 0.999, c
    speed = np.hypot(out32["u"][ok], out32["v"][ok]).mean()
    assert np.median(np.abs(out32["u"][ok] - out64["u"][ok])) < 0.01 * speed


def test_f64_totals_requires_x64():
    from better_flow.config import PipelineConfig
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    d = _recording(n=5_000)
    with pytest.raises(ValueError, match="x64"):
        compensate_recording_scan(
            d["x"], d["y"], d["t_ns"], PipelineConfig(f64_totals=True)
        )
