"""Native (C++) band-padded materialization vs the numpy reference path.

The native counting-sort pass (native/bf_native.cpp bf_materialize_bandpad)
must reproduce the numpy materialize_slices(band_pad=True) layout
ELEMENT-EXACTLY: same slot positions, same compact u16 encoding, same f32
slice-local times.
"""

import numpy as np
import pytest

from better_flow.config import (
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
)
from better_flow.io import native
from better_flow.io.synthetic import synthetic_events
from better_flow.runtime.scan_pipeline import (
    BAND_ROWS,
    CHUNK,
    PERM_SENTINEL,
    materialize_slices,
    plan_slices,
    prepare_recording,
)

needs_native = pytest.mark.skipif(native.get_lib() is None,
                                  reason="native lib unavailable")


def _recording(n=60000, seed=7):
    d = synthetic_events(n, duration_s=0.3, res_x=180, res_y=240,
                         vx=60.0, vy=-40.0, rot=0.1, n_points=300, seed=seed)
    return (np.asarray(d["x"], np.float32), np.asarray(d["y"], np.float32),
            np.asarray(d["t_ns"], np.int64))


@needs_native
def test_native_materialize_matches_numpy():
    x, y, t_ns = _recording()
    cfg = PipelineConfig(
        slice=SliceConfig(max_events=20000, span_ns=int(0.1e9),
                          refresh_events=8000, refresh_time_ns=int(0.05e9)),
    )
    plan = plan_slices(t_ns, cfg)
    xs, ys, ts, idx, lens = materialize_slices(
        x, y, t_ns, plan, cfg.slice.max_events,
        band_pad=True, res_x=cfg.sensor.res_x,
    )
    band_rows = BAND_ROWS
    n_bands = max(cfg.sensor.res_x + band_rows - 1, band_rows) // band_rows
    capp = -(-(cfg.slice.max_events + n_bands * (CHUNK - 1)) // CHUNK) * CHUNK
    assert xs.shape[1] == capp
    out = native.materialize_bandpad(
        x, y, t_ns, plan.starts, plan.ends, plan.slice_start_ns,
        capp, band_rows, CHUNK, n_bands, cfg.sensor.res_y,
    )
    assert out is not None
    xs16, ys16, ts_n, perm = out
    np.testing.assert_array_equal(xs16, xs.astype(np.uint16))
    np.testing.assert_array_equal(ys16, ys.astype(np.uint16))
    np.testing.assert_array_equal(ts_n, ts)
    idx_n = np.where(perm != PERM_SENTINEL,
                     plan.starts[:, None] + perm.astype(np.int64),
                     -1).astype(np.int32)
    np.testing.assert_array_equal(idx_n, idx)


@needs_native
def test_prepare_recording_uses_native(monkeypatch):
    """prepare_recording's compact slabs are identical with and without the
    native path (and the native path is what integer-u16 recordings get)."""
    x, y, t_ns = _recording(n=30000, seed=9)
    cfg = PipelineConfig(
        slice=SliceConfig(max_events=8000, span_ns=int(0.1e9),
                          refresh_events=4000, refresh_time_ns=int(0.05e9)),
    )
    p_nat = prepare_recording(x, y, t_ns, cfg)
    monkeypatch.setattr(native, "coords_u16", lambda *a, **k: None)
    p_np = prepare_recording(x, y, t_ns, cfg)
    assert p_nat["compact"] and p_np["compact"]
    # native in-sort bbox == numpy host_bbox
    np.testing.assert_array_equal(np.asarray(p_nat["bbox"]),
                                  np.asarray(p_np["bbox"]))
    np.testing.assert_array_equal(np.asarray(p_nat["nval"]),
                                  np.asarray(p_np["nval"]))
    np.testing.assert_array_equal(np.asarray(p_nat["xs16"]),
                                  np.asarray(p_np["xs16"]))
    np.testing.assert_array_equal(np.asarray(p_nat["ys16"]),
                                  np.asarray(p_np["ys16"]))
    np.testing.assert_array_equal(np.asarray(p_nat["ts"]),
                                  np.asarray(p_np["ts"]))
    np.testing.assert_array_equal(np.asarray(p_nat["perm"]),
                                  np.asarray(p_np["perm"]))
    # The native path defers the original-index matrix (plan_s cost); its
    # per-slice reconstruction from perm must equal the numpy idx matrix.
    assert p_nat["idx_host"] is None
    perm = p_nat["perm_host"]
    starts = p_nat["plan"].starts
    idx_rec = np.where(
        perm != np.uint16(0xFFFF),
        starts[:, None] + perm.astype(np.int64), -1
    ).astype(np.int32)
    np.testing.assert_array_equal(idx_rec, p_np["idx_host"])


@needs_native
def test_batched_staging_matches_single_call():
    """prepare_recording's pipelined slice-range batching (>= 64 slices:
    sort batch b+1 while batch b's slabs stream to the device) must be
    element-exact vs one native call over all slices."""
    x, y, t_ns = _recording(n=400_000, seed=11)
    cfg = PipelineConfig(
        sensor=SensorConfig(180, 240),
        slice=SliceConfig(max_events=8000, span_ns=int(0.05e9),
                          refresh_events=3000, refresh_time_ns=int(0.02e9)),
    )
    prep = prepare_recording(x, y, t_ns, cfg)
    plan = prep["plan"]
    S = len(plan.starts)
    assert S >= 64, f"recording too short to exercise batching ({S} slices)"

    band_rows = BAND_ROWS
    n_bands = max(cfg.sensor.res_x + band_rows - 1, band_rows) // band_rows
    cap = cfg.slice.max_events
    capp = -(-(cap + n_bands * (CHUNK - 1)) // CHUNK) * CHUNK
    x16, y16 = native.coords_u16(x, y)
    xs, ys, ts, perm, bbox = native.materialize_bandpad_u16(
        x16, y16, t_ns, plan.starts, plan.ends, plan.slice_start_ns,
        capp, band_rows, CHUNK, n_bands, cfg.sensor.res_y,
    )
    np.testing.assert_array_equal(np.asarray(prep["xs16"]), xs)
    np.testing.assert_array_equal(np.asarray(prep["ys16"]), ys)
    np.testing.assert_array_equal(np.asarray(prep["ts"]), ts)
    np.testing.assert_array_equal(np.asarray(prep["perm"]), perm)
    np.testing.assert_array_equal(prep["perm_host"], perm)
    np.testing.assert_array_equal(np.asarray(prep["bbox"]), bbox)
