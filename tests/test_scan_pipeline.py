"""Device-resident scanned pipeline vs the streaming runtime."""

import numpy as np

from better_flow.config import (
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
)
from better_flow.io.synthetic import synthetic_events
from better_flow.runtime.offline import compensate_recording
from better_flow.runtime.scan_pipeline import (
    compensate_recording_scan,
    plan_slices,
)

SMALL = SensorConfig(24, 32)


def small_cfg(**kw):
    return PipelineConfig(
        sensor=SMALL,
        slice=SliceConfig(
            max_events=4000,
            span_ns=int(0.1e9),
            refresh_events=1500,
            refresh_time_ns=int(0.04e9),
        ),
        optimizer=OptimizerConfig(scale=3, min_events=500),
        **kw,
    )


def test_plan_matches_streaming_triggers():
    d = synthetic_events(20000, duration_s=0.5, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=2)
    cfg = small_cfg()
    plan = plan_slices(d["t_ns"], cfg)
    out = compensate_recording(d["x"], d["y"], d["t_ns"], cfg)
    eng = out["engine"]
    # same number of slices, same trigger timestamps, same window sizes
    assert len(plan.ends) == len(eng.slices)
    for s, rec in zip(range(len(plan.ends)), eng.slices):
        assert d["t_ns"][plan.ends[s]] == rec.timestamp[-1]
        assert plan.ends[s] - plan.starts[s] + 1 == rec.n_events
        assert plan.slice_start_ns[s] == rec.slice_start_time


def test_scan_matches_streaming_results():
    d = synthetic_events(20000, duration_s=0.5, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=2)
    cfg = small_cfg()
    scan = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    stream = compensate_recording(d["x"], d["y"], d["t_ns"], cfg)
    # identical slice structure and per-slice iteration counts
    iters_stream = [r.iters for r in stream["engine"].slices]
    np.testing.assert_array_equal(scan["iters"], iters_stream)
    # final models agree
    m1, m2 = scan["model"], stream["engine"].last_model
    np.testing.assert_allclose(float(m1.total_dx), float(m2.total_dx), rtol=1e-5)
    np.testing.assert_allclose(float(m1.total_dy), float(m2.total_dy), rtol=1e-5)
    # flow recovery
    ok = ~scan["noise"]
    assert abs(np.median(scan["u"][ok]) - 20.0) < 8.0
    assert abs(np.median(scan["v"][ok]) + 14.0) < 8.0


def test_scan_throughput_counts_all_events():
    d = synthetic_events(8000, duration_s=0.2, res_x=24, res_y=32, seed=9)
    out = compensate_recording_scan(d["x"], d["y"], d["t_ns"], small_cfg())
    assert out["stats"]["n_events"] == len(d["x"])
    assert out["stats"]["events_per_s"] > 0


def test_noise_persists_across_slices_via_window_gate():
    """The degenerate-window gate is the scan path's only noise source; the
    scan carries it as a (window_small, start, end) scalar history instead
    of a per-event global array, so the reconstruction must match the
    streaming runtime exactly — including persistence into later slices
    that still contain the gated events (Event::reset leaves noise set)."""
    rng = np.random.default_rng(3)
    # Phase 1: a healthy moving scene; phase 2: all events collapse onto one
    # pixel (window gate fires); phase 3: healthy again, initially sharing
    # phase-2 events through the sliding window.
    def phase(n, t0, gen):
        t = np.sort(rng.integers(0, int(0.15e9), n)) + t0
        x, y = gen(n)
        return x.astype(np.float64), y.astype(np.float64), t

    healthy = lambda n: (rng.integers(0, 24, n), rng.integers(0, 32, n))
    point = lambda n: (np.full(n, 7), np.full(n, 9))
    xs, ys, ts = zip(
        phase(3000, 0, healthy),
        phase(3000, int(0.15e9), point),
        phase(3000, int(0.30e9), healthy),
    )
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    t_ns = np.concatenate(ts).astype(np.int64)

    cfg = small_cfg()
    scan = compensate_recording_scan(x, y, t_ns, cfg)
    stream = compensate_recording(x, y, t_ns, cfg)
    # Some slice must actually have fired the gate for this test to bite,
    # and some must not have.
    assert scan["noise"].any() and not scan["noise"].all()
    # Per-original-event first-slice-wins flags from the streaming runtime
    # (whose SliceRecords are chronological per slice).
    plan = plan_slices(t_ns, cfg)
    records = stream["engine"].slices
    expected = np.zeros(len(x), bool)
    seen = np.zeros(len(x), bool)
    for s, rec in enumerate(records):
        rng_idx = np.arange(plan.starts[s], plan.ends[s] + 1)
        fresh = ~seen[rng_idx]
        expected[rng_idx[fresh]] = np.asarray(rec.noise)[fresh]
        seen[rng_idx] = True
    np.testing.assert_array_equal(scan["noise"], expected)


def test_empty_and_tiny_recordings():
    """Degenerate inputs through both offline entry points: an empty
    recording produces zero slices without crashing; a sub-slice recording
    produces its flush slice (bf_motion_compensator.cpp:208)."""
    from better_flow.config import (OptimizerConfig, PipelineConfig,
                                        SensorConfig, SliceConfig)
    from better_flow.runtime.scan_pipeline import (
        compensate_recording_cold,
        compensate_recording_scan,
    )

    cfg = PipelineConfig(
        sensor=SensorConfig(24, 32),
        slice=SliceConfig(max_events=4000, span_ns=int(0.1e9),
                          refresh_events=1500, refresh_time_ns=int(0.04e9)),
        optimizer=OptimizerConfig(scale=3, min_events=500))
    for fn in (compensate_recording_scan, compensate_recording_cold):
        r = fn(np.zeros(0), np.zeros(0), np.zeros(0, np.int64), cfg)
        assert r["stats"]["n_slices"] == 0
        assert len(r["u"]) == 0
        assert r["stats"]["mean_iters"] == 0.0

    rng = np.random.default_rng(0)
    n = 800
    x = rng.integers(0, 24, n).astype(np.float64)
    y = rng.integers(0, 32, n).astype(np.float64)
    t = np.sort(rng.integers(0, int(0.05e9), n)).astype(np.int64)
    for fn in (compensate_recording_scan, compensate_recording_cold):
        r = fn(x, y, t, cfg)
        assert r["stats"]["n_slices"] >= 1
        assert len(r["u"]) == n


def test_range_scan_gate_history_nondefault_fraction():
    """Host-reconstructed pre-range window-gate history must agree with
    the DEVICE gate for a non-default min_window_fraction (the round-4
    advisor fix: geometry_from_bbox used to hardcode //15 while the host
    history honored the config).  A recording whose early slices fire the
    gate at fraction 6 but not at 15 is split at a range boundary; the
    range scan seeded from the host history must reproduce the full
    scan's noise flags exactly."""
    from better_flow.runtime.scan_pipeline import (
        make_carry,
        plan_slices,
        prepare_recording,
    )
    from better_flow.core.model import MotionModel

    rng = np.random.default_rng(7)
    n = 12_000
    # A tight cluster: bbox ~8x11 px of a 64x80 sensor -> window_small
    # fires at min_window_fraction=6 (3*7+3=24 < 64*3//6=32 and
    # 3*10+3=33 < 80*3//6=40) but not at the default 15.
    x = rng.integers(20, 28, n).astype(np.float64)
    y = rng.integers(30, 41, n).astype(np.float64)
    t = np.sort(rng.integers(0, int(0.3e9), n)).astype(np.int64)
    cfg = PipelineConfig(
        sensor=SensorConfig(64, 80),
        slice=SliceConfig(max_events=3000, span_ns=int(0.1e9),
                          refresh_events=1200, refresh_time_ns=int(0.05e9)),
        optimizer=OptimizerConfig(scale=3, min_events=500,
                                  min_window_fraction=6))
    full = compensate_recording_scan(x, y, t, cfg)
    assert full["noise"].any(), "scene must fire the fraction-6 gate"

    S = len(plan_slices(t, cfg).ends)
    mid = max(1, S // 2)
    prep0 = prepare_recording(x, y, t, cfg, slice_range=(0, mid))
    r0 = compensate_recording_scan(None, None, None, cfg, prepared=prep0)
    prep1 = prepare_recording(x, y, t, cfg, slice_range=(mid, S))
    ws_h, st_h, en_h = prep1["hist0"]
    carry = make_carry(r0["carry"][0], prep1["hist_k"],
                       seed=r0["carry"][1], ws_h=ws_h, st_h=st_h,
                       en_h=en_h)
    r1 = compensate_recording_scan(None, None, None, cfg, prepared=prep1,
                                   carry_in=carry)
    stitched = np.where(r0["noise"] | r1["noise"], True, False)
    np.testing.assert_array_equal(stitched, full["noise"])


def test_scan_auto_routes_to_bounded_cold(monkeypatch):
    """Round-5 bounded-memory guard: a recording whose estimated device
    residency exceeds BF_SCAN_DEVICE_BUDGET_GB routes through the
    batch-pipelined cold path — same u/v/noise/iters as the one-program
    scan (range-chained scans are exact; tests/test_multihost.py), with
    the routing flagged in stats."""
    from better_flow.config import (
        OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig)
    from better_flow.io.synthetic import synthetic_events
    from better_flow.runtime.scan_pipeline import (
        compensate_recording_scan)

    d = synthetic_events(24000, duration_s=0.4, res_x=24, res_y=32,
                         n_points=80, seed=7, vx=6.0, vy=-4.0, rot=0.1,
                         div=0.04)
    cfg = PipelineConfig(
        sensor=SensorConfig(24, 32),
        slice=SliceConfig(max_events=4000, span_ns=int(0.1e9),
                          refresh_events=1500,
                          refresh_time_ns=int(0.04e9)),
        optimizer=OptimizerConfig(scale=3, min_events=500,
                                  schedule="fast"))
    plain = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    assert "routed_cold" not in plain["stats"]
    monkeypatch.setenv("BF_SCAN_DEVICE_BUDGET_GB", "0.001")
    routed = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    assert routed["stats"].get("routed_cold") is True
    assert routed["stats"]["n_batches"] >= 4
    np.testing.assert_array_equal(routed["noise"], plain["noise"])
    np.testing.assert_array_equal(routed["iters"],
                                  np.asarray(plain["iters"]))
    np.testing.assert_array_equal(routed["u"], plain["u"])
    np.testing.assert_array_equal(routed["v"], plain["v"])
