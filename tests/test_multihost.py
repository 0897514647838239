"""Multi-host range pipeline: single-process equivalence tests.

The cross-process path (2 real jax.distributed processes running the SAME
pipeline) lives in tests/test_distributed.py; here the range machinery —
global plan + per-range staging, carry hand-off, boundary noise history,
disjoint first-slice-wins claims — is pinned exactly against the
full-recording scan without spawning processes.
"""

import numpy as np
import pytest

from better_flow.config import OptimizerConfig, PipelineConfig
from better_flow.io.synthetic import synthetic_events
from better_flow.runtime.scan_pipeline import (
    compensate_recording_scan,
    plan_slices,
    prepare_recording,
)


@pytest.fixture(scope="module")
def rec():
    return synthetic_events(150_000, duration_s=0.2, res_x=180, res_y=240,
                            vx=40.0, vy=-25.0, rot=0.1, div=0.04,
                            n_points=500, seed=3)


@pytest.mark.parametrize("sched", ["reference", "fast"])
def test_range_chain_equals_full(rec, sched):
    """Two ranges chained through the carry hand-off reproduce the full
    warm-start scan bit for bit: disjoint claims, identical flow, noise
    and per-slice iteration counts."""
    cfg = PipelineConfig(optimizer=(
        OptimizerConfig.fast() if sched == "fast"
        else OptimizerConfig(schedule="reference")))
    t_ns = np.ascontiguousarray(rec["t_ns"], np.int64)
    full = compensate_recording_scan(rec["x"], rec["y"], t_ns, cfg)
    S = len(plan_slices(t_ns, cfg).ends)
    mid = S // 2
    p1 = prepare_recording(rec["x"], rec["y"], t_ns, cfg,
                           slice_range=(0, mid))
    p2 = prepare_recording(rec["x"], rec["y"], t_ns, cfg,
                           slice_range=(mid, S))
    r1 = compensate_recording_scan(None, None, None, cfg, prepared=p1)
    r2 = compensate_recording_scan(None, None, None, cfg, prepared=p2,
                                   carry_in=r1["carry"])
    claimed_both = (r1["u"] != 0) & (r2["u"] != 0)
    assert int(claimed_both.sum()) == 0
    np.testing.assert_array_equal(r1["u"] + r2["u"], full["u"])
    np.testing.assert_array_equal(r1["v"] + r2["v"], full["v"])
    np.testing.assert_array_equal(r1["noise"] | r2["noise"], full["noise"])
    np.testing.assert_array_equal(
        np.concatenate([r1["iters"], r2["iters"]]), full["iters"])


def test_range_cold_boundary_stm_disable(rec):
    """With stm_disable (no warm start — the reference's --stm-disable)
    ranges are independent, so cold-boundary concurrent processing is
    exact."""
    cfg = PipelineConfig(stm_disable=True)
    t_ns = np.ascontiguousarray(rec["t_ns"], np.int64)
    full = compensate_recording_scan(rec["x"], rec["y"], t_ns, cfg)
    S = len(plan_slices(t_ns, cfg).ends)
    mid = S // 2
    outs = []
    for lohi in [(0, mid), (mid, S)]:
        p = prepare_recording(rec["x"], rec["y"], t_ns, cfg,
                              slice_range=lohi)
        outs.append(compensate_recording_scan(None, None, None, cfg,
                                              prepared=p))
    np.testing.assert_array_equal(outs[0]["u"] + outs[1]["u"], full["u"])
    np.testing.assert_array_equal(outs[0]["noise"] | outs[1]["noise"],
                                  full["noise"])


def test_boundary_noise_history(rec):
    """A range whose first slices overlap a pre-boundary window_small slice
    must reproduce the full scan's noise flags — the host-computed
    pre-range gate history (prepare_recording's hist0) carries that
    without any communication.  Build a recording whose middle slice fires
    the degenerate-window gate."""
    rng = np.random.default_rng(0)
    # segment A: normal scene; segment B: all events at one pixel (gate
    # fires); segment C: normal again — B's events overlap C's first slice
    # windows through the ring.
    a = synthetic_events(30_000, duration_s=0.1, res_x=180, res_y=240,
                         vx=30.0, vy=-20.0, n_points=300, seed=1)
    # B long enough (0.25 s > span_ns) that late-B slices hold ONLY the
    # single-pixel events and the geometric gate fires.
    nb = 60_000
    bt = np.sort(rng.integers(0, int(0.25e9), nb)) + int(0.1e9)
    c = synthetic_events(30_000, duration_s=0.1, res_x=180, res_y=240,
                         vx=30.0, vy=-20.0, n_points=300, seed=2)
    x = np.concatenate([a["x"], np.full(nb, 90.0), c["x"]])
    y = np.concatenate([a["y"], np.full(nb, 120.0), c["y"]])
    t_ns = np.concatenate([a["t_ns"], bt, c["t_ns"] + int(0.35e9)])
    order = np.argsort(t_ns, kind="stable")
    x, y, t_ns = x[order], y[order], np.ascontiguousarray(t_ns[order])

    cfg = PipelineConfig()
    full = compensate_recording_scan(x, y, t_ns, cfg)
    assert full["noise"].any()  # the degenerate segment fired the gate
    S = len(plan_slices(t_ns, cfg).ends)
    # split right after the noisy region so the boundary history matters
    noisy_slices = np.nonzero(
        [full["iters"][s] == 0 for s in range(S)])[0]
    mid = int(noisy_slices[-1]) + 1 if len(noisy_slices) else S // 2
    mid = min(max(mid, 1), S - 1)
    p1 = prepare_recording(x, y, t_ns, cfg, slice_range=(0, mid))
    p2 = prepare_recording(x, y, t_ns, cfg, slice_range=(mid, S))
    r1 = compensate_recording_scan(None, None, None, cfg, prepared=p1)
    r2 = compensate_recording_scan(None, None, None, cfg, prepared=p2,
                                   carry_in=r1["carry"])
    np.testing.assert_array_equal(r1["noise"] | r2["noise"], full["noise"])
    np.testing.assert_array_equal(r1["u"] + r2["u"], full["u"])


def test_multihost_single_process_fallback(rec):
    """compensate_recording_multihost with one process = the plain scan."""
    from better_flow.parallel.multihost import (
        compensate_recording_multihost,
    )

    cfg = PipelineConfig()
    t_ns = np.ascontiguousarray(rec["t_ns"], np.int64)
    full = compensate_recording_scan(rec["x"], rec["y"], t_ns, cfg)
    out = compensate_recording_multihost(rec["x"], rec["y"], t_ns, cfg,
                                         ev_per_host=1)
    np.testing.assert_array_equal(out["u"], full["u"])
    np.testing.assert_array_equal(out["noise"], full["noise"])
    assert out["stats"]["n_processes"] == 1


def test_cold_pipeline_matches_scan(rec):
    """compensate_recording_cold (batch-pipelined staging/execution
    overlap) is bit-identical to the one-program scan — it is the range
    chain at n_batch granularity with deferred fetches."""
    from better_flow.runtime.scan_pipeline import (
        compensate_recording_cold,
    )

    cfg = PipelineConfig()
    t_ns = np.ascontiguousarray(rec["t_ns"], np.int64)
    full = compensate_recording_scan(rec["x"], rec["y"], t_ns, cfg)
    cold = compensate_recording_cold(rec["x"], rec["y"], t_ns, cfg,
                                     n_batch=3)
    assert cold["stats"]["n_batches"] == 3
    np.testing.assert_array_equal(cold["u"], full["u"])
    np.testing.assert_array_equal(cold["v"], full["v"])
    np.testing.assert_array_equal(cold["noise"], full["noise"])
    np.testing.assert_array_equal(cold["iters"], full["iters"])
