"""Golden parity vs the built C++ reference binary (when available).

The reference binary is built out-of-tree from /root/reference with system
OpenCV/TBB (see tools/build_reference.sh).  These tests run both
implementations on the same synthetic recording and require the per-event
flow to agree closely and the compensated time image to meet the PSNR gate
(BASELINE.md).  Skipped when the binary isn't present.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

REF_BIN = os.environ.get("BF_REFERENCE_BIN", "/tmp/refbuild/build/bf_motion_compensator")

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_BIN), reason="reference binary not built"
)


def _make_golden(tmp, scene):
    from better_flow.io.event_file import write_events
    from better_flow.io.synthetic import synthetic_events

    d = synthetic_events(60_000, duration_s=0.4, res_x=180, res_y=240,
                         n_points=400, seed=21, **scene)
    rec = str(tmp / "rec.txt")
    write_events(rec, d["x"], d["y"], d["t_ns"], d["polarity"])
    ref_out = str(tmp / "ref.txt")
    subprocess.run(
        [REF_BIN, rec, "-o", ref_out],
        check=True, capture_output=True, timeout=600,
    )
    return {"rec": rec, "ref_out": ref_out, "events": d}


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return _make_golden(
        tmp_path_factory.mktemp("golden"),
        dict(vx=60.0, vy=-40.0, rot=0.1, div=0.03),
    )


@pytest.fixture(scope="module")
def golden_rotdiv(tmp_path_factory):
    """Rotation/divergence-dominated scene — exercises the crl/div terms of
    the 4-param warp against the C++ binary."""
    return _make_golden(
        tmp_path_factory.mktemp("golden_rd"),
        dict(vx=5.0, vy=-5.0, rot=0.8, div=0.25),
    )


def test_flow_matches_reference(golden):
    from better_flow.config import PipelineConfig
    from better_flow.io.event_file import read_events, read_events_uv
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    rec = read_events(golden["rec"])
    ref = read_events_uv(golden["ref_out"])
    assert len(ref["x"]) == len(rec["x"])

    out = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"], PipelineConfig())
    ok = ~out["noise"]
    du = np.abs(out["u"][ok] - ref["u"][ok])
    dv = np.abs(out["v"][ok] - ref["v"][ok])
    speed = np.hypot(ref["u"][ok], ref["v"][ok]).mean()
    assert np.median(du) < 0.02 * speed, (np.median(du), speed)
    assert np.median(dv) < 0.02 * speed
    assert np.corrcoef(out["u"][ok], ref["u"][ok])[0, 1] > 0.98
    assert np.corrcoef(out["v"][ok], ref["v"][ok])[0, 1] > 0.98


def test_fast_flow_matches_reference_binary(golden):
    """The bench preset (OptimizerConfig.fast(): secant schedule, 20x
    tolerances) directly against the C++ binary — not merely against our
    own reference schedule.  Tolerances widen slightly vs the parity-mode
    golden (the preset converges to the same optimum within its relaxed
    2e-4 px warp tolerance; reference-schedule-vs-binary already carries
    ~2% median deviation)."""
    from better_flow.config import OptimizerConfig, PipelineConfig
    from better_flow.io.event_file import read_events, read_events_uv
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    rec = read_events(golden["rec"])
    ref = read_events_uv(golden["ref_out"])
    out = compensate_recording_scan(
        rec["x"], rec["y"], rec["t_ns"],
        PipelineConfig(optimizer=OptimizerConfig.fast()),
    )
    ok = ~out["noise"]
    du = np.abs(out["u"][ok] - ref["u"][ok])
    dv = np.abs(out["v"][ok] - ref["v"][ok])
    speed = np.hypot(ref["u"][ok], ref["v"][ok]).mean()
    assert np.median(du) < 0.03 * speed, (np.median(du), speed)
    assert np.median(dv) < 0.03 * speed
    assert np.corrcoef(out["u"][ok], ref["u"][ok])[0, 1] > 0.97
    assert np.corrcoef(out["v"][ok], ref["v"][ok])[0, 1] > 0.97


def test_fast_noisy_flow_matches_reference_binary(golden_noisy):
    """Fast preset on the sensor-realistic noisy stream vs the C++ binary
    (the round-2 verdict's missing gate: the noisy golden previously ran
    parity mode only).  This single gate is what caught the
    exit_grad_factor=8 quality cliff in round 3 (one bursty slice exited
    early and the warm-start chain diverged, corr 0.9986 -> 0.48)."""
    from better_flow.config import OptimizerConfig, PipelineConfig
    from better_flow.io.event_file import read_events, read_events_uv
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    rec = read_events(golden_noisy["rec"])
    ref = read_events_uv(golden_noisy["ref_out"])
    for opt in (OptimizerConfig.fast(), OptimizerConfig.fast_accurate()):
        out = compensate_recording_scan(
            rec["x"], rec["y"], rec["t_ns"],
            PipelineConfig(optimizer=opt),
        )
        ok = ~out["noise"]
        assert ok.sum() > 10_000
        c_u = np.corrcoef(out["u"][ok], ref["u"][ok])[0, 1]
        c_v = np.corrcoef(out["v"][ok], ref["v"][ok])[0, 1]
        assert c_u > 0.96, (opt.exit_grad_factor, c_u)
        assert c_v > 0.96, (opt.exit_grad_factor, c_v)
        speed = np.hypot(ref["u"][ok], ref["v"][ok]).mean()
        assert np.median(np.abs(out["u"][ok] - ref["u"][ok])) < 0.06 * speed


def test_fast_noisy_margin_canary(golden_noisy):
    """Distance-to-cliff canary (round-4): the shipped factor-4 preset
    measures corr u=0.99862, v=0.99431 vs the C++ binary on this chain
    (calibrated round 4); the known cliff (factor 8) collapses it to
    ~0.48.  The plain gate above (corr > 0.96) would still pass a
    schedule tweak that quietly ate most of that headroom.  This canary
    pins it near today's values (u >= 0.995, v >= 0.985 — roughly half
    the current headroom over the production gate): a schedule change
    that erodes chain fidelity fails HERE, before it falls off the same
    cliff round 2's preset did.  Margin numbers are printed."""
    from better_flow.config import OptimizerConfig, PipelineConfig
    from better_flow.io.event_file import read_events, read_events_uv
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    rec = read_events(golden_noisy["rec"])
    ref = read_events_uv(golden_noisy["ref_out"])
    out = compensate_recording_scan(
        rec["x"], rec["y"], rec["t_ns"],
        PipelineConfig(optimizer=OptimizerConfig.fast()),
    )
    ok = ~out["noise"]
    c_u = np.corrcoef(out["u"][ok], ref["u"][ok])[0, 1]
    c_v = np.corrcoef(out["v"][ok], ref["v"][ok])[0, 1]
    print(f"[margin canary] noisy-golden chain corr: u={c_u:.5f} "
          f"v={c_v:.5f} (canary u>=0.995 v>=0.985; shipped "
          f"0.99862/0.99431; production gate 0.96; cliff ~0.48)")
    assert c_u >= 0.995, f"fast-preset margin eroded: corr(u)={c_u:.5f}"
    assert c_v >= 0.985, f"fast-preset margin eroded: corr(v)={c_v:.5f}"


@pytest.fixture(scope="module")
def golden_noisy2(tmp_path_factory):
    """Second sensor-realistic stream with a different seed and burstier
    statistics — cliff regressions in the fast exit are chain-chaotic and
    scene-dependent, so one noisy seed is thin protection."""
    from better_flow.io.dvs_sim import dvs_events
    from better_flow.io.event_file import write_events

    tmp = tmp_path_factory.mktemp("golden_noisy2")
    d = dvs_events(70_000, duration_s=0.35, res_x=180, res_y=240,
                   vx=-45.0, vy=25.0, rot=0.15, div=0.05, seed=23,
                   burst_depth=0.7)
    rec = str(tmp / "rec.txt")
    write_events(rec, d["x"], d["y"], d["t_ns"], d["polarity"])
    ref_out = str(tmp / "ref.txt")
    subprocess.run(
        [REF_BIN, rec, "-o", ref_out],
        check=True, capture_output=True, timeout=600,
    )
    return {"rec": rec, "ref_out": ref_out, "events": d}


def test_fast_noisy_flow_matches_reference_binary_seed2(golden_noisy2):
    """The fast preset must track the C++ binary on a SECOND noisy stream
    (different seed, burstier) — redundancy for the chain-divergence
    failure mode."""
    from better_flow.config import OptimizerConfig, PipelineConfig
    from better_flow.io.event_file import read_events, read_events_uv
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    rec = read_events(golden_noisy2["rec"])
    ref = read_events_uv(golden_noisy2["ref_out"])
    out = compensate_recording_scan(
        rec["x"], rec["y"], rec["t_ns"],
        PipelineConfig(optimizer=OptimizerConfig.fast()),
    )
    ok = ~out["noise"]
    assert ok.sum() > 10_000
    c_u = np.corrcoef(out["u"][ok], ref["u"][ok])[0, 1]
    c_v = np.corrcoef(out["v"][ok], ref["v"][ok])[0, 1]
    assert c_u > 0.95, c_u
    assert c_v > 0.95, c_v


def test_compensated_image_psnr(golden):
    """Compensated count images from both flows must agree (PSNR gate) and
    both must be sharper than the uncompensated image."""
    from better_flow.config import PipelineConfig
    from better_flow.eval.metrics import psnr
    from better_flow.io.event_file import read_events, read_events_uv
    from better_flow.runtime.scan_pipeline import compensate_recording_scan
    from better_flow.viz.images import projection_img

    rec = read_events(golden["rec"])
    ref = read_events_uv(golden["ref_out"])
    out = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"], PipelineConfig())

    # Warp both flows' events back to slice start via pr = fr - u * t.
    t_s = rec["t_ns"] / 1e9
    t_s = t_s - t_s.min()

    def comp_img(u, v):
        return projection_img(
            rec["x"] - u * t_s, rec["y"] - v * t_s, scale=3,
        )

    img_ref = comp_img(ref["u"], ref["v"])
    img_ours = comp_img(out["u"], out["v"])
    img_raw = projection_img(rec["x"], rec["y"], scale=3)

    p = psnr(img_ours.astype(float), img_ref.astype(float), peak=255.0)
    assert p > 25.0, f"PSNR vs reference compensated image too low: {p}"

    occ_ref = (img_ref > 0).sum()
    occ_ours = (img_ours > 0).sum()
    occ_raw = (img_raw > 0).sum()
    assert occ_ours < occ_raw          # we deblur
    assert occ_ours <= occ_ref * 1.05  # at least as concentrated as the C++


def test_rotdiv_flow_matches_reference(golden_rotdiv):
    """Rotation/divergence-dominated scenes make the warm-start chain
    chaotic: tiny numeric differences (our f32 vs the C++ double
    accumulation) eventually bifurcate into different local optima.  The
    honest gates are therefore (a) exact-trajectory parity over the early
    slices before any bifurcation, and (b) compensated-image sharpness
    within tolerance of the reference over the whole recording — the
    BASELINE.md sharpness criterion."""
    from better_flow.config import PipelineConfig
    from better_flow.io.event_file import read_events, read_events_uv
    from better_flow.runtime.scan_pipeline import (
        compensate_recording_scan,
        plan_slices,
    )
    from better_flow.viz.images import projection_img

    cfg = PipelineConfig()
    rec = read_events(golden_rotdiv["rec"])
    ref = read_events_uv(golden_rotdiv["ref_out"])
    out = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"], cfg)

    # (a) slice-exact parity before bifurcation: the first five slices must
    # track the C++ per-event flow essentially perfectly.
    plan = plan_slices(rec["t_ns"], cfg)
    end5 = plan.ends[4] + 1
    c = np.corrcoef(out["u"][:end5], ref["u"][:end5])[0, 1]
    assert c > 0.99, c

    # (b) sharpness parity over the whole recording.
    t_s = rec["t_ns"] / 1e9
    t_s = t_s - t_s.min()

    def occupancy(u, v):
        img = projection_img(rec["x"] - u * t_s, rec["y"] - v * t_s, scale=3)
        return (img > 0).sum()

    occ_ref = occupancy(ref["u"], ref["v"])
    occ_ours = occupancy(out["u"], out["v"])
    occ_raw = occupancy(np.zeros_like(t_s), np.zeros_like(t_s))
    assert occ_ours < occ_raw              # we deblur
    assert occ_ours <= occ_ref * 1.15      # within 15% of the C++ sharpness


@pytest.fixture(scope="module")
def golden_noisy(tmp_path_factory):
    """Sensor-realistic stream (threshold mismatch, refractory, BA noise,
    hot pixels, bursty rate — io/dvs_sim.py) through the C++ binary.  Real
    recordings cannot be fetched in this zero-egress environment
    (bf_viewer.cpp:632-640 names the dataset family); this is the in-repo
    stand-in with the same defect statistics."""
    from better_flow.io.dvs_sim import dvs_events
    from better_flow.io.event_file import write_events

    tmp = tmp_path_factory.mktemp("golden_noisy")
    d = dvs_events(80_000, duration_s=0.4, res_x=180, res_y=240,
                   vx=60.0, vy=-40.0, rot=0.1, div=0.03, seed=11)
    rec = str(tmp / "rec.txt")
    write_events(rec, d["x"], d["y"], d["t_ns"], d["polarity"])
    ref_out = str(tmp / "ref.txt")
    subprocess.run(
        [REF_BIN, rec, "-o", ref_out],
        check=True, capture_output=True, timeout=600,
    )
    return {"rec": rec, "ref_out": ref_out, "events": d}


def test_noisy_flow_matches_reference(golden_noisy):
    """Parity holds on sensor-realistic data, not just clean streams: the
    per-event flow must track the C++ binary through FPN, BA noise, and
    bursty slice occupancy."""
    from better_flow.config import PipelineConfig
    from better_flow.io.event_file import read_events, read_events_uv
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    rec = read_events(golden_noisy["rec"])
    ref = read_events_uv(golden_noisy["ref_out"])
    out = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"],
                                    PipelineConfig())
    ok = ~out["noise"]
    assert ok.sum() > 10_000
    c_u = np.corrcoef(out["u"][ok], ref["u"][ok])[0, 1]
    c_v = np.corrcoef(out["v"][ok], ref["v"][ok])[0, 1]
    assert c_u > 0.97, c_u
    assert c_v > 0.97, c_v
    speed = np.hypot(ref["u"][ok], ref["v"][ok]).mean()
    assert np.median(np.abs(out["u"][ok] - ref["u"][ok])) < 0.05 * speed


def test_rotdiv_flow_f64_totals(golden_rotdiv):
    """With f64 warp totals (the reference's own accumulator precision,
    object_model.h:10-13) the chain tracks the C++ for LONGER than the
    f32 Kahan carry.  The chain is chaotic, so the absolute bifurcation
    point moves with any change to summation order (a band-layout change
    shifted it from 8 to 6 slices in round 3) — the durable claim is
    RELATIVE: f64 must track at least as far as f32, and must still be
    tracking (corr > 0.97) on the first slice where f32 has already
    bifurcated.  (The residual f64 bifurcation stems from the f32 warp
    itself — the C++ carries pr/n in double and truncates only inside
    apply_project.)"""
    from jax import enable_x64

    from better_flow.config import PipelineConfig
    from better_flow.io.event_file import read_events, read_events_uv
    from better_flow.runtime.scan_pipeline import (
        compensate_recording_scan,
        plan_slices,
    )

    rec = read_events(golden_rotdiv["rec"])
    ref = read_events_uv(golden_rotdiv["ref_out"])
    out32 = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"],
                                      PipelineConfig())
    with enable_x64():
        out64 = compensate_recording_scan(
            rec["x"], rec["y"], rec["t_ns"],
            PipelineConfig(f64_totals=True))

    plan = plan_slices(rec["t_ns"], PipelineConfig())
    S = len(plan.ends)

    def track_until(out, thr=0.97):
        k_ok = 0
        for k in range(S):
            e = plan.ends[k] + 1
            if np.corrcoef(out["u"][:e], ref["u"][:e])[0, 1] >= thr:
                k_ok = k + 1
            else:
                break
        return k_ok

    k32 = track_until(out32)
    k64 = track_until(out64)
    assert k32 >= 5, k32          # both precisions track the early chain
    assert k64 >= k32, (k64, k32)
    if k32 < S:                   # f64 is still locked where f32 broke
        e = plan.ends[k32] + 1
        c64 = np.corrcoef(out64["u"][:e], ref["u"][:e])[0, 1]
        c32 = np.corrcoef(out32["u"][:e], ref["u"][:e])[0, 1]
        assert c64 >= 0.97, (c64, c32)
        assert c64 > c32, (c64, c32)
