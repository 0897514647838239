"""Checkpoint/resume for the OFFLINE (cold) pipeline — VERDICT round-4
item 4: kill a cold run mid-recording, resume, and the output must be
bit-identical to the uninterrupted run.

The checkpoint payload is the batch-boundary scan carry (model + secant
seed + window-gate history — the exact multihost hand-off) plus each
completed batch's compact claimed results (scan_pipeline.
save_offline_checkpoint)."""

import numpy as np
import pytest

from better_flow.config import OptimizerConfig, PipelineConfig
from better_flow.io.synthetic import synthetic_events
from better_flow.runtime import scan_pipeline
from better_flow.runtime.scan_pipeline import (
    compensate_recording_cold,
    compensate_recording_scan,
)


@pytest.fixture(scope="module")
def recording():
    return synthetic_events(120_000, duration_s=0.6, res_x=64, res_y=80,
                            vx=40.0, vy=-25.0, rot=0.2, div=0.05,
                            n_points=300, seed=9)


def _cfg():
    return PipelineConfig(optimizer=OptimizerConfig(scale=3))


def test_cold_matches_scan(recording):
    """The restructured cold path (per-batch compact range accumulation
    with async fetch) must remain bit-identical to the one-program scan."""
    d = recording
    cfg = _cfg()
    scan = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    cold = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                     n_batch=4)
    np.testing.assert_array_equal(scan["u"], cold["u"])
    np.testing.assert_array_equal(scan["v"], cold["v"])
    np.testing.assert_array_equal(scan["noise"], cold["noise"])
    np.testing.assert_array_equal(scan["iters"], cold["iters"])


def test_kill_and_resume_bit_identical(recording, tmp_path, monkeypatch):
    """Kill the run while staging the third batch; the checkpoint then
    holds one completed batch.  The resumed run must reproduce the
    uninterrupted output exactly."""
    d = recording
    cfg = _cfg()
    ckpt = str(tmp_path / "cold.ckpt.npz")

    clean = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                      n_batch=4)

    calls = {"n": 0}
    orig = scan_pipeline.prepare_recording

    def dying_prepare(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated mid-run kill")
        return orig(*a, **k)

    monkeypatch.setattr(scan_pipeline, "prepare_recording", dying_prepare)
    with pytest.raises(RuntimeError, match="simulated"):
        compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                  n_batch=4, checkpoint_path=ckpt)
    monkeypatch.setattr(scan_pipeline, "prepare_recording", orig)

    import os
    assert os.path.exists(ckpt), "no checkpoint written before the kill"
    resumed = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                        n_batch=4, checkpoint_path=ckpt,
                                        resume=True)
    assert resumed["stats"]["resumed_batches"] >= 1
    np.testing.assert_array_equal(clean["u"], resumed["u"])
    np.testing.assert_array_equal(clean["v"], resumed["v"])
    np.testing.assert_array_equal(clean["noise"], resumed["noise"])
    np.testing.assert_array_equal(clean["iters"], resumed["iters"])
    for f in clean["model"]._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(clean["model"], f)),
            np.asarray(getattr(resumed["model"], f)), err_msg=f)


def test_fully_complete_checkpoint_short_circuits(recording, tmp_path):
    """Resuming from a checkpoint of a COMPLETED run re-launches nothing
    and still reproduces the full output."""
    d = recording
    cfg = _cfg()
    ckpt = str(tmp_path / "done.ckpt.npz")
    full = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                     n_batch=3, checkpoint_path=ckpt)
    again = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                      n_batch=3, checkpoint_path=None,
                                      resume=True)  # resume without path: fresh run
    np.testing.assert_array_equal(full["u"], again["u"])
    resumed = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                        n_batch=3, checkpoint_path=ckpt,
                                        resume=True)
    assert resumed["stats"]["resumed_batches"] == 3
    np.testing.assert_array_equal(full["u"], resumed["u"])
    np.testing.assert_array_equal(full["iters"], resumed["iters"])


def test_checkpoint_mismatch_raises(recording, tmp_path):
    d = recording
    cfg = _cfg()
    ckpt = str(tmp_path / "mm.ckpt.npz")
    compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg, n_batch=2,
                              checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="n_batch"):
        compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                  n_batch=3, checkpoint_path=ckpt,
                                  resume=True)


def test_checkpoint_config_digest_rejects_different_config(recording,
                                                           tmp_path):
    """Round-4 advisor (medium): changing the OPTIMIZER config between the
    killed run and the resume leaves n/S/n_batch unchanged, so without a
    config digest the resume silently stitched batches computed under two
    different configs.  The digest must reject it."""
    d = recording
    cfg = _cfg()
    ckpt = str(tmp_path / "cfg.ckpt.npz")
    compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg, n_batch=2,
                              checkpoint_path=ckpt)
    # Same slicing (n, S, n_batch identical) — only a tolerance changes.
    cfg2 = PipelineConfig(optimizer=OptimizerConfig(scale=3, dx_tol=2e-4))
    with pytest.raises(ValueError, match="config"):
        compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg2,
                                  n_batch=2, checkpoint_path=ckpt,
                                  resume=True)


def test_checkpoint_truncated_results_rejected(recording, tmp_path):
    """Round-4 advisor (low): a truncated/hand-edited checkpoint must fail
    at load time with a clear validation error, not deep in the scan."""
    d = recording
    cfg = _cfg()
    ckpt = str(tmp_path / "trunc.ckpt.npz")
    compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg, n_batch=2,
                              checkpoint_path=ckpt)
    z = dict(np.load(ckpt, allow_pickle=False))
    assert int(z["done_batches"]) >= 1
    z["acc_u_0"] = z["acc_u_0"][:-5]          # truncate one result array
    np.savez(ckpt, **z)
    with pytest.raises(ValueError, match="length"):
        compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                  n_batch=2, checkpoint_path=ckpt,
                                  resume=True)


def test_compact_results_wire_format(recording):
    """Round-5 wire format: compact_results fetches f16 u/v + bit-packed
    noise (4.125 B/event).  Noise must be exact; u/v within f16
    quantization of the exact path."""
    d = recording
    cfg = _cfg()
    exact = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                      n_batch=3)
    comp = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                     n_batch=3, compact_results=True)
    np.testing.assert_array_equal(exact["noise"], comp["noise"])
    np.testing.assert_array_equal(exact["iters"], comp["iters"])
    scale = np.maximum(np.abs(exact["u"]), 1.0)
    assert np.max(np.abs(exact["u"] - comp["u"]) / scale) < 1e-3
    scale_v = np.maximum(np.abs(exact["v"]), 1.0)
    assert np.max(np.abs(exact["v"] - comp["v"]) / scale_v) < 1e-3


def test_pack_unpack_roundtrip():
    """Unit: _pack_results/_unpack_results round-trip — u/v exactly the
    f16 cast, noise bit-exact, odd (non-multiple-of-8) lengths."""
    import jax.numpy as jnp

    from better_flow.runtime.scan_pipeline import (
        _pack_results, _unpack_results)

    rng = np.random.default_rng(1)
    for m in (8, 13, 1000):
        u = rng.normal(0, 80, m).astype(np.float32)
        v = rng.normal(0, 80, m).astype(np.float32)
        nz = rng.random(m) < 0.3
        buf = _pack_results(jnp.asarray(u), jnp.asarray(v),
                            jnp.asarray(nz))
        u2, v2, n2 = _unpack_results(buf, m)
        np.testing.assert_array_equal(u.astype(np.float16).astype(
            np.float32), u2)
        np.testing.assert_array_equal(v.astype(np.float16).astype(
            np.float32), v2)
        np.testing.assert_array_equal(nz, n2)


def test_compact_results_resume_bit_identical(recording, tmp_path,
                                              monkeypatch):
    """Kill-and-resume under compact_results: the resumed run must match
    the uninterrupted compact run exactly (stored results are the decoded
    values, so the f16 rounding is applied once, consistently)."""
    d = recording
    cfg = _cfg()
    ckpt = str(tmp_path / "compact.ckpt.npz")
    clean = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                      n_batch=4, compact_results=True)
    calls = {"n": 0}
    orig = scan_pipeline.prepare_recording

    def dying_prepare(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated mid-run kill")
        return orig(*a, **k)

    monkeypatch.setattr(scan_pipeline, "prepare_recording", dying_prepare)
    with pytest.raises(RuntimeError, match="simulated"):
        compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                  n_batch=4, checkpoint_path=ckpt,
                                  compact_results=True)
    monkeypatch.setattr(scan_pipeline, "prepare_recording", orig)
    resumed = compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                        n_batch=4, checkpoint_path=ckpt,
                                        resume=True, compact_results=True)
    np.testing.assert_array_equal(clean["u"], resumed["u"])
    np.testing.assert_array_equal(clean["v"], resumed["v"])
    np.testing.assert_array_equal(clean["noise"], resumed["noise"])
