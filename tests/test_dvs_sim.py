"""Sensor-realistic simulator (io/dvs_sim.py): statistics + pipeline smoke.

The realistic stream exists because constant-density synthetic data
flatters the optimizer (VERDICT r1): real DVS recordings carry threshold
mismatch, refractory flooring, background-activity noise, hot pixels, and
bursty rates.  These tests pin those statistics and check the pipeline
recovers the flow through the noise.
"""

import numpy as np

from better_flow.io.dvs_sim import dvs_events


def test_stream_statistics():
    d = dvs_events(200_000, duration_s=0.4, vx=60, vy=-40, rot=0.1,
                   div=0.03, seed=7)
    n = len(d["x"])
    assert 100_000 < n < 400_000
    assert np.all(np.diff(d["t_ns"]) >= 0)
    assert d["x"].min() >= 0 and d["x"].max() <= 179
    assert d["y"].min() >= 0 and d["y"].max() <= 239

    # noise present but not dominant
    nf = d["is_noise"].mean()
    assert 0.02 < nf < 0.5, nf

    # bursty rate: coefficient of variation across 20 ms bins well above
    # the Poisson-only floor
    bins = np.bincount((d["t_ns"] / 2e7).astype(int))
    assert bins.std() / bins.mean() > 0.1

    # threshold mismatch: wide per-pixel count dispersion on signal events
    sig = ~d["is_noise"]
    pix = (d["x"][sig] * 240 + d["y"][sig]).astype(int)
    cnt = np.bincount(pix)
    cnt = cnt[cnt > 0]
    assert cnt.std() / cnt.mean() > 0.4

    # refractory: no pixel fires twice inside the same tau bin
    tbin = (d["t_ns"] / 1e6).astype(np.int64)  # 1 ms
    key = (d["x"].astype(np.int64) * 240 + d["y"].astype(np.int64)) * (
        int(0.4 / 1e-3) + 2
    ) + tbin
    assert len(np.unique(key)) == len(key)


def test_pipeline_recovers_flow_through_noise():
    """The scan pipeline on a noisy, bursty stream still recovers the global
    motion on ground-truth (signal) events."""
    from better_flow.config import PipelineConfig
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    d = dvs_events(120_000, duration_s=0.4, vx=60, vy=-40, rot=0.0,
                   div=0.0, seed=3)
    out = compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                    PipelineConfig())
    ok = (~out["noise"]) & (~d["is_noise"])
    assert ok.sum() > 10_000
    # medians within 15% of ground truth despite ~15% junk events
    assert abs(np.median(out["u"][ok]) - 60.0) < 9.0
    assert abs(np.median(out["v"][ok]) - (-40.0)) < 6.0
