#!/usr/bin/env python
"""Tiled (config-5) pipeline cost on the live backend.

Runs compensate_recording_tiled at 720x1280 scale 1 on a 1x1 device mesh
and the untiled compensate_recording_scan on the same recording,
reporting per-iteration and per-slice device cost for both.

A 1-device mesh exercises compile + compute cost, NOT collectives: the
halo ppermutes and the escape-lane all_gather are size-1-axis no-ops.

    python tools/bench_tiled.py [n_events]
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    import jax

    from better_flow.config import (
        OptimizerConfig,
        PipelineConfig,
        SensorConfig,
        SliceConfig,
    )
    from better_flow.io.synthetic import synthetic_events
    from better_flow.parallel.spatial import compensate_recording_tiled
    from better_flow.runtime.scan_pipeline import (
        compensate_recording_scan,
        prepare_recording,
    )

    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 600_000
    cfg = PipelineConfig(
        sensor=SensorConfig(720, 1280),
        slice=SliceConfig(max_events=60_000, span_ns=int(0.07e9),
                          refresh_events=25_000,
                          refresh_time_ns=int(0.03e9)),
        optimizer=OptimizerConfig(scale=1, max_iter=10, min_events=1000),
    )
    d = synthetic_events(n, duration_s=n / 1.5e6, res_x=720, res_y=1280,
                         vx=120.0, vy=-80.0, rot=0.1, div=0.03,
                         n_points=600, jitter_px=1.5, seed=4)

    # Untiled: prepared shared across warmup + measure.
    prep = prepare_recording(d["x"], d["y"], d["t_ns"], cfg)
    compensate_recording_scan(None, None, None, cfg, prepared=prep)
    out_u = compensate_recording_scan(None, None, None, cfg, prepared=prep)
    su = out_u["stats"]
    it_u = int(np.asarray(out_u["iters"]).sum())

    mesh = jax.make_mesh((1, 1), ("tile_x", "tile_y"),
                         devices=jax.devices()[:1])
    from better_flow.parallel.spatial import prepare_recording_tiled

    detail = {
        "n_events": int(n), "n_slices": int(su["n_slices"]),
        "untiled_run_s": round(su["run_s"], 4),
        "untiled_iters": it_u,
        "untiled_us_per_iter": round(su["run_s"] / max(it_u, 1) * 1e6, 1),
        "device": str(jax.devices()[0]),
    }
    prep_t = prepare_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, 1, 1)
    compensate_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, mesh,
                               halo=32, esc_cap=32768, prepared=prep_t)
    out_t = compensate_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, mesh,
                                       halo=32, esc_cap=32768,
                                       prepared=prep_t)
    # stats["run_s"] is the checksum-forced device scan time — the
    # apples-to-apples row vs the untiled stats (the call's wall also pays
    # the [n] result fetch).
    run_t = out_t["stats"]["run_s"]
    it_t = int(np.asarray(out_t["iters"]).sum())
    ok = ~(out_u["noise"] | out_t["noise"])
    du = float(np.median(np.abs(out_t["u"][ok] - out_u["u"][ok]))) \
        if ok.any() else 0.0
    per_iter = round(run_t / max(it_t, 1) * 1e6, 1)
    detail.update({
        "tiled_run_s": round(run_t, 4),
        "tiled_iters": it_t,
        "tiled_us_per_iter": per_iter,
        "tiled_escaped_dropped": int(out_t["stats"]["escaped_dropped"]),
        "tiled_flow_median_dev_vs_untiled": du,
    })

    print(json.dumps({
        "metric": "tiled_1x1_per_iter_us",
        "value": per_iter,
        "unit": "us/iteration (720x1280 scale 1, 1x1 mesh)",
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
