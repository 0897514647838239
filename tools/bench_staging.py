#!/usr/bin/env python
"""Decompose cold-path staging (plan_s) at the bench protocol.

Phases timed separately on the same recording bench.py uses:
  plan        trigger-plan arithmetic (numpy searchsorted loop)
  coords_u16  native one-pass coordinate narrowing
  sort        native threaded counting sort (all batches, no device_put)
  put         jax.device_put of the slabs + block_until_ready
  total       prepare_recording end to end (sort/put pipelined)
  run         steady-state scan (prepared reused)

Prints one JSON line.  Compare phases within one run only.

    python tools/bench_staging.py [n_events]
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    import jax

    from better_flow.config import OptimizerConfig, PipelineConfig
    from better_flow.io import native as _native
    from better_flow.io.synthetic import synthetic_events
    from better_flow.runtime.device import enable_compile_cache
    from better_flow.runtime.scan_pipeline import (
        BAND_ROWS,
        CHUNK,
        compensate_recording_scan,
        plan_slices,
        prepare_recording,
    )

    enable_compile_cache()

    n_events = int(float(sys.argv[1])) if len(sys.argv) > 1 else 12_000_000
    cfg = PipelineConfig(optimizer=OptimizerConfig.fast())
    seg_events = min(n_events, 500_000)
    seg_dur = seg_events / 1_000_000
    n_segments = max(1, round(n_events / seg_events))
    base = synthetic_events(seg_events, duration_s=seg_dur, res_x=180,
                            res_y=240, vx=60.0, vy=-40.0, rot=0.12,
                            div=0.05, n_points=800, seed=42)
    step_ns = int(seg_dur * 1e9)
    x = np.tile(base["x"], n_segments)
    y = np.tile(base["y"], n_segments)
    t_ns = np.concatenate(
        [base["t_ns"] + k * step_ns for k in range(n_segments)])
    t_ns = np.ascontiguousarray(t_ns, np.int64)

    out = {"n_events": len(x)}
    t0 = time.perf_counter()
    plan = plan_slices(t_ns, cfg)
    out["plan_s"] = round(time.perf_counter() - t0, 4)

    t0 = time.perf_counter()
    x16y16 = _native.coords_u16(x, y)
    out["coords_s"] = round(time.perf_counter() - t0, 4)

    band_rows = BAND_ROWS  # the production sort-band layout, not a copy
    n_bands = (cfg.sensor.res_x + band_rows - 1) // band_rows
    cap = cfg.slice.max_events
    capp = -(-(cap + n_bands * (CHUNK - 1)) // CHUNK) * CHUNK
    t0 = time.perf_counter()
    sort_out = _native.materialize_bandpad_u16(
        x16y16[0], x16y16[1], t_ns, plan.starts, plan.ends,
        plan.slice_start_ns, capp, band_rows, CHUNK, n_bands,
        cfg.sensor.res_y)
    out["sort_s"] = round(time.perf_counter() - t0, 4)
    S = len(plan.ends)
    slab_mb = sum(a.nbytes for a in sort_out[:4]) / 1e6
    out["slab_mb"] = round(slab_mb, 1)

    t0 = time.perf_counter()
    devs = [jax.device_put(a) for a in sort_out[:4]]
    jax.block_until_ready(devs)
    out["put_s"] = round(time.perf_counter() - t0, 4)
    out["put_gbps"] = round(slab_mb / 1000 / max(out["put_s"], 1e-9), 3)
    del devs

    t0 = time.perf_counter()
    prepared = prepare_recording(x, y, t_ns, cfg)
    jax.block_until_ready([prepared[k] for k in
                           ("xs16", "ys16", "ts", "perm")
                           if k in prepared])
    out["prepare_total_s"] = round(time.perf_counter() - t0, 4)

    warm = compensate_recording_scan(None, None, None, cfg,
                                     prepared=prepared)
    run = compensate_recording_scan(None, None, None, cfg,
                                    prepared=prepared)
    out["run_s"] = round(run["stats"]["run_s"], 4)
    out["warm_run_s"] = round(warm["stats"]["run_s"], 4)
    out["n_slices"] = S
    out["cold_ev_s"] = round(len(x) / (out["prepare_total_s"] + out["run_s"]), 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
