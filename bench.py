#!/usr/bin/env python
"""Throughput benchmark: events/s through the full motion-compensation
pipeline at the reference's production configuration.

Protocol: DVS 240x180 stream, sliding slices of <=50k events / 0.2 s,
retrigger every 20k events or 33 ms, scale 3 — the defaults of
bf_motion_compensator (bf_motion_compensator.cpp:6-10).  The benchmark feeds
a synthetic recording through the device-resident scanned pipeline
(runtime/scan_pipeline.py), excludes the one-off jit compile via a warmup
run, and reports sustained events/s.  The reference publishes no numbers of
its own (SURVEY.md §6).

    python bench.py [n_events] [--schedule=fast|fast_accurate|fast_throughput|reference]

On an accelerator the default recording is 48M events.  The CPU backend is
refused unless ``n_events`` is given: a CPU run measures nothing a user
deploys.  Prints exactly one JSON line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

DEFAULT_EVENTS = 48_000_000


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s card name and power limit, or "" where it is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def bench_recording(n_events: int) -> dict:
    """A 1 Mev/s synthetic stream (typical DVS rates) with moderate motion.

    Long streams tile a 0.5 s base segment in time: the scene's 60 px/s
    drift exits the 180 px frame beyond ~2 s (silently collapsing event
    density) and already empties the frame margins toward a segment's end.
    0.5 s keeps occupancy ~constant; motion is continuous within segments
    with a scene jump at each boundary — repeated camera sweeps.  Ground
    truth (u, v) is tiled with the events."""
    from better_flow.io.synthetic import synthetic_events

    seg_events = min(n_events, 500_000)
    seg_dur = seg_events / 1_000_000
    n_segments = max(1, round(n_events / seg_events))
    base = synthetic_events(
        seg_events, duration_s=seg_dur, res_x=180, res_y=240,
        vx=60.0, vy=-40.0, rot=0.12, div=0.05, n_points=800, seed=42,
    )
    if n_segments == 1:
        return base
    step_ns = int(seg_dur * 1e9)
    return {
        "x": np.tile(base["x"], n_segments),
        "y": np.tile(base["y"], n_segments),
        "t_ns": np.concatenate(
            [base["t_ns"] + k * step_ns for k in range(n_segments)]),
        "u": np.tile(base["u"], n_segments),
        "v": np.tile(base["v"], n_segments),
    }


def main():
    import jax

    from better_flow.config import OptimizerConfig, PipelineConfig
    from better_flow.runtime.device import (
        enable_compile_cache,
        scan_budget_bytes,
    )
    from better_flow.runtime.scan_pipeline import (
        _estimate_scan_device_bytes,
        compensate_recording_cold,
        compensate_recording_scan,
        prepare_recording,
    )

    enable_compile_cache()
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    if jax.default_backend() == "cpu" and not args:
        raise SystemExit(
            "bench.py: no accelerator found; give n_events explicitly to "
            "run on the CPU backend")
    n_events = int(float(args[0])) if args else DEFAULT_EVENTS
    schedule = "fast"
    for f in flags:
        if f.startswith("--schedule="):
            schedule = f.split("=", 1)[1]
    # Reference defaults (180x240, 50k/0.2s slices, 20k/33ms triggers,
    # scale 3) with the chosen optimizer preset — the fast presets are
    # quality-gated against the parity schedule in
    # tests/test_fast_schedule.py.
    opt = {"fast": OptimizerConfig.fast,
           "fast_throughput": OptimizerConfig.fast_throughput,
           "fast_accurate": OptimizerConfig.fast_accurate,
           "reference": OptimizerConfig}[schedule]()
    cfg = PipelineConfig(optimizer=opt)
    d = bench_recording(n_events)
    n_real = len(d["x"])

    budget = scan_budget_bytes()
    est = _estimate_scan_device_bytes(d["t_ns"], cfg)
    if budget is not None and est > budget:
        # Beyond the device-residency budget the scan routes through the
        # batch-pipelined bounded-memory cold path; the number is then
        # END-TO-END (staging+run+fetch overlapped), flagged as
        # routed_cold in detail.
        print(f"[bench] estimated {est / 1e9:.1f} GB device residency > "
              f"{budget / 1e9:.1f} GB budget: bounded-memory cold routing",
              file=sys.stderr, flush=True)
        warm = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
        out = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
        plan_bd = None
    else:
        print(f"[bench] {n_real} events, planning + staging...",
              file=sys.stderr, flush=True)
        # Warmup at identical shapes: the scan program is static over
        # (slice count, capacity, n_total), so the warmup reuses the same
        # staged recording or it compiles twice.
        prepared = prepare_recording(d["x"], d["y"], d["t_ns"], cfg)
        t0 = time.time()
        warm = compensate_recording_scan(None, None, None, cfg,
                                         prepared=prepared)
        print(f"[bench] warmup done in {time.time() - t0:.1f}s; "
              "measuring...", file=sys.stderr, flush=True)
        out = compensate_recording_scan(None, None, None, cfg,
                                        prepared=prepared)
        plan_bd = prepared.get("plan_breakdown")
        del prepared
    st = out["stats"]
    compile_s = warm["stats"]["run_s"] - st["run_s"]
    del warm

    # Cold = end-to-end one-shot processing via the batch-pipelined path
    # (staging of batch k+1 overlaps device execution of batch k, carry
    # chained on device).  First call warms the batch-shaped programs;
    # the second is the measurement.
    print("[bench] cold-path measurement...", file=sys.stderr, flush=True)
    n_cold = min(n_real, 12_000_000)
    xc, yc, tc = d["x"][:n_cold], d["y"][:n_cold], d["t_ns"][:n_cold]
    compensate_recording_cold(xc, yc, tc, cfg)
    cold = compensate_recording_cold(xc, yc, tc, cfg)["stats"]

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "pipeline_throughput",
        "value": st["events_per_s"],
        "unit": "events/s",
        "detail": {
            "n_events": st["n_events"],
            "n_slices": st["n_slices"],
            "run_s": st["run_s"],
            "plan_s": st["plan_s"],
            "compile_s": compile_s,
            "plan_breakdown": plan_bd,
            "routed_cold": bool(st.get("routed_cold", False)),
            "cold_events_per_s": cold["events_per_s"],
            "mean_iters": st["mean_iters"],
            "schedule": schedule,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "gpu": gpu_name_and_power_limit(),
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
        },
    }))


if __name__ == "__main__":
    main()
