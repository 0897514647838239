#!/usr/bin/env python
"""Streaming-path realtime factor (VERDICT r1 item 7).

Measures DVSFlow at the ROS low-latency preset (30k events / 0.07 s slices,
scale 1, max 10 iterations — bf_visualizer.cpp:33-34, 102-104) on the live
device, reporting the reference's own instrumentation metric:

    %realtime = slice time-span / wall-clock processing time
    (dvs_flow.h:275-282; >= 1 means the pipeline keeps up with the sensor)

plus per-slice wall times and the processing lag a live feed would see
(bf_visualizer.cpp:181-200).  Events are fed in sensor-rate batches through
DVSFlow.add_events, so trigger cadence matches a live camera.

    python tools/bench_streaming.py
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    import jax

    from better_flow.config import low_latency_config
    from better_flow.io.synthetic import synthetic_events
    from better_flow.runtime.dvs_flow import DVSFlow

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    rate = float(args[0]) if args else 430_000.0  # ev/s
    duration = float(args[1]) if len(args) > 1 else 2.0
    # --config=low_latency (ROS preset, default) | default (the reference
    # binary's own operating point: 50k/0.2 s slices, 20k/33 ms triggers,
    # scale 3, unbounded iterations — bf_motion_compensator.cpp:6-10).
    which = "low_latency"
    depth = 0
    compact = False
    for f in flags:
        if f.startswith("--config="):
            which = f.split("=", 1)[1]
        elif f.startswith("--depth="):
            depth = int(f.split("=", 1)[1])
        elif f == "--compact":
            compact = True
    if which == "low_latency":
        cfg = low_latency_config()
    else:
        from better_flow.config import PipelineConfig

        cfg = PipelineConfig()
    d = synthetic_events(
        int(rate * duration), duration_s=duration,
        res_x=cfg.sensor.res_x, res_y=cfg.sensor.res_y,
        vx=60.0, vy=-40.0, rot=0.1, div=0.03, n_points=800, seed=42,
    )
    n = len(d["x"])

    # Warm the jit at the preset's shapes (a live deployment pays the
    # compile once at startup).
    flow = DVSFlow(cfg, pipeline_depth=depth, compact_fetch=compact)
    warm_n = min(cfg.slice.refresh_events + 1000, n)
    flow.add_events(d["x"][:warm_n], d["y"][:warm_n], d["t_ns"][:warm_n])
    flow.flush()

    flow = DVSFlow(cfg, pipeline_depth=depth, compact_fetch=compact)
    spans, walls, lags, intervals = [], [], [], []
    t_start = time.perf_counter()

    def on_slice(rec):
        spans.append(rec.timestamp[-1] - rec.slice_start_time)
        walls.append(rec.wall_s)
        intervals.append(rec.interval_s)
        # lag: wall-clock position in the feed vs event time processed
        feed_pos = (time.perf_counter() - t_start) * 1e9
        lags.append((feed_pos - float(rec.timestamp[-1])) / 1e6)  # ms

    flow.on_slice = on_slice
    # Feed in 10 ms batches (a live driver's callback cadence).
    batch_ns = int(10e6)
    t_ns = d["t_ns"]
    edges = np.searchsorted(t_ns, np.arange(0, t_ns[-1] + batch_ns, batch_ns))
    for a, b in zip(edges[:-1], edges[1:]):
        if b > a:
            flow.add_events(d["x"][a:b], d["y"][a:b], t_ns[a:b])
    flow.flush()

    spans_s = np.asarray(spans, float) / 1e9
    walls_s = np.asarray(walls, float)
    # Sustained (throughput) realtime: span per finalize INTERVAL — with
    # pipelining the per-slice latency (wall_s) overlaps across slices,
    # so the keeping-up metric is the interval; at depth 0 the two agree
    # (interval ~ wall + host feed time).
    ivals_s = np.asarray(intervals, float)
    feed_rate = rate
    realtime = spans_s / np.maximum(walls_s, 1e-9)
    if depth > 0:
        realtime = spans_s / np.maximum(ivals_s, 1e-9)
    out = {
        "metric": "streaming_realtime_factor",
        "value": round(float(np.median(realtime)), 3),
        "unit": "x (slice span / wall, >=1 keeps up)",
        "detail": {
            "n_events": int(n),
            "n_slices": len(walls),
            "wall_ms_med": round(float(np.median(walls_s)) * 1e3, 2),
            "wall_ms_p90": round(float(np.percentile(walls_s, 90)) * 1e3, 2),
            "span_ms_med": round(float(np.median(spans_s)) * 1e3, 2),
            "lag_ms_final": round(float(lags[-1]), 1) if lags else None,
            "latency_ms_med": round(float(np.median(walls_s)) * 1e3, 2),
            "pipeline_depth": depth,
            "compact_fetch": compact,
            "feed_rate_ev_s": feed_rate,
            "config": which,
            "device": str(jax.devices()[0]),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
