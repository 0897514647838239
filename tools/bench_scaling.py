#!/usr/bin/env python
"""Throughput scaling protocol (BASELINE.md): the same recording through
the offline pipeline at 1 device and N devices (event-parallel sharded
scan).  On a machine with several GPUs this measures NVLink scaling; on
a single device it runs functionally on XLA's virtual host devices
(JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=N).

    python tools/bench_scaling.py [n_events] [device_counts...]
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    import jax

    from better_flow.config import PipelineConfig
    from better_flow.io.synthetic import synthetic_events
    from better_flow.parallel.event_parallel import (
        compensate_recording_scan_sharded,
    )
    from better_flow.parallel.mesh import make_event_mesh
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    args = [a for a in sys.argv[1:]]
    n_events = int(float(args[0])) if args else 200_000
    counts = [int(a) for a in args[1:]] or [1, 2, 4, 8]
    counts = [c for c in counts if c <= len(jax.devices())]

    cfg = PipelineConfig()
    d = synthetic_events(
        n_events, duration_s=n_events / 1_000_000, res_x=cfg.sensor.res_x,
        res_y=cfg.sensor.res_y, vx=60.0, vy=-40.0, rot=0.12, div=0.05,
        n_points=800, seed=42,
    )

    rows = []
    for n in counts:
        if n == 1:
            compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
            out = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
        else:
            mesh = make_event_mesh(n)
            compensate_recording_scan_sharded(d["x"], d["y"], d["t_ns"], cfg, mesh)
            out = compensate_recording_scan_sharded(d["x"], d["y"], d["t_ns"], cfg, mesh)
        st = out["stats"]
        rows.append({
            "devices": n,
            "events_per_s": round(st["events_per_s"], 1),
            "run_s": round(st["run_s"], 4),
            "u_med": round(float(np.median(out["u"][~out["noise"]])), 3),
        })
        print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    main()
