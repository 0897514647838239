#!/usr/bin/env python
"""Device-trace profile of the scan pipeline.

Runs a short bench-shaped recording under jax.profiler.trace, then prints
a per-op aggregate of the device's kernel rows and the timeline of one
window around a slice.

    python tools/profile_scan.py [n_events]
"""

import collections
import glob
import gzip
import json
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    import jax

    from better_flow.config import OptimizerConfig, PipelineConfig
    from better_flow.io.synthetic import synthetic_events
    from better_flow.runtime.scan_pipeline import (
        compensate_recording_scan,
        prepare_recording,
    )

    n_events = int(float(sys.argv[1])) if len(sys.argv) > 1 else 500_000
    cfg = PipelineConfig(optimizer=OptimizerConfig.fast())
    d = synthetic_events(n_events, duration_s=n_events / 1e6, res_x=180,
                         res_y=240, vx=60.0, vy=-40.0, rot=0.12, div=0.05,
                         n_points=800, seed=42)
    prepared = prepare_recording(d["x"], d["y"], d["t_ns"], cfg)
    compensate_recording_scan(None, None, None, cfg, prepared=prepared)

    tdir = tempfile.mkdtemp(prefix="bf_trace_")
    with jax.profiler.trace(tdir):
        out = compensate_recording_scan(None, None, None, cfg,
                                        prepared=prepared)
    print(f"run_s {out['stats']['run_s']:.4f}  "
          f"slices {out['stats']['n_slices']}  "
          f"mean_iters {out['stats']['mean_iters']:.2f}")

    traces = glob.glob(f"{tdir}/plugins/profile/*/*.trace.json.gz")
    if not traces:
        print("no trace emitted (profiler unsupported on this backend?)")
        return
    ev = json.load(gzip.open(traces[0]))
    events = ev["traceEvents"]
    pids, tids = {}, {}
    for e in events:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                pids[e["pid"]] = e["args"].get("name", "")
            if e.get("name") == "thread_name":
                tids[(e["pid"], e["tid"])] = e["args"].get("name", "")
    # GPU device planes are named "/device:GPU:<n>..."; their rows are
    # CUDA streams (and, on some versions, an "XLA Ops" summary row that
    # would count every kernel twice — keep only that one when present).
    on_gpu = [e for e in events if e.get("ph") == "X"
              and "/device:GPU" in pids.get(e["pid"], "")]
    xla_ops = [e for e in on_gpu
               if tids.get((e["pid"], e["tid"])) == "XLA Ops"]
    dev = xla_ops or on_gpu
    if not dev:
        print("no GPU device rows in the trace")
        return

    agg = collections.Counter()
    cnt = collections.Counter()
    for e in dev:
        agg[e["name"][:44]] += e.get("dur", 0)
        cnt[e["name"][:44]] += 1
    print("\nper-op total (inclusive) device time:")
    for name, dur in agg.most_common(20):
        print(f"  {dur / 1e3:8.2f} ms x{cnt[name]:5d} "
              f"avg {dur / max(cnt[name], 1):7.1f} us  {name}")

    # One ~500 us window mid-run: the per-slice timeline.
    t0 = dev[len(dev) // 2]["ts"]
    win = sorted((e for e in dev if t0 <= e["ts"] <= t0 + 500),
                 key=lambda e: e["ts"])
    print("\ntimeline window (us offsets):")
    for e in win[:60]:
        print(f"  {e['ts'] - t0:7.1f} +{e.get('dur', 0):6.1f} "
              f"{e['name'][:44]}")
    print(f"\ntrace dir kept at {tdir} (tensorboard-compatible)")


if __name__ == "__main__":
    main()
