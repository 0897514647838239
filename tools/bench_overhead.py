#!/usr/bin/env python
"""Split the scan pipeline's per-slice cost into per-iteration kernel cost
vs per-slice fixed overhead (scan-step glue: noise history, geometry,
epilogue warp, output writes, loop dispatch).

Runs the production compact scan on one prepared recording with the
optimizer forced to exactly K iterations per slice (zero tolerances +
max_iter cap), for several K:

    per_slice(K) = overhead + K * per_iter

    PYTHONPATH=. python tools/bench_overhead.py
"""

import time

import numpy as np

from better_flow.config import OptimizerConfig, PipelineConfig
from better_flow.io.synthetic import synthetic_events
from better_flow.runtime.scan_pipeline import (
    compensate_recording_scan,
    prepare_recording,
)


def main():
    n_events = 1_000_000
    d = synthetic_events(
        n_events, duration_s=0.5, res_x=180, res_y=240,
        vx=60.0, vy=-40.0, rot=0.12, div=0.05, n_points=800, seed=42,
    )
    x, y, t_ns = d["x"], d["y"], d["t_ns"]

    results = {}
    prepared = None
    for k in (1, 5, 9):
        cfg = PipelineConfig(optimizer=OptimizerConfig.fast(
            dx_tol=0.0, dy_tol=0.0, rot_tol=0.0, div_tol=0.0,
            max_iter=k - 1,
        ))
        if prepared is None:
            prepared = prepare_recording(x, y, t_ns, cfg)
        res = compensate_recording_scan(x, y, t_ns, cfg, prepared=prepared)
        # warm run (first call compiled)
        best = np.inf
        for _ in range(3):
            res = compensate_recording_scan(x, y, t_ns, cfg, prepared=prepared)
            best = min(best, res["stats"]["run_s"])
        S = res["stats"]["n_slices"]
        mean_iters = res["stats"]["mean_iters"]
        per_slice = best / S
        results[k] = per_slice
        print(f"K={k}  mean_iters={mean_iters:.2f}  run_s={best:.4f}  "
              f"per-slice={per_slice * 1e6:7.1f} us", flush=True)

    ks = sorted(results)
    k1, k2 = ks[0], ks[-1]
    per_iter = (results[k2] - results[k1]) / (k2 - k1)
    overhead = results[k1] - k1 * per_iter
    print(f"per-iteration = {per_iter * 1e6:.1f} us   "
          f"per-slice overhead = {overhead * 1e6:.1f} us")


if __name__ == "__main__":
    main()
