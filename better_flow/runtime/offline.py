"""Offline (bufferized) processing of a whole recording.

Reference: the --bufferize-file path of bf_motion_compensator
(bf_motion_compensator.cpp:154-178): read everything, feed the estimator,
print per-slice wall time / event counts / time spans, then a final
recompute so every event is processed (:208).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from better_flow.config import PipelineConfig
from better_flow.runtime.dvs_flow import DVSFlow


def compensate_recording(
    x,
    y,
    t_ns,
    cfg: Optional[PipelineConfig] = None,
    verbose: bool = False,
    chunk: int = 262144,
) -> dict:
    """Run the full sliding-slice pipeline over a recording.

    Returns dict with the DVSFlow engine, accumulated (deduped) events, and
    throughput stats mirroring the reference's perf prints
    (bf_motion_compensator.cpp:166-173).
    """
    cfg = (cfg or PipelineConfig()).replace(accumulate=True)
    engine = DVSFlow(cfg)
    n = len(x)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    t_ns = np.asarray(t_ns, np.int64)

    t0 = time.perf_counter()
    done = 0
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        engine.add_events(x[start:end], y[start:end], t_ns[start:end])
        done = end
        if verbose and engine.slices:
            r = engine.slices[-1]
            print(
                f"{done * 100.0 / n:.1f} %\t{done}\t{r.wall_s:.4f} sec\t"
                f"{r.n_events} events\t"
                f"{engine.get_time_diff() / 1e9:.4f} slice_td\t"
                f"{engine.get_buf_time_diff() / 1e9:.4f} buffer_td"
            )
    # Final recompute: ensure every event processed
    # (bf_motion_compensator.cpp:208).
    if len(engine.buffer):
        engine.recompute()
    elapsed = time.perf_counter() - t0

    acc = engine.get_accumulated()
    slice_walls = [r.wall_s for r in engine.slices]
    stats = {
        "total_events": n,
        "elapsed_s": elapsed,
        "events_per_s": n / elapsed if elapsed > 0 else 0.0,
        "n_slices": len(engine.slices),
        "mean_slice_wall_s": float(np.mean(slice_walls)) if slice_walls else 0.0,
        "mean_iters": float(np.mean([r.iters for r in engine.slices]))
        if engine.slices
        else 0.0,
    }
    if verbose:
        print(f"Total flow elapsed: {elapsed:.3f} sec.")
    return {"engine": engine, "accumulated": acc, "stats": stats}
