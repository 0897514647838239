#!/usr/bin/env python
"""Per-iteration internals of the fast schedule on a bench-like chain.

Drives the optimizer slice by slice in EAGER mode with
BF_DEBUG_FASTLOOP so _fast_loop records (g, d, slope, dividers, totals)
at every iteration — the dataset behind predicted-exit design decisions
(round-5: kill the mode-4 confirmation iteration).

    python tools/trace_fastloop.py [n_events] [--out /tmp/trace.npz]
"""

import json
import os
import pathlib
import sys

os.environ["BF_DEBUG_FASTLOOP"] = "1"
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 and not sys.argv[1].startswith("--") else 500_000
    import jax
    import jax.numpy as jnp

    from better_flow.config import OptimizerConfig, PipelineConfig
    from better_flow.core.events import EventSlice
    from better_flow.io.synthetic import synthetic_events
    from better_flow.models import global_flow
    from better_flow.models.global_flow import process_slice
    from better_flow.runtime.scan_pipeline import prepare_recording

    d = synthetic_events(n, duration_s=n / 1e6, res_x=180, res_y=240,
                         vx=60.0, vy=-40.0, rot=0.12, div=0.05,
                         n_points=800, seed=42)
    cfg = PipelineConfig(optimizer=OptimizerConfig.fast())
    prep = prepare_recording(d["x"], d["y"], d["t_ns"], cfg)
    S = len(prep["plan"].ends)
    xs = np.asarray(prep["xs16"]).astype(np.float32)
    ys = np.asarray(prep["ys16"]).astype(np.float32)
    ts = np.asarray(prep["ts"])
    perm = np.asarray(prep["perm"])
    starts = np.asarray(prep["starts"])
    ends = np.asarray(prep["ends"])
    bbox = np.asarray(prep["bbox"])
    nval = np.asarray(prep["nval"])
    hist_k = prep["hist_k"]

    from better_flow.core.model import MotionModel
    from better_flow.runtime.scan_pipeline import PERM_SENTINEL

    model = MotionModel.zero()
    sd = None
    ws_h = np.zeros(hist_k, bool)
    st_h = np.zeros(hist_k, np.int32)
    en_h = np.full(hist_k, -1, np.int32)
    slices = []
    with jax.disable_jit():
        for s in range(S):
            m = perm[s] != PERM_SENTINEL
            sidx = np.where(m, starts[s] + perm[s].astype(np.int64), -1)
            valid = sidx >= 0
            noise = np.zeros_like(valid)
            for j in range(hist_k):
                noise |= ws_h[j] & (sidx >= st_h[j]) & (sidx <= en_h[j])
            ev = EventSlice(x=jnp.asarray(xs[s]), y=jnp.asarray(ys[s]),
                            t=jnp.asarray(ts[s]),
                            valid=jnp.asarray(valid),
                            noise=jnp.asarray(noise & valid))
            res = process_slice(ev, model, cfg.optimizer, cfg.sensor,
                                warm_start=True, seed=sd,
                                bbox=jnp.asarray(bbox[s]),
                                n_valid=int(nval[s]))
            tr = getattr(global_flow._fast_loop, "last_trace", None)
            slices.append(dict(s=s, iters=int(res.iters),
                               ran=bool(res.ran), trace=tr))
            global_flow._fast_loop.last_trace = None
            ws_h = np.concatenate([ws_h[1:], [bool(res.window_small)]])
            st_h = np.concatenate([st_h[1:], [starts[s]]])
            en_h = np.concatenate([en_h[1:], [ends[s]]])
            model = res.model
            sd = res.seed
            print(f"slice {s}: iters={int(res.iters)} ran={bool(res.ran)}",
                  flush=True)

    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv \
        else "/tmp/trace_fastloop.npz"
    np.savez(out, payload=np.frombuffer(
        json.dumps([
            dict(s=r["s"], iters=r["iters"], ran=r["ran"],
                 trace=[{k: (v.tolist() if hasattr(v, "tolist") else v)
                         for k, v in t.items()} for t in (r["trace"] or [])])
            for r in slices
        ]).encode(), dtype=np.uint8))
    print(f"wrote {out}; iters hist:",
          np.bincount([r["iters"] for r in slices]))


if __name__ == "__main__":
    main()
