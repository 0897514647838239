#!/usr/bin/env python
"""Accuracy benchmark: the BASELINE.md quality gates as one command.

Generates a synthetic GT recording, runs this framework (and the C++
reference binary when built — tools/build_reference.sh), and reports:
  - compensated-image occupancy & nonzero-mean sharpness (vs raw)
  - AEE vs ground truth per pipeline
  - per-event flow agreement and compensated-image PSNR between pipelines

    python tools/bench_accuracy.py [n_events] [--rot R] [--div D]
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

REF_BIN = os.environ.get(
    "BF_REFERENCE_BIN", "/tmp/refbuild/build/bf_motion_compensator"
)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("n_events", nargs="?", type=int, default=100_000)
    p.add_argument("--vx", type=float, default=60.0)
    p.add_argument("--vy", type=float, default=-40.0)
    p.add_argument("--rot", type=float, default=0.1)
    p.add_argument("--div", type=float, default=0.03)
    args = p.parse_args()

    from better_flow.config import PipelineConfig
    from better_flow.eval.metrics import aee, psnr
    from better_flow.io.event_file import read_events, read_events_uv, write_events
    from better_flow.io.synthetic import synthetic_events
    from better_flow.runtime.scan_pipeline import compensate_recording_scan
    from better_flow.viz.images import projection_img

    d = synthetic_events(
        args.n_events, duration_s=0.4, res_x=180, res_y=240,
        vx=args.vx, vy=args.vy, rot=args.rot, div=args.div,
        n_points=400, seed=21,
    )
    tmp = tempfile.mkdtemp()
    rec_p = os.path.join(tmp, "rec.txt")
    write_events(rec_p, d["x"], d["y"], d["t_ns"], d["polarity"])
    rec = read_events(rec_p)
    t_s = rec["t_ns"] / 1e9
    t_s = t_s - t_s.min()

    def metrics(u, v):
        img = projection_img(rec["x"] - u * t_s, rec["y"] - v * t_s, scale=3)
        nz = img[img > 0]
        return {
            "occupancy": int((img > 0).sum()),
            "sharpness": round(float(nz.mean()), 2) if len(nz) else 0.0,
            "aee_vs_gt": round(aee(u, v, d["u"], d["v"]), 3),
        }, img

    report = {"n_events": len(rec["x"]),
              "scene": {"vx": args.vx, "vy": args.vy,
                        "rot": args.rot, "div": args.div}}
    raw, _ = metrics(np.zeros(len(t_s)), np.zeros(len(t_s)))
    raw.pop("aee_vs_gt")
    report["raw"] = raw

    out = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"], PipelineConfig())
    ours, img_ours = metrics(out["u"], out["v"])
    ours["mean_iters"] = round(out["stats"]["mean_iters"], 1)
    report["better_flow"] = ours

    if os.path.exists(REF_BIN):
        ref_p = os.path.join(tmp, "ref.txt")
        subprocess.run([REF_BIN, rec_p, "-o", ref_p], check=True,
                       capture_output=True, timeout=1800)
        ref = read_events_uv(ref_p)
        refm, img_ref = metrics(ref["u"], ref["v"])
        report["cpp_reference"] = refm
        report["cross"] = {
            "median_abs_du": round(float(np.median(np.abs(out["u"] - ref["u"]))), 4),
            "corr_u": round(float(np.corrcoef(out["u"], ref["u"])[0, 1]), 4),
            "psnr_compensated": round(
                psnr(img_ours.astype(float), img_ref.astype(float), peak=255.0), 2
            ),
        }
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
