#!/usr/bin/env python
"""Seed-swept quality table for the fast schedule's exit knobs.

Round-5 measurement harness for two VERDICT items:

  * ``exit_delta_factor`` (REMOVED by this sweep's results — see
    config.py): factors 1.1-1.5 saved <3% iterations with noisy-mean
    degradation; >=2 systematically under-converged rot/div scenes.
    The delta variants below are kept for reproducing the decision via
    ``exit_predict_cap``-era git history; running them now raises.
  * ``exit_predict_cap`` — the model-validated one-step-ahead exit
    (kill the mode-4 "confirmation iteration").  This sweep + the
    rotdiv-777 trace analysis decided the preset keeps it OFF.

Scenes mirror tests/test_fast_schedule.py's gates (production, rotdiv,
dvs_sim noisy); seeds vary the scene geometry/noise stream.  For every
(scene, seed) the reference schedule is the AEE denominator, computed
fresh for that seed.  Quality is platform-independent (the gates run on
CPU); run throughput separately on the accelerator via bench.py.

    python tools/sweep_exit.py [--out /tmp/sweep.json] [--quick]
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from better_flow.config import OptimizerConfig, PipelineConfig


def _scene(name, seed):
    from better_flow.io.synthetic import synthetic_events

    if name == "production":
        return synthetic_events(200_000, duration_s=0.2, res_x=180,
                                res_y=240, vx=60.0, vy=-40.0, rot=0.12,
                                div=0.05, n_points=800, seed=seed), None
    if name == "rotdiv":
        return synthetic_events(150_000, duration_s=0.2, res_x=180,
                                res_y=240, vx=10.0, vy=8.0, rot=0.6,
                                div=0.12, n_points=600, seed=seed), None
    if name == "noisy":
        from better_flow.io.dvs_sim import dvs_events

        d = dvs_events(120_000, duration_s=0.25, res_x=180, res_y=240,
                       vx=45.0, vy=-30.0, rot=0.1, div=0.04, seed=seed)
        return d, ~d["is_noise"]
    raise ValueError(name)


def _aee_med(out, d, extra_mask=None):
    m = ~out["noise"]
    if extra_mask is not None:
        m &= extra_mask
    return float(np.median(
        np.hypot(out["u"][m] - d["u"][m], out["v"][m] - d["v"][m])))


SCENE_SEEDS = {
    "production": [42, 101, 202, 303, 404],
    "rotdiv": [777, 11, 23, 57, 91],
    "noisy": [31, 7, 99, 11, 5],
}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="/tmp/sweep_exit.json")
    p.add_argument("--quick", action="store_true",
                   help="2 seeds/scene, fewer variants")
    p.add_argument("--variants", default=None,
                   help="comma list, e.g. fast,delta1.2,pred2")
    args = p.parse_args()

    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    variants = {
        "fast": {},
        "pred1.2": dict(exit_predict_cap=1.2),
        "pred1.5": dict(exit_predict_cap=1.5),
        "pred2": dict(exit_predict_cap=2.0),
        "pred4": dict(exit_predict_cap=4.0),
        "pred8": dict(exit_predict_cap=8.0),
    }
    if args.quick:
        variants = {k: v for k, v in variants.items()
                    if k in ("fast", "delta1.2", "pred2", "pred4")}
    if args.variants:
        keep = set(args.variants.split(","))
        variants = {k: v for k, v in variants.items() if k in keep}

    rows = []
    for scene, seeds in SCENE_SEEDS.items():
        if args.quick:
            seeds = seeds[:2]
        for seed in seeds:
            d, sig = _scene(scene, seed)
            ref = compensate_recording_scan(
                d["x"], d["y"], d["t_ns"],
                PipelineConfig(optimizer=OptimizerConfig(
                    schedule="reference")))
            a_ref = _aee_med(ref, d, sig)
            it_ref = int(ref["iters"].sum())
            for vname, kw in variants.items():
                t0 = time.time()
                out = compensate_recording_scan(
                    d["x"], d["y"], d["t_ns"],
                    PipelineConfig(optimizer=OptimizerConfig.fast(**kw)))
                a = _aee_med(out, d, sig)
                it = int(out["iters"].sum())
                n_sl = int(out["iters"].shape[0])
                row = dict(scene=scene, seed=seed, variant=vname,
                           aee=round(a, 5), aee_ref=round(a_ref, 5),
                           ratio=round(a / a_ref, 4) if a_ref > 0 else None,
                           iters=it, iters_ref=it_ref,
                           mean_iters=round(it / max(n_sl, 1), 3),
                           wall_s=round(time.time() - t0, 1))
                rows.append(row)
                print(json.dumps(row), flush=True)

    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)

    # Summary: per (scene, variant) worst + mean ratio, iter savings.
    print("\n=== summary (ratio vs reference schedule AEE) ===")
    keys = sorted({(r["scene"], r["variant"]) for r in rows})
    for scene, vname in keys:
        rs = [r for r in rows if r["scene"] == scene
              and r["variant"] == vname]
        ratios = [r["ratio"] for r in rs if r["ratio"] is not None]
        iters = [r["iters"] / r["iters_ref"] for r in rs]
        print(f"{scene:11s} {vname:9s} ratio mean={np.mean(ratios):.3f} "
              f"max={np.max(ratios):.3f} min={np.min(ratios):.3f}  "
              f"iterfrac mean={np.mean(iters):.3f}")


if __name__ == "__main__":
    main()
