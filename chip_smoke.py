#!/usr/bin/env python
"""On-card smoke test: the motion-compensation pipeline end to end on a GPU.

    python chip_smoke.py           # one card: phases 1-7 below
    python chip_smoke.py --four    # four cards: the two multi-device paths

Workload: the reference's production deployment — a DAVIS240 sensor
(180x240) at bf_motion_compensator's defaults (slices of <=50k events over
0.2 s, a retrigger every 20k events or 33 ms, scale 3; PipelineConfig()) —
fed bench.py's 1 Mev/s synthetic stream at 4M events (~200 slices), whose
ground-truth flow every phase can check.

Phases (one process, each prints its numbers on its own line):

1. device: a GPU backend, its ``nvidia-smi`` name and power limit, and the
   native staging library (io/native.py);
2. parity: one optimizer iteration on one full 50k-event slice against the
   plain reference (tests/naive_ref.py) at full width;
3. scan: compensate_recording_scan with the fast and the reference
   schedules — events/s, recovered flow vs ground truth, the first slices
   against the same program on the CPU backend, and whether two runs are
   bit-identical;
4. streaming: runtime.offline.compensate_recording vs the scan;
5. cold: the bounded-memory compensate_recording_cold vs the scan;
6. cli: the motion-compensator CLI in this process on a 1M-event file;
7. kernel: the finish kernel (ops/finish_kernel.py) against the plain XLA
   composition at 543x723 and 721x1281 — outputs and device time.

With ``--four``: the event-parallel scan on a 4-way 'ev' mesh against the
one-card scan, and the tiled pipeline on a 2x2 mesh at 720x1280, scale 1,
against the untiled one-card run.  Nothing else runs.

A failed check raises, so the script exits non-zero and prints no result
line.  The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))   # tests/naive_ref.py, the oracle

import naive_ref  # noqa: E402

from bench import bench_recording  # noqa: E402

REC_EVENTS = 4_000_000
CPU_SLICES = 20
STREAM_SLICES = 30
CLI_EVENTS = 1_000_000
COLD_BATCHES = 4
KERNEL_MEGAPIXEL_EVENTS = 200_000

# Two runs of the pipeline agree only to within these bounds where their
# sums run in different orders — XLA's GPU scatter-add uses atomics whose
# order varies between runs and programs, and the sharded and tiled paths
# reduce across devices — because the warm-start chain amplifies last-bit
# differences into different exits and iteration counts on later slices.
# Two identical GPU runs over the 200-slice stream measured iteration
# counts equal on 0.70-0.77 and within 1 on 0.92-0.97 of slices, and over
# the 20-30-slice windows of the CPU and streaming comparisons mean
# iterations up to 6% apart (NVIDIA H100 80GB HBM3, 400 W and 700 W), so
# iteration counts are bounded loosely — a broken schedule moves them by
# far more — and the flow itself by the per-event deviations.
RUN_TOL = {"uv_median": 0.01, "uv_p99": 0.10, "iters_within_1": 0.75,
           "mean_iters_rel": 0.15}
RUN_TOL_REASON = ("sums in another order (GPU atomics, cross-device "
                  "reductions); warm-start chains amplify last-bit "
                  "differences")
# Recovered flow vs the synthetic ground truth: the median end-point error
# over non-noise events, as a share of the mean ground-truth speed.
GT_AEE_FRAC = 0.25


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------- 1. device
def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device(require_gpu: bool = True) -> dict:
    """Platform, kind and count of the devices; fails off the GPU."""
    import jax

    from better_flow.io import native

    backend = jax.default_backend()
    check(not require_gpu or backend == "gpu",
          f"JAX found no GPU (default backend {backend!r})")
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log("device", f"platform {info['platform']}  kind {info['kind']}  "
                  f"count {info['count']}")
    if require_gpu:
        log("device", f"nvidia-smi name, power limit: "
                      f"{gpu_name_and_power_limit()}")
    check(native.get_lib() is not None,
          "native staging library (native/libbf_native.so) did not load")
    log("device", "native staging library loaded")
    return info


# ---------------------------------------------------------------- helpers
def compare_runs(phase, a, b, n, speed, tol=RUN_TOL, reason=RUN_TOL_REASON):
    """Per-event u/v and per-slice iteration counts of two runs over the
    first ``n`` events.  Noise flags must agree exactly: the only noise
    source, the window gate, is geometric and computed from host data."""
    check(np.array_equal(a["noise"][:n], b["noise"][:n]),
          f"{phase}: noise flags differ")
    ok = ~a["noise"][:n]
    du = np.abs(a["u"][:n][ok] - b["u"][:n][ok])
    dv = np.abs(a["v"][:n][ok] - b["v"][:n][ok])
    k = min(len(a["iters"]), len(b["iters"]))
    di = np.abs(np.asarray(a["iters"][:k]).astype(np.int64)
                - np.asarray(b["iters"][:k]).astype(np.int64))
    med = max(np.median(du), np.median(dv)) / speed
    p99 = max(np.percentile(du, 99), np.percentile(dv, 99)) / speed
    within1 = float(np.mean(di <= 1))
    it_a = float(np.mean(a["iters"][:k]))
    it_b = float(np.mean(b["iters"][:k]))
    it_rel = abs(it_a - it_b) / max(it_a, 1e-9)
    log(phase, f"{int(ok.sum())} events, {k} slices: median |du|,|dv| "
               f"{med:.3e}, p99 {p99:.3e} of mean speed {speed:.3f} px/s; "
               f"mean iterations {it_a:.4f} vs {it_b:.4f}; iterations equal "
               f"on {float(np.mean(di == 0)):.4f} and within 1 on "
               f"{within1:.4f} of slices (tolerance: median <= "
               f"{tol['uv_median']}, p99 <= {tol['uv_p99']}, mean "
               f"iterations within {tol['mean_iters_rel']:.0%}, within 1 on "
               f">= {tol['iters_within_1']}; {reason})")
    check(med <= tol["uv_median"], f"{phase}: median flow deviation {med}")
    check(p99 <= tol["uv_p99"], f"{phase}: p99 flow deviation {p99}")
    check(it_rel <= tol["mean_iters_rel"],
          f"{phase}: mean iterations {it_a} vs {it_b}")
    check(within1 >= tol["iters_within_1"],
          f"{phase}: iterations within 1 on only {within1} of slices")


def gt_speed(rec) -> float:
    return float(np.hypot(rec["u"], rec["v"]).mean())


def check_ground_truth(phase, out, rec):
    ok = ~out["noise"]
    check(ok.mean() > 0.5, f"{phase}: only {ok.mean():.3f} of events kept")
    aee = float(np.median(np.hypot(out["u"][ok] - rec["u"][ok],
                                   out["v"][ok] - rec["v"][ok])))
    speed = gt_speed(rec)
    log(phase, f"recovered flow: median end-point error {aee:.4f} px/s vs "
               f"mean ground-truth speed {speed:.3f} px/s ({aee / speed:.4f}; "
               f"tolerance {GT_AEE_FRAC}); median u {np.median(out['u'][ok]):.3f}"
               f" (truth {np.median(rec['u'][ok]):.3f}), median v "
               f"{np.median(out['v'][ok]):.3f} (truth "
               f"{np.median(rec['v'][ok]):.3f})")
    check(np.isfinite(out["u"]).all() and np.isfinite(out["v"]).all(),
          f"{phase}: non-finite flow")
    check(aee <= GT_AEE_FRAC * speed, f"{phase}: flow error {aee / speed}")


def prefix_events(plan, n_slices) -> int:
    """Events up to the trigger of slice ``n_slices``: a recording cut there
    has exactly the first ``n_slices`` slices of the full one."""
    k = min(n_slices, len(plan.ends))
    return int(plan.ends[k - 1]) + 1


# ---------------------------------------------------------------- 2. parity
def first_full_slice(rec, cfg):
    from better_flow.runtime.scan_pipeline import plan_slices

    plan = plan_slices(rec["t_ns"], cfg)
    lens = plan.ends - plan.starts + 1
    full = np.nonzero(lens == cfg.slice.max_events)[0]
    s = int(full[0]) if len(full) else int(np.argmax(lens))
    a, b = int(plan.starts[s]), int(plan.ends[s]) + 1
    t_local = rec["t_ns"][a:b] - plan.slice_start_ns[s]
    return (np.asarray(rec["x"][a:b], np.float32),
            np.asarray(rec["y"][a:b], np.float32), t_local.astype(np.int64))


def phase_parity(cfg, rec) -> dict:
    """One optimizer iteration on one full slice vs tests/naive_ref.py."""
    import jax
    import jax.numpy as jnp

    from better_flow.core.events import make_slice
    from better_flow.core.model import MotionModel
    from better_flow.models.global_flow import (
        GlobalFlowState,
        _iteration_step,
        slice_geometry,
        static_image_shape,
    )
    from better_flow.ops.gradient import masked_scharr
    from better_flow.ops.time_image import time_image

    opt, sensor = cfg.optimizer, cfg.sensor
    scale = opt.scale
    x, y, t = first_full_slice(rec, cfg)
    n = len(x)
    H, W = static_image_shape(scale, sensor)

    @jax.jit
    def one_iteration(ev):
        geom = slice_geometry(ev, scale, sensor, opt.min_window_fraction)
        img = time_image(ev.x, ev.y, ev.t, ev.active, scale, geom.x_shift,
                         geom.y_shift, geom.w_dyn, geom.h_dyn, H, W)
        gx, gy = masked_scharr(img)
        zero = jnp.zeros_like(ev.x)
        state = GlobalFlowState(
            pr_x=ev.x, pr_y=ev.y, nx=zero, ny=zero, model=MotionModel.zero(),
            x_div=jnp.float32(opt.init_xy_divider),
            y_div=jnp.float32(opt.init_xy_divider),
            rot_div=jnp.float32(opt.init_rotdiv_divider),
            div_div=jnp.float32(opt.init_rotdiv_divider),
            iters=jnp.int32(0))
        out = _iteration_step(state, ev, geom, scale, H, W)
        return img, gx, gy, out.model

    ev = make_slice(x, y, t.astype(np.float64), capacity=n)
    t0 = time.perf_counter()
    img, gx, gy, m = jax.device_get(one_iteration(ev))
    dev_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    nev = naive_ref.NaiveEvents(fr_x=x.astype(np.float64),
                                fr_y=y.astype(np.float64),
                                t=t.astype(np.float64),
                                noise=np.zeros(n, bool))
    nopt = naive_ref.NaiveOptimizerRolling(sensor.res_x, sensor.res_y)
    nopt.set_cloud(nev, scale)
    nopt.x_divider = nopt.y_divider = opt.init_xy_divider
    nopt.rot_divider = nopt.div_divider = opt.init_rotdiv_divider
    ref_img = nopt.iteration_step()
    ref_s = time.perf_counter() - t0
    nm = nopt.model

    h, w = ref_img.shape
    img_err = float(np.abs(img[:h, :w] - ref_img).max())
    rest = np.array(img)
    rest[:h, :w] = 0.0
    outside = float(np.abs(rest).max())
    # Scale of each model term's integrand over the counted pixels: the
    # rot/div integrands grow with the distance to the image centroid.
    mask = img > 1e-6
    rr, cc = np.nonzero(mask)
    dist = np.hypot(rr - rr.mean(), cc - cc.mean())
    gmag = np.hypot(gx[mask], gy[mask])
    mean_abs = {"dx": float(np.abs(gx[mask]).mean()),
                "dy": float(np.abs(gy[mask]).mean()),
                "rot": float((dist * gmag).mean()),
                "div": float((dist * gmag).mean())}
    log("parity", f"slice of {n} events, image {H}x{W} (window {h}x{w}); "
                  f"device {dev_s:.3f} s (compile included), "
                  f"naive reference {ref_s:.1f} s")
    log("parity", f"time image max |diff| {img_err:.3e} s (tolerance 2e-6 s: "
                  "float32 sums of event times in another order); "
                  f"max |value| outside the window {outside:.3e} (must be 0)")
    check(img_err <= 2e-6, f"parity: time image differs by {img_err}")
    check(outside == 0.0, "parity: nonzero pixels outside the window")
    cx_err = max(abs(float(m.cx) - nm.cx), abs(float(m.cy) - nm.cy))
    log("parity", f"centroid (event coords) ({float(m.cx):.4f}, "
                  f"{float(m.cy):.4f}) vs ({nm.cx:.4f}, {nm.cy:.4f}), "
                  f"max |diff| {cx_err:.2e} px (tolerance 1e-3 px: float32 "
                  "vs float64 means over the same pixels)")
    check(cx_err <= 1e-3, f"parity: centroid differs by {cx_err}")
    log("parity", f"counted pixels {int(m.cnt)} vs reference {nm.cnt} "
                  "(tolerance 2: a pixel whose mean time rounds across "
                  "the 1e-6 s threshold)")
    check(abs(int(m.cnt) - nm.cnt) <= 2,
          f"parity: pixel count {m.cnt} vs {nm.cnt}")
    for term in ("dx", "dy", "rot", "div"):
        a, b = float(getattr(m, term)), getattr(nm, term)
        tol = 1e-4 * mean_abs[term]
        log("parity", f"{term}: {a:.6e} vs reference {b:.6e}, |diff| "
                      f"{abs(a - b):.2e} (tolerance {tol:.2e} = 1e-4 of the "
                      "mean |integrand|: float32 reduction over "
                      f"{int(m.cnt)} pixels in another order)")
        check(abs(a - b) <= tol, f"parity: {term} {a} vs {b}")
    for term in ("total_dx", "total_dy", "total_rot", "total_div"):
        a, b = float(getattr(m, term)), getattr(nm, term)
        tol = 1e-4 * mean_abs[term[6:]] / (
            opt.init_xy_divider if term[6:] in ("dx", "dy")
            else opt.init_rotdiv_divider)
        check(abs(a - b) <= tol, f"parity: {term} {a} vs {b}")
    log("parity", "model totals after the update agree within the same "
                  "tolerances divided by the step dividers")
    return {"img_err": img_err, "cx_err": cx_err}


# ---------------------------------------------------------------- 3. scan
def phase_scan(name, cfg, rec, n_cpu_slices=CPU_SLICES) -> dict:
    """Warm-up and measured runs of the one-program scan, a repeat run for
    bit identity, ground truth, and the first slices on the CPU backend."""
    import jax

    from better_flow.runtime.scan_pipeline import (
        compensate_recording_scan,
        prepare_recording,
    )

    phase = f"scan {name}"
    x, y, t = rec["x"], rec["y"], rec["t_ns"]
    prepared = prepare_recording(x, y, t, cfg)
    warm = compensate_recording_scan(None, None, None, cfg,
                                     prepared=prepared)
    out = compensate_recording_scan(None, None, None, cfg, prepared=prepared)
    again = compensate_recording_scan(None, None, None, cfg,
                                      prepared=prepared)
    st = out["stats"]
    compile_s = warm["stats"]["run_s"] - st["run_s"]
    log(phase, f"events/s {st['events_per_s']:.1f}  run_s {st['run_s']:.4f}"
               f"  plan_s {st['plan_s']:.4f}  compile_s {compile_s:.3f}  "
               f"mean_iters {st['mean_iters']:.4f}  n_slices "
               f"{st['n_slices']}  repeat run_s {again['stats']['run_s']:.4f}")
    check_ground_truth(phase, out, rec)
    identical = all(np.array_equal(out[k], again[k])
                    for k in ("u", "v", "noise", "iters"))
    log(phase, f"two runs bit-identical: {identical}")
    compare_runs(f"{phase} repeat", out, again, len(x), gt_speed(rec))

    n_pre = prefix_events(out["plan"], n_cpu_slices)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = compensate_recording_scan(x[:n_pre], y[:n_pre], t[:n_pre], cfg)
    compare_runs(f"{phase} vs cpu", out, cpu, n_pre, gt_speed(rec))
    return out


# ---------------------------------------------------------------- 4. stream
def phase_streaming(cfg, rec, scan_out, n_slices=STREAM_SLICES):
    from better_flow.runtime.offline import compensate_recording

    plan = scan_out["plan"]
    n_pre = prefix_events(plan, n_slices)
    out = compensate_recording(rec["x"][:n_pre], rec["y"][:n_pre],
                               rec["t_ns"][:n_pre], cfg)
    # The streaming engine's final flush recomputes the last window once
    # more when the recording ends exactly on a trigger; first-slice-wins
    # never reads that repeat, so only the plan's slices are compared.
    k = min(n_slices, len(plan.ends))
    records = out["engine"].slices
    check(len(records) >= k, f"streaming: {len(records)} slices, want {k}")
    records = records[:k]
    u = np.zeros(n_pre, np.float32)
    v = np.zeros(n_pre, np.float32)
    noise = np.zeros(n_pre, bool)
    seen = np.zeros(n_pre, bool)
    for s, r in enumerate(records):
        idx = np.arange(plan.starts[s], plan.ends[s] + 1)
        fresh = ~seen[idx]
        u[idx[fresh]] = np.asarray(r.u)[fresh]
        v[idx[fresh]] = np.asarray(r.v)[fresh]
        noise[idx[fresh]] = np.asarray(r.noise)[fresh]
        seen[idx] = True
    st = out["stats"]
    log("streaming", f"{st['n_slices']} slices, events/s "
                     f"{st['events_per_s']:.1f} (compile included), mean "
                     f"slice wall {st['mean_slice_wall_s']:.4f} s")
    stream = {"u": u, "v": v, "noise": noise,
              "iters": np.array([r.iters for r in records])}
    compare_runs("streaming vs scan", scan_out, stream, n_pre,
                 gt_speed(rec))


# ---------------------------------------------------------------- 5. cold
def phase_cold(cfg, rec, scan_out, n_batch=COLD_BATCHES):
    from better_flow.runtime.scan_pipeline import compensate_recording_cold

    out = compensate_recording_cold(rec["x"], rec["y"], rec["t_ns"], cfg,
                                    n_batch=n_batch)
    st = out["stats"]
    check(st["n_batches"] >= 2, f"cold: {st['n_batches']} batches")
    log("cold", f"{st['n_batches']} batches, {st['n_slices']} slices, "
                f"events/s {st['events_per_s']:.1f} end to end (compile "
                f"included), mean_iters {st['mean_iters']:.4f}")
    compare_runs("cold vs scan", scan_out, out, len(rec["x"]), gt_speed(rec))


# ---------------------------------------------------------------- 6. cli
LINE_RE = re.compile(r"^\d+\.\d{9} \d+ \d+ 1 -?\d+\.\d{9} -?\d+\.\d{9}$")


def phase_cli(rec, n_events=CLI_EVENTS):
    """The CLI in this process: a second process would need the card a
    second time, and this one already holds most of its memory."""
    from better_flow.cli.motion_compensator import main
    from better_flow.io.event_file import read_events_uv, write_events

    n = min(n_events, len(rec["x"]))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "recording.txt")
        dst = os.path.join(tmp, "flow.txt")
        write_events(src, rec["x"][:n], rec["y"][:n], rec["t_ns"][:n])
        t0 = time.perf_counter()
        rc = main([src, "--scan", "-o", dst, "--quiet"])
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli: exit code {rc}")
        with open(dst) as f:
            first = f.readline().rstrip("\n")
            rows = 1 + sum(1 for _ in f)
        back = read_events_uv(dst)
    log("cli", f"{n} events in, {rows} rows out in {wall:.2f} s (compile "
               f"included); first row {first!r}")
    check(rows == n, f"cli: {rows} rows for {n} events")
    check(LINE_RE.match(first) is not None, f"cli: row format {first!r}")
    check(np.array_equal(back["x"], rec["x"][:n])
          and np.array_equal(back["y"], rec["y"][:n]),
          "cli: event coordinates do not round-trip")
    check(np.isfinite(back["u"]).all() and np.isfinite(back["v"]).all(),
          "cli: non-finite flow")


# ---------------------------------------------------------------- 7. kernel
def _device_time(fn, args, reps):
    """Seconds per call of ``fn(*args)`` on the device: ``reps`` calls
    chained through a data dependency inside one program, so neither
    dispatch nor loop-invariant hoisting enters the time.  Every output
    feeds the chain, so none of the work is dead code."""
    import jax
    from jax import lax

    @jax.jit
    def chain(*a):
        def body(_, c):
            out = fn(a[0] + 0.0 * c, *a[1:])
            return sum(jax.tree_util.tree_leaves(out))
        return lax.fori_loop(0, reps, body, jax.numpy.float32(0))

    jax.block_until_ready(chain(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(chain(*args))
    return (time.perf_counter() - t0) / reps


def phase_kernel(cases, reps=200):
    """The finish kernel against the plain XLA composition it replaces on
    the GPU (models.global_flow._model_terms_gpu vs _model_terms) at real
    widths: outputs compared, device time per call of each."""
    import functools

    import jax
    import jax.numpy as jnp

    from better_flow.core.events import make_slice
    from better_flow.models import global_flow as gf
    from better_flow.ops.gradient import masked_scharr
    from better_flow.ops.time_image import time_image

    for cfg, rec in cases:
        sensor, scale = cfg.sensor, cfg.optimizer.scale
        x, y, t = first_full_slice(rec, cfg)
        ev = make_slice(x, y, t.astype(np.float64), capacity=len(x))
        H, W = gf.static_image_shape(scale, sensor)
        geom = gf.slice_geometry(ev, scale, sensor)
        args = (ev.x, ev.y, ev.t, ev.active, geom.x_shift, geom.y_shift,
                geom.w_dyn, geom.h_dyn)
        static = dict(scale=scale, H=H, W=W, axis_name=None)
        plain = functools.partial(gf._model_terms, **static)
        kernel = functools.partial(gf._model_terms_gpu, **static)
        a = jax.device_get(jax.jit(plain)(*args))
        b = jax.device_get(jax.jit(kernel)(*args))
        img = time_image(*args[:4], scale, *args[4:], H, W)
        gx, gy = jax.device_get(masked_scharr(img))
        g = float(jnp.mean(jnp.abs(gx)) + jnp.mean(jnp.abs(gy)))
        cnt_ok = abs(float(a[2].cnt) - float(b[2].cnt)) <= 2
        c_err = max(abs(float(a[0]) - float(b[0])),
                    abs(float(a[1]) - float(b[1])))
        t_err = max(abs(float(getattr(a[2], k)) - float(getattr(b[2], k)))
                    / (abs(float(getattr(a[2], k))) + g * (H if k in
                       ("rot", "div") else 1.0))
                    for k in ("dx", "dy", "rot", "div"))
        t_plain = _device_time(plain, args, reps)
        t_kernel = _device_time(kernel, args, reps)
        log("kernel", f"{H}x{W} (scale {scale}, {len(x)} events): plain "
                      f"{t_plain * 1e6:.2f} us, kernel {t_kernel * 1e6:.2f} "
                      f"us per iteration's splat+finish; centroid |diff| "
                      f"{c_err:.2e} px (tolerance 1e-3), counted pixels "
                      f"{int(a[2].cnt)} vs {int(b[2].cnt)} (tolerance 2), "
                      f"terms max relative diff {t_err:.2e} (tolerance 1e-4: "
                      "float32 sums in another order, centroid applied "
                      "after the sums)")
        check(cnt_ok and c_err <= 1e-3 and t_err <= 1e-4,
              f"kernel: outputs differ at {H}x{W}")


# ---------------------------------------------------------------- --four
def phase_event_parallel(cfg, rec, n_dev=4):
    from better_flow.parallel.event_parallel import (
        compensate_recording_scan_sharded,
        prepare_recording_sharded,
    )
    from better_flow.parallel.mesh import make_event_mesh
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    x, y, t = rec["x"], rec["y"], rec["t_ns"]
    single = compensate_recording_scan(x, y, t, cfg)
    mesh = make_event_mesh(n_dev)
    prepared = prepare_recording_sharded(x, y, t, cfg, n_dev)
    compensate_recording_scan_sharded(x, y, t, cfg, mesh, prepared=prepared)
    out = compensate_recording_scan_sharded(x, y, t, cfg, mesh,
                                            prepared=prepared)
    st = out["stats"]
    log("event-parallel", f"{n_dev}-way 'ev' mesh: events/s "
                          f"{st['events_per_s']:.1f}  run_s "
                          f"{st['run_s']:.4f}  mean_iters "
                          f"{st['mean_iters']:.4f}  n_slices "
                          f"{st['n_slices']}")
    check_ground_truth("event-parallel", out, rec)
    compare_runs("event-parallel vs one card", single, out, len(x),
                 gt_speed(rec))


def tiled_workload(n_events):
    """720x1280 sensor at scale 1 (the low-latency megapixel regime) with
    locally dense structure, so that the all-nine Scharr mask sees real
    gradients at scale 1."""
    from better_flow.config import (
        OptimizerConfig,
        PipelineConfig,
        SensorConfig,
        SliceConfig,
    )
    from better_flow.io.synthetic import synthetic_events

    cfg = PipelineConfig(
        sensor=SensorConfig(720, 1280),
        slice=SliceConfig(max_events=60_000, span_ns=int(0.07e9),
                          refresh_events=25_000,
                          refresh_time_ns=int(0.03e9)),
        optimizer=OptimizerConfig(scale=1, max_iter=10, min_events=1000),
    )
    rec = synthetic_events(n_events, duration_s=n_events / 3e6, res_x=720,
                           res_y=1280, vx=120.0, vy=-80.0, rot=0.1,
                           div=0.03, n_points=600, jitter_px=1.5, seed=4)
    return cfg, rec


def phase_tiled(n_events, tiles=(2, 2)):
    import jax

    from better_flow.parallel.spatial import (
        AX_X,
        AX_Y,
        compensate_recording_tiled,
        prepare_recording_tiled,
    )
    from better_flow.runtime.scan_pipeline import compensate_recording_scan

    cfg, rec = tiled_workload(n_events)
    x, y, t = rec["x"], rec["y"], rec["t_ns"]
    ref = compensate_recording_scan(x, y, t, cfg)
    mesh = jax.make_mesh(tiles, (AX_X, AX_Y),
                         devices=jax.devices()[:tiles[0] * tiles[1]])
    prepared = prepare_recording_tiled(x, y, t, cfg, *tiles)
    compensate_recording_tiled(x, y, t, cfg, mesh, halo=32, esc_cap=32768,
                               prepared=prepared)
    out = compensate_recording_tiled(x, y, t, cfg, mesh, halo=32,
                                     esc_cap=32768, prepared=prepared)
    st = out["stats"]
    ok = ~ref["noise"]
    speed = float(np.hypot(ref["u"][ok], ref["v"][ok]).mean())
    log("tiled", f"{tiles[0]}x{tiles[1]} mesh, 720x1280 scale 1, {len(x)} "
                 f"events: run_s {st['run_s']:.4f}  mean_iters "
                 f"{st['mean_iters']:.4f}  n_slices {st['n_slices']}  "
                 f"escaped_dropped {st['escaped_dropped']}  untiled mean "
                 f"speed {speed:.3f} px/s")
    check(st["escaped_dropped"] == 0, "tiled: escape lane overflowed")
    check(speed > 20.0, f"tiled: vacuous flow ({speed} px/s)")
    compare_runs("tiled vs untiled one card", ref, out, len(x), speed)


# ---------------------------------------------------------------- main
def run_one_card(rec_events=REC_EVENTS, cli_events=CLI_EVENTS):
    from better_flow.config import OptimizerConfig, PipelineConfig

    rec = bench_recording(rec_events)
    cfg_fast = PipelineConfig(optimizer=OptimizerConfig.fast())
    cfg_ref = PipelineConfig()
    phase_parity(cfg_ref, rec)
    fast = phase_scan("fast", cfg_fast, rec)
    phase_scan("reference", cfg_ref, rec)
    phase_streaming(cfg_fast, rec, fast)
    phase_cold(cfg_fast, rec, fast)
    phase_cli(rec, cli_events)
    phase_kernel([(cfg_ref, rec), tiled_workload(KERNEL_MEGAPIXEL_EVENTS)])


def run_four(rec_events=REC_EVENTS, tiled_events=1_500_000):
    import jax

    from better_flow.config import OptimizerConfig, PipelineConfig

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, have "
                                   f"{len(jax.devices())}")
    rec = bench_recording(rec_events)
    phase_event_parallel(PipelineConfig(optimizer=OptimizerConfig.fast()),
                         rec)
    phase_tiled(tiled_events)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)

    from better_flow.runtime.device import enable_compile_cache

    t0 = time.perf_counter()
    info = phase_device()
    log("device", f"compile cache {enable_compile_cache()}")
    if args.four:
        run_four()
    else:
        run_one_card()
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
