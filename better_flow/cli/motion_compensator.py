"""bf_motion_compensator — the offline CLI, flag-compatible with the
reference binary (bf_motion_compensator.cpp:36-130) plus extras.

    python -m better_flow.cli.motion_compensator file.txt -o out.txt

Reference flags carried over: --refresh-time, --refresh-event-count,
-i/--interactive, --stm-disable, --img/--img-prefix, --video/--video-name/
--video-fps, --bufferize-file, --quiet, -o/--outfile, --version.  ``-G``
(OpenCL) is accepted for compatibility and means "the accelerator is already
in use" — the compute path is always the jit-compiled XLA program.
New flags: --scan (device-resident scan pipeline), --scale, --max-iter,
--max-events, --time-width, --resolution.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from better_flow import __version__
from better_flow.config import (
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
    from_sec,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bf_motion_compensator",
        description="DVS flow estimator (better flow, JAX)",
    )
    p.add_argument("file", nargs="?", help='event .txt file ("-" for stdin)')
    p.add_argument("--refresh-time", type=float, default=0.033,
                   help="recompute after this many seconds of new events")
    p.add_argument("--refresh-event-count", type=int, default=20000,
                   help="recompute after this many new events")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="interactive trackbar mode (requires a display)")
    p.add_argument("-G", action="store_true",
                   help="accepted for reference compatibility (no-op: the "
                        "accelerator path is always on)")
    p.add_argument("--stm-disable", action="store_true",
                   help="do not warm-start from the previous slice's model")
    p.add_argument("--img", action="store_true",
                   help="write a HUD frame after every slice")
    p.add_argument("--img-prefix", default="./")
    p.add_argument("--video", action="store_true")
    p.add_argument("--video-name", default="./out.mp4")
    p.add_argument("--video-fps", type=int, default=60)
    p.add_argument("--bufferize-file", action="store_true",
                   help="read whole file first; print per-slice perf")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("-o", "--outfile", default=None)
    p.add_argument("-v", "--version", action="store_true")
    # Extensions beyond the reference
    p.add_argument("--scan", action="store_true",
                   help="device-resident lax.scan pipeline (fastest offline)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="with --cold: persist (carry, completed batches) "
                        "at every batch boundary so a killed run can "
                        "--resume bit-identically")
    p.add_argument("--resume", action="store_true",
                   help="with --cold --checkpoint: continue after the "
                        "last completed batch of a matching checkpoint")
    p.add_argument("--cold", action="store_true",
                   help="one-shot batch-pipelined processing: staging of "
                        "the next slice batch overlaps device execution "
                        "(best wall-clock for a recording processed once)")
    p.add_argument("--schedule", default="reference",
                   choices=["reference", "fast", "fast_accurate",
                            "fast_throughput"],
                   help="optimizer step-size schedule: 'reference' is the "
                        "C++ parity divider schedule (default — bit-"
                        "faithful output); the fast presets trade "
                        "documented, gate-tested accuracy bands for "
                        "2.7-3.3x fewer iterations (OptimizerConfig "
                        "docstrings; fast_throughput is translation-"
                        "dominated streams only)")
    p.add_argument("--scale", type=int, default=3)
    p.add_argument("--max-iter", type=int, default=-1)
    p.add_argument("--max-events", type=int, default=50000,
                   help="slice capacity (reference EVENT_WIDTH)")
    p.add_argument("--time-width", type=float, default=0.2,
                   help="slice time span seconds (reference TIME_WIDTH)")
    p.add_argument("--resolution", default="180x240",
                   help="sensor rows x cols (reference RES_X x RES_Y)")
    return p


def config_from_args(args) -> PipelineConfig:
    rx, ry = (int(v) for v in args.resolution.lower().split("x"))
    return PipelineConfig(
        sensor=SensorConfig(res_x=rx, res_y=ry),
        slice=SliceConfig(
            max_events=args.max_events,
            span_ns=from_sec(args.time_width),
            refresh_events=args.refresh_event_count,
            refresh_time_ns=from_sec(args.refresh_time),
        ),
        optimizer={
            "reference": lambda **kw: OptimizerConfig(**kw),
            "fast": OptimizerConfig.fast,
            "fast_accurate": OptimizerConfig.fast_accurate,
            "fast_throughput": OptimizerConfig.fast_throughput,
        }[getattr(args, "schedule", "reference")](
            scale=args.scale, max_iter=args.max_iter),
        stm_disable=args.stm_disable,
        accumulate=args.outfile is not None,
        generate_pictures=args.img,
        img_prefix=args.img_prefix,
        generate_video=args.video,
        video_name=args.video_name,
        video_fps=args.video_fps,
        quiet=args.quiet,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"DVS flow estimator (better flow, JAX), {__version__}")
        return 0
    if args.file is None:
        build_parser().print_help()
        return 1

    from better_flow.io.event_file import read_events, write_events_uv
    from better_flow.runtime.device import enable_compile_cache

    enable_compile_cache()
    cfg = config_from_args(args)
    src = sys.stdin if args.file == "-" else args.file
    if not args.quiet:
        print(f"Reading from file... ({args.file})")
    rec = read_events(src)
    n = len(rec["x"])
    if not args.quiet:
        print(f"Read {n} events, finished")

    if args.interactive:
        # OptimizerRolling::manual trackbar mode on the first slice window
        # (optimizer_rolling.h:128-233); requires a display.
        try:
            from better_flow.cli.manual_mode import run_manual

            k = min(n, cfg.slice.max_events)
            run_manual(rec["x"][:k], rec["y"][:k],
                       rec["t_ns"][:k] - rec["t_ns"][0], cfg.sensor,
                       scale=cfg.optimizer.scale)
            return 0
        except Exception as e:  # pragma: no cover - needs a display
            print(f"interactive mode unavailable ({e}); continuing batch run",
                  file=sys.stderr)

    want_frames = args.img or args.video

    if (args.scan or args.cold) and not want_frames:
        if args.cold:
            from better_flow.runtime.scan_pipeline import (
                compensate_recording_cold,
            )

            out = compensate_recording_cold(
                rec["x"], rec["y"], rec["t_ns"], cfg,
                checkpoint_path=args.checkpoint, resume=args.resume)
            st = out["stats"]
            if not args.quiet:
                resumed = (f" (resumed after batch {st['resumed_batches']})"
                           if st.get("resumed_batches") else "")
                print(
                    f"{st['n_slices']} slices in {st['n_batches']} batches"
                    f"{resumed}, "
                    f"{st['total_s']:.3f} s end to end, "
                    f"{st['events_per_s']:.0f} events/s, "
                    f"mean iters {st['mean_iters']:.1f}"
                )
        else:
            from better_flow.runtime.scan_pipeline import (
                compensate_recording_scan,
            )

            out = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"],
                                            cfg)
            st = out["stats"]
            if not args.quiet:
                print(
                    f"{st['n_slices']} slices, {st['run_s']:.3f} s, "
                    f"{st['events_per_s']:.0f} events/s, mean iters {st['mean_iters']:.1f}"
                )
        if args.outfile:
            write_events_uv(
                sys.stdout if args.outfile == "-" else args.outfile,
                rec["x"], rec["y"], rec["t_ns"], out["u"], out["v"],
            )
        return 0

    from better_flow.runtime.dvs_flow import DVSFlow
    from better_flow.runtime.offline import compensate_recording

    if want_frames:
        cfg = cfg.replace(accumulate=True)
        engine = DVSFlow(cfg)
        sink = None
        if args.video:
            from better_flow.viz.video import VideoSink

            sink = VideoSink(args.video_name, args.video_fps,
                             cfg.sensor.res_x, cfg.sensor.res_y)
        frame_idx = [0]

        def on_slice(recrd):
            from better_flow.viz.video import hud_frame

            frame = hud_frame(
                recrd, engine.last_model, cfg.sensor.res_x, cfg.sensor.res_y,
                engine.time_diff, cfg.slice.refresh_time_ns,
                engine.get_buf_size(), recrd.n_events,
            )
            if args.img:
                import cv2

                cv2.imwrite(f"{args.img_prefix}/frame_{frame_idx[0]}.jpg", frame)
                frame_idx[0] += 1
            if sink is not None:
                sink.write(frame)

        engine.on_slice = on_slice
        engine.add_events(rec["x"], rec["y"], rec["t_ns"])
        if len(engine.buffer):
            engine.recompute()
        if sink is not None:
            sink.close()
        acc = engine.get_accumulated()
    else:
        out = compensate_recording(
            rec["x"], rec["y"], rec["t_ns"], cfg,
            verbose=args.bufferize_file and not args.quiet,
        )
        acc = out["accumulated"]

    if args.outfile:
        write_events_uv(
            sys.stdout if args.outfile == "-" else args.outfile,
            acc["x"], acc["y"], acc["timestamp"], acc["u"], acc["v"],
        )
        if not args.quiet:
            print(f"Written {len(acc['x'])} events, finished")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
