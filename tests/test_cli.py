"""CLI surfaces: motion compensator and viewer."""

import os
import subprocess
import sys

import numpy as np
import pytest

from better_flow.io.event_file import read_events_uv, write_events
from better_flow.io.synthetic import synthetic_events

ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)
    ),
)


def _run(args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m"] + args, env=ENV, capture_output=True,
        text=True, timeout=timeout,
    )


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    d = synthetic_events(15000, duration_s=0.3, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=2)
    p = str(tmp / "rec.txt")
    write_events(p, d["x"], d["y"], d["t_ns"], d["polarity"])
    return p


BASE = [
    "better_flow.cli.motion_compensator",
    "--resolution", "24x32", "--max-events", "4000", "--time-width", "0.1",
    "--refresh-event-count", "1500", "--refresh-time", "0.04",
]


def test_version():
    r = _run(["better_flow.cli.motion_compensator", "--version"])
    assert r.returncode == 0 and "better flow" in r.stdout


def test_no_file_prints_usage():
    r = _run(["better_flow.cli.motion_compensator"])
    assert r.returncode == 1
    assert "usage" in r.stdout.lower() or "usage" in r.stderr.lower()


def test_scan_pipeline_output(rec_file, tmp_path):
    out = str(tmp_path / "out.txt")
    r = _run(BASE + [rec_file, "--scan", "-o", out, "--quiet"])
    assert r.returncode == 0, r.stderr[-500:]
    flow = read_events_uv(out)
    assert len(flow["x"]) > 10000
    ok = np.hypot(flow["u"], flow["v"]) > 1
    assert abs(np.median(flow["u"][ok]) - 20.0) < 10.0


def test_streaming_matches_scan(rec_file, tmp_path):
    """The scan and streaming pipelines process identical inputs; their
    programs compile differently (standalone jit vs inside lax.scan), so
    f32 rounding amplified by the sign-sensitive divider schedule produces
    small per-event differences.  Assert statistical equivalence."""
    o1 = str(tmp_path / "o1.txt")
    o2 = str(tmp_path / "o2.txt")
    assert _run(BASE + [rec_file, "--scan", "-o", o1, "--quiet"]).returncode == 0
    assert _run(BASE + [rec_file, "-o", o2, "--quiet"]).returncode == 0
    f1, f2 = read_events_uv(o1), read_events_uv(o2)
    assert len(f1["x"]) == len(f2["x"])
    assert np.median(np.abs(f1["u"] - f2["u"])) < 0.5
    assert np.corrcoef(f1["u"], f2["u"])[0, 1] > 0.995
    assert abs(np.median(f1["u"]) - np.median(f2["u"])) < 0.5


def test_stm_disable_flag(rec_file, tmp_path):
    out = str(tmp_path / "o3.txt")
    r = _run(BASE + [rec_file, "--scan", "--stm-disable", "-o", out, "--quiet"])
    assert r.returncode == 0


def test_viewer_analysis(rec_file, tmp_path):
    prefix = str(tmp_path / "v")
    r = _run([
        "better_flow.cli.viewer", rec_file, "0.0", "0.25",
        "--out-prefix", prefix,
    ])
    assert r.returncode == 0, r.stderr[-500:]
    assert "flow:" in r.stdout
    assert os.path.exists(prefix + "_projected.png")
    assert os.path.exists(prefix + "_sobel.png")


def test_viewer_color_time(rec_file, tmp_path):
    """--color-time writes the HSV time-surface (bf_viewer.cpp:158-249):
    hue encodes slice-time phase, so a moving scene must produce multiple
    distinct hues and only on event-covered pixels."""
    prefix = str(tmp_path / "vc")
    r = _run([
        "better_flow.cli.viewer", rec_file, "0.0", "0.25",
        "--out-prefix", prefix, "--color-time",
    ])
    assert r.returncode == 0, r.stderr[-500:]
    import cv2

    img = cv2.imread(prefix + "_color_time.png")
    assert img is not None and img.ndim == 3
    covered = img.any(axis=2)
    assert covered.any() and not covered.all()
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    hues = np.unique(hsv[..., 0][covered])
    assert len(hues) > 8, f"expected a hue spread over time, got {hues}"


def test_viewer_empty_window(rec_file):
    r = _run(["better_flow.cli.viewer", rec_file, "9.0", "9.5"])
    assert r.returncode == 1


def test_cli_cold_pipeline(tmp_path):
    """--cold: one-shot batch-pipelined processing writes the same format."""
    from better_flow.cli.motion_compensator import main
    from better_flow.io.event_file import read_events_uv, write_events
    from better_flow.io.synthetic import synthetic_events

    d = synthetic_events(30_000, duration_s=0.3, res_x=48, res_y=64,
                         vx=20.0, vy=-12.0, n_points=150, seed=6)
    rec = str(tmp_path / "rec.txt")
    write_events(rec, d["x"], d["y"], d["t_ns"], d["polarity"])
    out = str(tmp_path / "cold.txt")
    rc = main([rec, "--cold", "--resolution", "48x64", "--quiet",
               "--max-events", "8000", "--refresh-event-count", "4000",
               "-o", out])
    assert rc == 0
    r = read_events_uv(out)
    assert len(r["u"]) == 30_000
    ok = np.isfinite(r["u"])
    assert np.median(r["u"][ok]) != 0.0


def test_cli_schedule_flag(tmp_path):
    """--schedule selects the optimizer preset: the fast preset must
    produce the same flow field as reference to the documented band in
    materially less optimizer work (stderr line carries mean iters)."""
    from better_flow.cli.motion_compensator import main
    from better_flow.io.event_file import read_events_uv, write_events
    from better_flow.io.synthetic import synthetic_events

    d = synthetic_events(30_000, duration_s=0.3, res_x=48, res_y=64,
                         vx=20.0, vy=-12.0, n_points=150, seed=6)
    rec = str(tmp_path / "rec.txt")
    write_events(rec, d["x"], d["y"], d["t_ns"], d["polarity"])
    outs = {}
    for sched in ("reference", "fast"):
        out = str(tmp_path / f"{sched}.txt")
        rc = main([rec, "--scan", "--schedule", sched,
                   "--resolution", "48x64", "--quiet",
                   "--max-events", "8000", "--refresh-event-count",
                   "4000", "-o", out])
        assert rc == 0
        outs[sched] = read_events_uv(out)
    ok = np.isfinite(outs["reference"]["u"]) & np.isfinite(outs["fast"]["u"])
    speed = float(np.hypot(outs["reference"]["u"][ok],
                           outs["reference"]["v"][ok]).mean())
    du = np.abs(outs["fast"]["u"][ok] - outs["reference"]["u"][ok])
    assert np.median(du) < 0.05 * speed, (np.median(du), speed)
