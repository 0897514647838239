"""chip_smoke.py's phases at small size on the CPU backend.

The script itself refuses to run without a GPU; here each phase function is
called directly (the device check bypassed only by the test), on a 300k-event
stream at the production sensor and slice geometry instead of 4M events.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from better_flow.config import OptimizerConfig, PipelineConfig  # noqa: E402


@pytest.fixture(scope="module")
def fast_run():
    rec = cs.bench_recording(300_000)
    cfg = PipelineConfig(optimizer=OptimizerConfig.fast())
    out = cs.phase_scan("fast", cfg, rec, n_cpu_slices=3)
    return cfg, rec, out


def test_phase_device_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.phase_device()


def test_phase_device_reports_devices():
    info = cs.phase_device(require_gpu=False)
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_phase_parity_full_width():
    rec = cs.bench_recording(120_000)
    got = cs.phase_parity(PipelineConfig(), rec)
    assert got["img_err"] <= 2e-6 and got["cx_err"] <= 1e-3


def test_phase_scan(fast_run):
    _, rec, out = fast_run
    st = out["stats"]
    assert st["n_events"] == len(rec["x"])
    assert st["n_slices"] == 15
    assert 1.0 <= st["mean_iters"] < 20.0


def test_phase_streaming(fast_run):
    cfg, rec, out = fast_run
    cs.phase_streaming(cfg, rec, out, n_slices=5)


def test_phase_cold(fast_run):
    cfg, rec, out = fast_run
    cs.phase_cold(cfg, rec, out)


def test_phase_cli(fast_run):
    _, rec, _ = fast_run
    cs.phase_cli(rec, 50_000)


def test_compare_runs_rejects_divergence(fast_run):
    _, rec, out = fast_run
    speed = cs.gt_speed(rec)
    off = dict(out, u=out["u"] + np.float32(0.05 * speed))
    with pytest.raises(cs.SmokeFailure, match="median flow deviation"):
        cs.compare_runs("test", out, off, len(rec["x"]), speed)
    iters = np.asarray(out["iters"]) + 2
    with pytest.raises(cs.SmokeFailure, match="mean iterations"):
        cs.compare_runs("test", out, dict(out, iters=iters), len(rec["x"]),
                        speed)
    # Same mean, but a third of the slices off by 3 either way.
    swing = np.zeros_like(iters)
    swing[0:6:2], swing[1:6:2] = 3, -3
    with pytest.raises(cs.SmokeFailure, match="iterations within 1"):
        cs.compare_runs("test", out,
                        dict(out, iters=np.asarray(out["iters"]) + swing),
                        len(rec["x"]), speed)


def test_ground_truth_check_rejects_wrong_flow(fast_run):
    _, rec, out = fast_run
    with pytest.raises(cs.SmokeFailure, match="flow error"):
        cs.check_ground_truth("test", dict(out, u=-out["u"]), rec)


@pytest.mark.parametrize("path", ["event_parallel", "tiled"])
def test_four_device_paths(path):
    """The --four phases on four of the virtual CPU devices."""
    assert len(jax.devices()) >= 4
    if path == "event_parallel":
        cs.phase_event_parallel(
            PipelineConfig(optimizer=OptimizerConfig.fast()),
            cs.bench_recording(300_000))
    else:
        cs.phase_tiled(150_000)


def _run_script(cwd, env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=240)


def _prints_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except (json.JSONDecodeError, AttributeError):
        return False


def test_script_fails_without_gpu():
    r = _run_script(ROOT, {})
    assert r.returncode != 0
    assert not _prints_result(r.stdout)
    assert "no GPU" in r.stderr


def test_script_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path, {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert not _prints_result(r.stdout)


def test_phase_kernel(monkeypatch):
    """The kernel phase at both widths, with the kernel in the Pallas
    interpreter (the CPU cannot compile it) and a short timing chain."""
    import functools

    from better_flow.ops import finish_kernel

    monkeypatch.setattr(finish_kernel, "finish_partials", functools.partial(
        finish_kernel.finish_partials, interpret=True))
    cs.phase_kernel([(PipelineConfig(), cs.bench_recording(60_000)),
                     cs.tiled_workload(61_000)], reps=1)
