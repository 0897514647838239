"""Process-level device settings (runtime/device.py) and the absence of any
backend branch for a TPU."""

import pathlib
import re

import jax
import pytest

from better_flow.runtime import device

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = device.enable_compile_cache()
    assert got == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_keeps_the_variable(monkeypatch, tmp_path,
                                          restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing.
    assert jax.config.jax_compilation_cache_dir is None


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_scan_budget_from_device_limit(monkeypatch):
    monkeypatch.delenv("BF_SCAN_DEVICE_BUDGET_GB", raising=False)
    dev = _FakeDevice({"bytes_limit": 60e9, "bytes_in_use": 1e9})
    assert device.scan_budget_bytes(dev) == device.SCAN_BUDGET_FRACTION * 60e9


def test_scan_budget_variable_overrides(monkeypatch):
    monkeypatch.setenv("BF_SCAN_DEVICE_BUDGET_GB", "2.5")
    assert device.scan_budget_bytes(_FakeDevice({"bytes_limit": 60e9})) \
        == 2.5e9


@pytest.mark.parametrize("stats", [None, {}])
def test_scan_budget_none_without_device_stats(monkeypatch, stats):
    monkeypatch.delenv("BF_SCAN_DEVICE_BUDGET_GB", raising=False)
    assert device.scan_budget_bytes(_FakeDevice(stats)) is None


def test_cpu_backend_has_no_scan_budget(monkeypatch):
    monkeypatch.delenv("BF_SCAN_DEVICE_BUDGET_GB", raising=False)
    assert device.scan_budget_bytes() is None


# Written without quoting the words the test looks for, so that this file
# does not match itself.
_FORBIDDEN = re.compile(
    "|".join([r"pallas\.tpu", r"pallas import " + "tpu",
              r"""==\s*["']""" + "tpu" + r"""["']""",
              "force_" + "tpu_interpret_mode"]))


def test_no_tpu_branch():
    files = [ROOT / "bench.py", ROOT / "chip_smoke.py",
             ROOT / "__graft_entry__.py"]
    for d in ("better_flow", "tools", "tests"):
        files += sorted((ROOT / d).rglob("*.py"))
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if _FORBIDDEN.search(line)]
    assert not hits, "\n".join(hits)
