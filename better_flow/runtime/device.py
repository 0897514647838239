"""Process-level device settings shared by the entry points.

Two decisions live here so the CLI, ``bench.py`` and ``chip_smoke.py``
make them the same way:

* where JAX keeps its persistent compilation cache, and
* how many bytes of device memory the one-program slice scan may plan to
  keep resident before it routes a recording through the bounded-memory
  cold path (runtime.scan_pipeline.compensate_recording_scan).
"""

from __future__ import annotations

import os
import pathlib
from typing import Optional

import jax

# <checkout>/.jax_cache (listed in .gitignore).
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

# Share of the device's allocator limit the scan's own estimate may use;
# the rest is headroom for XLA temporaries and the accumulation outputs.
SCAN_BUDGET_FRACTION = 0.5


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and nothing else is changed; otherwise the cache lives in
    ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def scan_budget_bytes(device=None) -> Optional[float]:
    """Device bytes the one-program scan may plan to keep resident.

    ``BF_SCAN_DEVICE_BUDGET_GB`` overrides.  Otherwise the budget is
    SCAN_BUDGET_FRACTION of the device allocator's ``bytes_limit``; a
    device that reports no memory statistics (the CPU backend, whose
    "device memory" is host RAM) has no budget and returns None."""
    env = os.environ.get("BF_SCAN_DEVICE_BUDGET_GB")
    if env:
        return float(env) * 1e9
    device = device or jax.local_devices()[0]
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return SCAN_BUDGET_FRACTION * float(stats["bytes_limit"])
