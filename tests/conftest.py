"""Test configuration: force a virtual 8-device CPU mesh.

Multi-chip hardware is not required for tests — sharding paths are validated
on XLA's host-platform virtual devices, exactly as the reference's (absent)
multi-node story is replaced by mesh-sharded execution here.
"""

import os

# Tests run on the CPU backend with 8 virtual devices, whatever
# accelerator the machine has.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
