"""Test configuration: force the CPU backend with 8 virtual devices.

Multi-chip sharding is validated on a virtual CPU mesh (the reference tests
its "multi-node" Flight paths with an in-process mock server the same way,
arrow-flight/tests/common/server.rs); GPU runs happen in chip_smoke.py
and bench.py, not under pytest.

Must run before jax initializes: the XLA_FLAGS host-device-count flag has
to be in place before the CPU client starts.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
assert jax.device_count() == 8, "expected 8 virtual CPU devices"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)

