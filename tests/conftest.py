"""Test harness: force an 8-device virtual CPU mesh before JAX initializes.

Multi-chip sharding logic is tested on fake CPU devices
(xla_force_host_platform_device_count), the TPU-native analog of fake backends
(SURVEY.md section 4).  Real-chip benchmarks live in bench.py, not here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # unit tests always run on the CPU mesh
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# A pytest plugin may have imported jax before this conftest ran; force the
# platform again through the config API (harmless if the env var already won).
try:
    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu", "tests must run on the CPU mesh"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def rng():
    return np.random.RandomState(0)
