"""Test configuration: a virtual 8-device CPU platform by default.

Multi-device sharding is validated on simulated devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8), mirroring SURVEY.md
§4's test strategy.  ``JAX_PLATFORMS`` picks another platform: the tests
marked ``gpu`` run on the card with ``JAX_PLATFORMS=cuda python -m pytest
tests/ -m gpu`` and skip everywhere else.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

# Float64 stays OFF: the framework is f32-native by design; tests that need
# f64 host math use numpy.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running integration tests")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped on other platforms")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run
    time, never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda)")
