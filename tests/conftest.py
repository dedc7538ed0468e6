"""Test harness config: by default everything runs on a virtual 8-device
CPU mesh, so sharding correctness is checked without accelerators.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU. Run them on a GPU machine
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skipped where JAX has none)")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip(f"needs a GPU; JAX has {jax.devices()[0].platform}")
    return devs[0]
