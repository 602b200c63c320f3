"""Test configuration: an 8-device virtual CPU platform by default.

Tests run without accelerator hardware and exercise multi-device sharding
on 8 virtual CPU devices (the documented JAX pattern for testing
``jax.sharding`` code). With ``JAX_PLATFORMS=cuda`` the tests run on the
card instead, which is how the tests marked ``gpu`` are run:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8, "tests require the 8-device virtual CPU mesh"


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU. Decided here, when the test
    runs, never at import: every xdist worker must collect the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py covers this on the card)")
