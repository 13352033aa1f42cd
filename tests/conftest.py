"""Test harness config: CPU backend with 8 virtual devices.

Sharding tests run on a simulated 8-device mesh
(xla_force_host_platform_device_count) — the standard way to validate
shard_map / GSPMD layouts without several accelerators (SURVEY §4).
The CPU backend is forced through jax.config after import as well, so
the suite never reaches for an accelerator.

Tests marked ``gpu`` need a CUDA card; the ``gpu_device`` fixture skips
them elsewhere (decided at run time, never at import). On the card,
``HR_TEST_GPU=1 python -m pytest -m gpu tests/`` leaves the platform to
JAX so they run there.
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env setup)

if os.environ.get("HR_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when none is present."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU (run chip_smoke.py on the card)")
    return devices[0]
