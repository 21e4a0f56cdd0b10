"""Test harness: run everything on a virtual 8-device CPU mesh.

The reference app's only transferable test idea is the sokol dummy-backend
pattern (SURVEY.md §4) — run the full pipeline headlessly. Here that is native:
every stage is a pure array function, so the tests run on the CPU backend
(JAX_PLATFORMS=cpu unless set otherwise) with 8 virtual devices, which tests
sharding/jit without accelerator hardware. The tiled raster kernel runs in
Pallas interpret mode there.

Tests that need a GPU carry the `gpu` marker and take the `gpu` fixture,
which skips them when no GPU is present. On a GPU machine:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

# also holds when a pytest plugin imported jax before this file ran
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped (by the gpu fixture) without one")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev
