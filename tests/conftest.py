"""Test configuration: the CPU backend with 8 virtual devices.

The analog of the reference's multi-platform CI matrix (SURVEY.md section
4): the same suite runs on the CPU lowering everywhere, with an 8-device
virtual mesh standing in for several cards so the shard_map/collective
paths are executed, not just traced. Tests marked ``gpu`` need a card and
skip elsewhere (the ``gpu_only`` fixture); ``pytest -m gpu`` on a GPU
machine leaves the default backend alone so they run there.
"""

import os

import jax
import numpy as np
import pytest


def pytest_configure(config):
    if (config.option.markexpr or "").strip() != "gpu":
        # Before any backend is initialized (test modules import later).
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # float64 references in tests


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


@pytest.fixture
def gpu_only():
    """Skip (inside the test, never at collection) unless JAX has a GPU."""
    if not any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")
