"""Test configuration.

The tests run on the CPU with 8 virtual devices, so that the sharded paths
run on a host mesh (SURVEY.md section 4).  Tests that need an NVIDIA GPU
take the ``gpu`` fixture: they skip elsewhere, and ``chip_smoke.py`` runs
them on the card inside its own process, where JAX already holds the GPU
backend and this file leaves the platform as it is."""
import os

import jax  # noqa: E402
from jax._src import xla_bridge  # noqa: E402

from alphatpu.runtime import setup_compile_cache  # noqa: E402

if not xla_bridge.backends_are_initialized():
    os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    setup_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs it on the card")
