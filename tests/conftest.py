"""Test configuration: the suite runs on JAX's CPU backend with an
8-device virtual mesh, whatever accelerator the machine has; the GPU
path is exercised by ``python chip_smoke.py`` on a machine with a card.

The platform is forced both through the environment (read when jax is
first imported) and through the live config (for an interpreter that
imported jax before this file ran). In this JAX version virtual CPU
devices come from the ``jax_num_cpu_devices`` config (the old
--xla_force_host_platform_device_count XLA flag is ignored).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


def _configure_jax():
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    except Exception:
        pass  # backend already initialized or option missing


_configure_jax()


@pytest.fixture
def rng():
    return np.random.default_rng(42)
