"""Test configuration: CPU backend with a virtual 8-device mesh, f64 enabled.

The reference engine is f64 by default (rt-config.h:42); x64 gives numerical
parity. Multi-chip sharding tests run on 8 virtual CPU devices via
--xla_force_host_platform_device_count. Both must be set before jax
initializes.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_prev = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _prev:
    os.environ["XLA_FLAGS"] = (_prev + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(20260817)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
