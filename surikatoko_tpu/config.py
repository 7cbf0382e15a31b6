"""Runtime configuration: scalar dtype policy and debug switches.

The reference selects ``Scalar`` = f32/f64 at CMake configure time
(suriko-engine/CMakeLists.txt:14, rt-config.h:42). The policy here is:

* library code is dtype-polymorphic — it follows its inputs;
* :func:`default_dtype` picks f64 when ``jax_enable_x64`` is on (CPU tests /
  parity checks vs the reference, which is f64 by default) and f32 otherwise
  (the benchmarks), with Joseph-form covariance updates + periodic
  symmetrization making the EKF f32-stable (see models/monoslam/update.py).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# Mirrors kSurikoDebug (rt-config.h:34): enables extra finite-diff cross-checks
# in tests; never read inside jitted code.
DEBUG_CHECKS: bool = bool(int(os.environ.get("SRKTPU_DEBUG_CHECKS", "0")))


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def default_dtype() -> jnp.dtype:
    """Scalar dtype for newly created state (f64 under x64, else f32)."""
    return jnp.float64 if x64_enabled() else jnp.float32
