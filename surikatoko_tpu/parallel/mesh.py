"""Mesh construction helpers.

One logical axis family covers the engine's scaling dimensions:
  "lm"  — landmark/point blocks (EKF covariance rows, BA landmark blocks)
The mesh is flat and 1-D: on one host the GPUs are joined all to all by
NVLink, so no torus-shaped layout is needed. Multi-host: build the mesh over
all processes' devices (jax.distributed.initialize is the caller's
responsibility, see parallel/multihost.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def device_count() -> int:
    return len(jax.devices())


def landmark_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the landmark axis."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), axis_names=("lm",))
