"""Subprocess worker for tests/test_multihost.py: one process of a 2-process
jax.distributed CPU cluster (4 forced host devices each -> 8-device global
mesh). Runs one landmark-sharded fused EKF frame step over the GLOBAL mesh
and prints a RESULT line with checksums for cross-process / vs-single-device
comparison.

Invoked as: python multihost_worker.py <process_id> <coordinator_port>
"""

import json
import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from surikatoko_tpu.parallel import multihost  # noqa: E402

# before any backend-initializing call (the whole point of the wrapper)
multihost.initialize(coordinator_address=f"localhost:{port}",
                     num_processes=2, process_id=pid)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from surikatoko_tpu.geom import camera  # noqa: E402
from surikatoko_tpu.models.monoslam import make_params, measure  # noqa: E402
from surikatoko_tpu.parallel import landmark_mesh  # noqa: E402
from surikatoko_tpu.parallel.sharded_ekf import (  # noqa: E402
    make_sharded_fused_step)
from tests.test_parallel_ekf import K, rand_problem  # noqa: E402

rng = np.random.default_rng(7)
x, Pm = rand_problem(rng)
cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01))
params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                     process_noise_ang_veloc_std=0.01)
obs_mask = jnp.asarray(rng.uniform(size=K) < 0.8)
obs = (measure.project_all(params, x)
       + jnp.asarray(rng.normal(scale=1.0, size=(K, 2))))

mesh = landmark_mesh()          # spans BOTH processes' devices (8-way "lm")
rep = NamedSharding(mesh, P())
x, Pm, obs, obs_mask = (jax.device_put(a, rep)
                        for a in (x, Pm, obs, obs_mask))
step = make_sharded_fused_step(params, K, mesh)
x2, P2, _r2, _xm2 = step(x, Pm, obs, obs_mask)
# checksums come back as fully-replicated scalars (fetchable cross-process)
sx, spp = jax.jit(lambda a, b: (jnp.sum(a), jnp.sum(b * b)))(x2, P2)
print("RESULT " + json.dumps({
    "pid": pid,
    "info": multihost.local_slice_info(),
    "sum_x": float(sx),
    "sum_PP": float(spp),
}), flush=True)
