"""Multi-host initialization + deployment notes for GPU hosts.

The reference is single-process; this module is the thin entry point for
running the sharded EKF/Schur stack across hosts. There is no custom
transport: `jax.distributed.initialize` brings up the JAX runtime, the
mesh spans all processes' devices, and XLA lowers psum/all_gather onto NCCL
(NVLink within a host, the cluster network between hosts; SURVEY §5.8).

Deployment recipe (2 hosts x 4 GPUs, one process per host):
  # on every host, with its own process_id (0 and 1) and the same
  # coordinator address, before anything touches a device:
  from surikatoko_tpu.parallel import multihost
  multihost.initialize(coordinator_address="host0:1234",
                       num_processes=2, process_id=<0|1>)
  # then build the mesh over the global device list:
  mesh = landmark_mesh()            # 8-way 'lm' axis
  update = make_sharded_stacked_update(params, capacity, mesh)
  # inputs must be globally-sharded jax.Arrays: use
  # jax.make_array_from_process_local_data / device_put with NamedSharding.

On a single host with several GPUs no initialization is needed: one process
sees every card, and landmark_mesh() spans them.

Sharding guidance (scaling-book recipe): the EKF all_gather of the gain
precursor A [2K, D] and the Schur psum of the reduced system are the only
cross-device transfers per step — both bandwidth-light relative to the local
O(D^2 K / n) compute. How far that scales on NVLink is not measured yet.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize. On GPU hosts pass the coordinator
    address, process count and process id explicitly, unless the cluster
    environment is one JAX detects by itself (e.g. SLURM).

    Must run before anything initializes the XLA backend — the guard is
    jax.distributed.is_initialized(), NOT jax.process_count() (which itself
    initializes the backend and would wedge a real cluster bring-up)."""
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def is_multihost() -> bool:
    return jax.process_count() > 1


def local_slice_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
