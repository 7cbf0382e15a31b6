"""Distribution layer: device mesh + sharded EKF / Schur kernels.

The reference is single-process (SURVEY §2.5); this layer is the new
capability: landmark-sharded covariance updates and distributed
Schur-complement BA over `jax.sharding.Mesh` + `shard_map`, with XLA
collectives (psum/all_gather) between the devices of the mesh.
"""

from surikatoko_tpu.parallel.mesh import (
    landmark_mesh as landmark_mesh,
    device_count as device_count,
)
from surikatoko_tpu.parallel import sharded_ekf as sharded_ekf
