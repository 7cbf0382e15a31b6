"""Davison MonoSlam EKF in JAX.

Re-design of the reference ``DavisonMonoSlam`` (davison-mono-slam.{h,cpp}) as
pure functions over fixed-shape pytrees:

* state x[13 + 6*K], covariance P[D,D] with K fixed landmark *slots* and an
  active mask — landmark add/delete is slot assignment + mask flip, replacing
  the reference's conservativeResize (davison-mono-slam.cpp:2362,:696);
* all four update strategies (stacked / one-observation / one-component /
  1-point RANSAC) over the same batched measurement model;
* Jacobians by jax.jacfwd of the measurement/prediction models — the
  reference's debug-only finite-difference checks become permanent tests.
"""

from surikatoko_tpu.models.monoslam.state import (
    CAM_STATE_COMPS as CAM_STATE_COMPS,
    SAL_PNT_COMPS as SAL_PNT_COMPS,
    MonoSlamParams as MonoSlamParams,
    MonoSlamState as MonoSlamState,
    make_params as make_params,
    init_state as init_state,
)
from surikatoko_tpu.models.monoslam.filter import MonoSlamFilter as MonoSlamFilter
