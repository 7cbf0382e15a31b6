"""Kanatani-style bundle adjustment in JAX.

Re-design of the reference ``BundleAdjustmentKanatani``
(bundle-adj-kanatani.{h,cpp}): f0-scaled reprojection error, per-frame
variables [fx fy u0 v0 Tx Ty Tz Wx Wy Wz] (direct camera pose, incremental
Rodrigues rotation), gauge fixed by scene normalization (R0=I, T0=0, |T1c|=1)
plus variable pinning, LM with multiplicative diagonal damping (x10 / /10),
and a Schur-complement reduced camera solve.

Where the reference hand-derives ~1400 lines of "pqr" first/second
derivatives (bundle-adj-kanatani.cpp:1140-1548), this stack uses one
autodiff'd residual and batched Gauss-Newton blocks (einsum over the dense
point-x-frame observation grid) — dense contractions by construction.
"""

from surikatoko_tpu.models.ba.problem import (
    BAProblem as BAProblem,
    make_problem as make_problem,
    reproj_error as reproj_error,
    seen_points_count as seen_points_count,
)
from surikatoko_tpu.models.ba.normalize import (
    normalize_scene as normalize_scene,
    revert_normalization as revert_normalization,
    check_world_is_normalized as check_world_is_normalized,
)
from surikatoko_tpu.models.ba.lm import (
    BundleAdjustment as BundleAdjustment,
    TermCriteria as TermCriteria,
)
from surikatoko_tpu.models.ba.lm import (
    SparseBundleAdjustment as SparseBundleAdjustment,
)
from surikatoko_tpu.models.ba import sparse as sparse
