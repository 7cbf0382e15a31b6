"""Scene normalization for BA gauge freedom.

Reference SceneNormalizer (bundle-adj-kanatani.cpp:123-333): re-express the
world in the first camera's frame and scale so the cam0->cam1 shift has a
unity component:
  scale = t1y / |T01[uc]|,  T01 = (cam0_from_cam1).T
  R_k' = R_k R_0^T;  T_k' = (T_k - R_k R_0^T T_0) * scale;  X' = (R_0 X + T_0) * scale
Pure functions returning (normalized problem, NormState); revert restores the
original gauge (up to the optimization's change of shape).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from surikatoko_tpu.models.ba.problem import BAProblem


class NormState(NamedTuple):
    R0: jnp.ndarray          # pre-normalization cam0_from_world rotation
    T0: jnp.ndarray
    world_scale: jnp.ndarray
    unity_comp_ind: int      # static


def normalize_scene(p: BAProblem, t1y: float = 1.0, unity_comp_ind: int = 1,
                    min_shift: float | None = None
                    ) -> tuple[BAProblem, NormState]:
    """``min_shift`` (optional) floors |T01[uc]| so a degenerate gauge
    (zero cam0-cam1 shift) yields a finite no-op-ish scale instead of inf —
    used by the fused device program, whose validity gate separately refuses
    the result (lm._run_device_loop); hosts should keep calling
    can_normalize."""
    R0, T0 = p.cfw_R[0], p.cfw_t[0]
    # cam0_from_cam1 translation: SE3AFromB(cfw0, cfw1).T = T0 - R0 R1^T T1
    R1, T1 = p.cfw_R[1], p.cfw_t[1]
    T01 = T0 - R0 @ (R1.T @ T1)
    shift_c = T01[unity_comp_ind]
    shift_abs = jnp.abs(shift_c)
    if min_shift is not None:
        shift_abs = jnp.maximum(shift_abs, jnp.asarray(
            min_shift, p.points.dtype))
    scale = jnp.asarray(t1y, p.points.dtype) / shift_abs

    Rk = p.cfw_R
    Tk = p.cfw_t
    R_new = jnp.einsum("fij,kj->fik", Rk, R0)           # R_k R_0^T
    T_new = (Tk - jnp.einsum("fij,j->fi", R_new, T0)) * scale
    X_new = (p.points @ R0.T + T0) * scale
    p_new = p._replace(points=X_new, cfw_R=R_new, cfw_t=T_new)
    return p_new, NormState(R0=R0, T0=T0, world_scale=scale,
                            unity_comp_ind=unity_comp_ind)


@jax.jit
def _t01(cfw_R, cfw_t):
    R0, T0 = cfw_R[0], cfw_t[0]
    R1, T1 = cfw_R[1], cfw_t[1]
    return T0 - R0 @ (R1.T @ T1)


def can_normalize(p: BAProblem, unity_comp_ind: int = 1, atol: float = 1e-5) -> bool:
    # one jitted dispatch + one 3-vector fetch instead of ~7 eager
    # dispatches
    import numpy as np
    T01 = np.asarray(_t01(p.cfw_R, p.cfw_t))
    return bool(abs(T01[unity_comp_ind]) > atol)


def revert_normalization(p: BAProblem, ns: NormState) -> BAProblem:
    scale = ns.world_scale
    Rk1 = p.cfw_R
    Tk1 = p.cfw_t
    R_new = jnp.einsum("fij,jk->fik", Rk1, ns.R0)
    T_new = Tk1 / scale + jnp.einsum("fij,j->fi", Rk1, ns.T0)
    X_new = (p.points / scale - ns.T0) @ ns.R0
    return p._replace(points=X_new, cfw_R=R_new, cfw_t=T_new)


def check_world_is_normalized(p: BAProblem, t1y: float = 1.0,
                              unity_comp_ind: int = 1, atol: float = 1e-3) -> bool:
    """Reference CheckWorldIsNormalized (bundle-adj-kanatani.cpp:288)."""
    eye_ok = bool(jnp.all(jnp.abs(p.cfw_R[0] - jnp.eye(3, dtype=p.cfw_R.dtype)) < atol))
    t0_ok = bool(jnp.linalg.norm(p.cfw_t[0]) < atol)
    # direct pose of frame1: t1_direct = -R1^T T1
    t1_direct = -p.cfw_R[1].T @ p.cfw_t[1]
    t1_ok = bool(jnp.abs(jnp.abs(t1_direct[unity_comp_ind]) - t1y) < atol)
    return eye_ok and t0_ok and t1_ok
