"""BA problem container + f0-scaled reprojection error.

Data layout is a dense (points x frames) observation grid with a mask —
shape-stable, vmap-friendly, and the natural layout for the Schur
reduction einsums. (The reference iterates CornerTrack linked structures;
dino density is ~16%; the track-major sparse store in sparse.py serves the
large sparse problems.)

Error convention (reference ReprojErrorWithOverlap, bundle-adj-kanatani.cpp
:410-490): with K already f0-scaled (rows 0,1 divided by f0 — see the dino
demo, demo-bundle-adj-dinosaur.cpp:135-160), for observation (i,j):
    x_h = K_j (R_j X_i + T_j);   err += |x_h[:2]/x_h[2] - pix_ij/f0|^2
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from surikatoko_tpu.geom.se3 import SE3


class BAProblem(NamedTuple):
    points: jnp.ndarray      # [Np, 3] world points
    cfw_R: jnp.ndarray       # [F, 3, 3] camera-from-world rotations
    cfw_t: jnp.ndarray       # [F, 3]
    K: jnp.ndarray           # [F, 3, 3] f0-scaled intrinsics
    obs: jnp.ndarray         # [Np, F, 2] observed pixels (raw, unscaled)
    obs_mask: jnp.ndarray    # [Np, F] bool
    f0: jnp.ndarray          # scalar

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_frames(self) -> int:
        return self.cfw_R.shape[0]


def make_problem(points, cfw: SE3, K, obs, obs_mask, f0=1.0) -> BAProblem:
    dtype = jnp.result_type(jnp.asarray(points).dtype)
    K = jnp.asarray(K, dtype)
    if K.ndim == 2:
        K = jnp.broadcast_to(K, (cfw.R.shape[0], 3, 3))
    return BAProblem(
        points=jnp.asarray(points, dtype),
        cfw_R=jnp.asarray(cfw.R, dtype),
        cfw_t=jnp.asarray(cfw.t, dtype),
        K=K,
        obs=jnp.asarray(obs, dtype),
        obs_mask=jnp.asarray(obs_mask, bool),
        f0=jnp.asarray(f0, dtype),
    )


def project_f0(K: jnp.ndarray, cfw_R: jnp.ndarray, cfw_t: jnp.ndarray,
               X: jnp.ndarray) -> jnp.ndarray:
    """Project world point(s) to f0-units image coords: x_h[:2]/x_h[2]."""
    x_cam = jnp.einsum("...ij,...j->...i", cfw_R, X) + cfw_t
    x_h = jnp.einsum("...ij,...j->...i", K, x_cam)
    return x_h[..., :2] / x_h[..., 2:3]


def residuals(p: BAProblem) -> jnp.ndarray:
    """Masked residual grid [Np, F, 2] in f0 units."""
    proj = project_f0(p.K[None, :], p.cfw_R[None, :], p.cfw_t[None, :],
                      p.points[:, None, :])
    r = proj - p.obs / p.f0
    return r * p.obs_mask[..., None].astype(r.dtype)


def reproj_error(p: BAProblem) -> jnp.ndarray:
    """Scalar f0-scaled squared reprojection error (reference ReprojError)."""
    r = residuals(p)
    return jnp.sum(r * r)


def seen_points_count(p: BAProblem) -> jnp.ndarray:
    return jnp.sum(p.obs_mask.astype(jnp.int32))


def reproj_error_pix_per_point(p: BAProblem, err=None) -> jnp.ndarray:
    """Error expressed as pixels per seen point (reference
    ReprojErrorPixPerPoint): sqrt(err / count) * f0."""
    if err is None:
        err = reproj_error(p)
    n = jnp.maximum(seen_points_count(p), 1)
    return jnp.sqrt(err / n) * p.f0
