"""Triangulation and P-matrix decomposition.

Equivalent of reference obs-geom.cpp:606-677 (``DecomposeProjMat``) and
:679-727 (``Triangulate3DPointByLeastSquares``). The triangulator here is
batched and masked: a fixed number of frame slots per point with a validity
mask, so thousands of tracks triangulate as one vmapped 3x3 normal-equation
solve — batched, no per-track dynamic shapes.

Projection convention for these P matrices (Kanatani's f0-scaled form, used by
the BA stack and the dino dataset):  [u, v, f0]^T ∝ P @ [X, 1]^T.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from surikatoko_tpu.geom.se3 import SE3


def triangulate_point_least_squares(
    proj_mats: jnp.ndarray,   # [F, 3, 4]
    xs2d: jnp.ndarray,        # [F, 2]
    f0: jnp.ndarray | float = 1.0,
    mask: jnp.ndarray | None = None,  # [F] bool; at least 2 true
) -> jnp.ndarray:
    """Inhomogeneous DLT: rows x*P3 - f0*P1 and y*P3 - f0*P2 (reference :689).

    Solves via 3x3 normal equations (masked rows contribute zero), which is
    jit-stable for any frame count and batches cleanly with vmap.
    """
    x = xs2d[..., 0:1]  # [F,1]
    y = xs2d[..., 1:2]
    P1, P2, P3 = proj_mats[..., 0, :], proj_mats[..., 1, :], proj_mats[..., 2, :]
    f0 = jnp.asarray(f0, dtype=proj_mats.dtype)
    rows = jnp.stack([x * P3 - f0 * P1, y * P3 - f0 * P2], axis=-2)  # [F,2,4]
    if mask is not None:
        rows = rows * mask[..., None, None].astype(rows.dtype)
    A = rows[..., :3].reshape(-1, 3)
    B = -rows[..., 3].reshape(-1)
    AtA = A.T @ A
    AtB = A.T @ B
    # tiny Tikhonov keeps the solve defined for degenerate/masked-out tracks
    eps = jnp.asarray(1e-12, dtype=AtA.dtype)
    return jnp.linalg.solve(AtA + eps * jnp.eye(3, dtype=AtA.dtype), AtB)


triangulate_points_batch = jax.vmap(
    triangulate_point_least_squares, in_axes=(None, 0, None, 0)
)
triangulate_points_batch.__doc__ = (
    "vmap over points: proj_mats [F,3,4], xs2d [N,F,2], f0, mask [N,F] -> [N,3]."
)


def decompose_proj_mat(P: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, SE3]:
    """P[3,4] -> (scale, K upper-triangular with K[2,2]=1, wfc SE3).

    Satisfies  P ≈ scale * K * R^T * [I | -t]  with R in SO(3) (so the SE3
    returned maps camera->world: columns of R are camera axes, t the center).
    Mirrors the Cholesky route of reference obs-geom.cpp:606-677.
    """
    Q = P[:, :3]
    q = P[:, 3]
    det = jnp.linalg.det(Q)
    sign = jnp.where(det < 0, -1.0, 1.0).astype(P.dtype)
    Q = Q * sign
    q = q * sign

    t = -jnp.linalg.solve(Q, q)

    QQt_inv = jnp.linalg.inv(Q @ Q.T)
    C = jnp.linalg.cholesky(QQt_inv).T  # upper triangular
    R = (C @ Q).T

    C_inv = jnp.linalg.inv(C)
    c_last = C_inv[2, 2]
    K = C_inv / c_last
    scale = sign * c_last
    return scale, K, SE3(R, t)
